from . import util
from .loudness import Meter
from .signal import AudioSignal, STFTParams
