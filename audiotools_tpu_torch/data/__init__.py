from . import datasets
from . import preprocess
from . import transforms
from .loader import DataLoader
from .. import _hostprof as hostprof
