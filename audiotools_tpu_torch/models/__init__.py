"""The DAC codec: its generator, the MPD + MRD discriminators, the
reconstruction and adversarial training steps, the weight converter from
the JAX package's parameter trees, and its serving path (compressed
artifacts, streaming encode and decode)."""
from . import adversarial
from . import artifacts
from . import convert
from . import dac
from . import discriminators
from . import streaming
from . import train
from .artifacts import compress, decompress, load_artifact, save_artifact
from .dac import DAC
from .discriminators import Discriminator
from .streaming import (
    StreamingDecoder,
    StreamingEncoder,
    stream_decode,
    stream_encode,
)
