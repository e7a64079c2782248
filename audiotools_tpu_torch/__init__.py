"""audiotools_tpu_torch: the augmentation path, the codec training path
(``models``, ``metrics``) and the host I/O and codec layer (``io``,
``native``) of ``audiotools_tpu`` in PyTorch, for one NVIDIA Hopper card
(H100).

The JAX package beside it is the reference. This package imports neither
it nor JAX. Its five kernels (the causal FIRs, the fused phasor phase
vocoder, the rotation scan and the fused bf16 synthesis) are CUDA C++
under ``csrc/``, built with ``nvcc`` at first use (``_build``) and wrapped
in ``ops.hopper_kernels`` beside their plain PyTorch versions. The WAV,
FLAC and libav readers under ``native/`` are C++ built with ``g++`` at
first use the same way. Signals and loaders compute on the card unless
they are given ``device="cpu"``.
"""
__version__ = "0.1.0"

from .core import AudioSignal
from .core import Meter
from .core import util
from . import ops
from . import io
from . import data
