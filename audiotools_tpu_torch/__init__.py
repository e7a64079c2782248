"""audiotools_tpu_torch: the augmentation path of ``audiotools_tpu`` in
PyTorch, for one NVIDIA Hopper card (H100).

The JAX package beside it is the reference. This package imports neither
it nor JAX. Its two kernels, the per-item causal FIR and the fused phasor
phase vocoder, are CUDA C++ under ``csrc/``, built with ``nvcc`` at first
use (``_build``) and wrapped in ``ops.hopper_kernels`` beside their plain
PyTorch versions.
"""
__version__ = "0.1.0"

from .core import AudioSignal
from .core import Meter
from .core import util
from . import ops
from . import io
from . import data
