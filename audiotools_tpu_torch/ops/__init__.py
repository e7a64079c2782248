"""Functions on tensors: the DSP substrate of the augmentation path, and
the Hopper kernels under it (``hopper_kernels``)."""
from . import fft
from . import filters
from . import hopper_kernels
from . import loudness
from . import resample
from . import stretch
