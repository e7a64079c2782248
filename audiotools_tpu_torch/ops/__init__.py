"""Functions on tensors: the DSP substrate of the augmentation path, the
batched quality measures (``stoi``, ``pesq``, ``nsim``), and the Hopper
kernels under the augmentation path (``hopper_kernels``)."""
from . import fft
from . import filters
from . import hopper_kernels
from . import loudness
from . import nsim
from . import pesq
from . import resample
from . import stoi
from . import stretch
