"""The training harness and neural-network building blocks. Counterpart of
``audiotools_tpu/ml``: the ``Accelerator`` (one card, or one card a process
under ``torch.distributed``), the ``Checkpointer``, the ``Tracker`` and its
decorators, ``Experiment`` run directories, ``profiling`` and the model base
class (``BaseModel``: save and load), with the spectral gate
(``layers.SpectralGate``)."""
from . import decorators
from . import layers
from . import profiling
from .accelerator import Accelerator
from .checkpoint import Checkpointer
from .experiment import Experiment
from .layers import BaseModel
