"""Neural-network building blocks. Counterpart of ``audiotools_tpu/ml``;
so far its model base class (``BaseModel``: save and load) and its spectral
gate (``layers.SpectralGate``)."""
from . import layers
from .layers import BaseModel
