"""Neural-network building blocks. Counterpart of ``audiotools_tpu/ml``;
so far its spectral gate (``layers.SpectralGate``)."""
from . import layers
