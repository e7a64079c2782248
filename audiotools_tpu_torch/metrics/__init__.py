"""Losses over signals and tensors: waveform distances and spectral
losses (counterpart of ``audiotools_tpu/metrics/distance.py`` and
``spectral.py``)."""
from . import distance
from . import spectral
