"""Losses and quality measures over signals and tensors: waveform distances,
spectral losses and STOI, PESQ and ViSQOL (counterpart of
``audiotools_tpu/metrics``)."""
from . import distance
from . import quality
from . import spectral
