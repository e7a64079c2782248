from .base import BaseModel
from .spectral_gate import SpectralGate
