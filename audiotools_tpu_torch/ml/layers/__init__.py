from .spectral_gate import SpectralGate
