"""Phase-vocoder time stretching and pitch shifting on tensors.

Counterpart of ``audiotools_tpu/ops/stretch.py``: STFT -> phasor phase
vocoder (kernel B, ``hopper_kernels.phase_vocoder_fused``) -> iSTFT, and a
polyphase resample for the pitch shift. Only the ``"phasor_fused"``
evaluation is ported, so it is the default here.
"""
from fractions import Fraction

import numpy as np
import torch.nn.functional as F

from . import fft as _fft
from . import hopper_kernels
from . import resample as _resample

__all__ = ["phase_vocoder", "time_stretch", "pitch_shift"]


def _pv_indices(T: int, rate: float):
    """Step tables: frames ``i0``/``i1`` around input position ``s *
    rate`` and the interpolation weight ``frac`` of each output step."""
    n_steps = int(np.ceil(T / rate))
    steps = np.arange(n_steps) * rate
    i0 = np.minimum(np.floor(steps).astype(np.int32), T - 1)
    i1 = np.minimum(i0 + 1, T - 1)
    frac = (steps - i0).astype(np.float32)
    return i0, i1, frac


def phase_vocoder(stft_data, rate: float, hop_length: int, window_length: int,
                  formulation: str = "phasor_fused"):
    """Stretch ``(..., F, T)`` complex STFT frames by ``rate`` (``rate > 1``
    gives fewer frames): interpolated magnitudes times a unit phasor
    advanced by each step's normalized cross-spectrum."""
    if formulation != "phasor_fused":
        raise NotImplementedError(
            f"phase vocoder formulation {formulation!r} is not ported yet "
            "(ROADMAP.md, Queue 1: ops/stretch.py); use 'phasor_fused'"
        )
    i0, i1, frac = _pv_indices(stft_data.shape[-1], rate)
    return hopper_kernels.phase_vocoder_fused(stft_data, i0, i1, frac)


def time_stretch(audio, factor: float, window_length: int = 2048, hop_length: int = None,
                 method: str = "matmul", synthesis_method: str = None,
                 pv_formulation: str = "phasor_fused"):
    """Stretch ``(..., T)`` audio by ``factor`` (> 1 is faster) to
    ``round(T / factor)`` samples. ``method`` selects the analysis STFT,
    ``synthesis_method`` (default: ``method``) the iSTFT."""
    if hop_length is None:
        hop_length = window_length // 4
    if synthesis_method is None:
        synthesis_method = method
    out_len = int(round(audio.shape[-1] / factor))
    spec = _fft.stft(audio, window_length, hop_length, "hann", method=method)
    stretched = phase_vocoder(spec, factor, hop_length, window_length,
                              formulation=pv_formulation)
    return _fft.istft(stretched, window_length, hop_length, "hann", length=out_len,
                      method=synthesis_method)


def pitch_shift(audio, n_semitones: float, sample_rate: int, window_length: int = 2048,
                hop_length: int = None, method: str = "matmul",
                synthesis_method: str = None, pv_formulation: str = "phasor_fused"):
    """Shift pitch by ``n_semitones`` keeping the duration: a time stretch
    by ``2 ** (-n / 12)`` and a resample by the same ratio, with the stretch
    on whichever side of the resample has fewer samples."""
    T = audio.shape[-1]
    rate = 2.0 ** (-float(n_semitones) / 12.0)
    # smallest denominator keeping the pitch-ratio error under 2e-5
    for cap in (60, 125, 250, 500, 1000, 5000):
        frac = Fraction(rate).limit_denominator(cap)
        if abs(float(frac) - rate) / rate < 2e-5:
            break
    old_sr, new_sr = frac.denominator, frac.numerator
    stretch = dict(window_length=window_length, hop_length=hop_length, method=method,
                   synthesis_method=synthesis_method, pv_formulation=pv_formulation)
    if rate < 1.0:
        out = time_stretch(_resample.resample(audio, old_sr, new_sr), rate, **stretch)
    else:
        out = _resample.resample(time_stretch(audio, rate, **stretch), old_sr, new_sr)
    if out.shape[-1] < T:
        out = F.pad(out, (0, T - out.shape[-1]))
    return out[..., :T]
