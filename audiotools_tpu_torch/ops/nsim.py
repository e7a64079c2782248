"""Batched NSIM (Neurogram Similarity Index Measure, Hines & Harte 2012),
ViSQOL's similarity core, on ``(B, T)`` tensors.

Counterpart of ``audiotools_tpu/ops/nsim.py``, on the device of its
inputs:

- a gammatone spectrogram: Hann-framed power spectra projected, in full
  fp32, through the squared 4th-order gammatone magnitude responses on an
  ERB-spaced grid (speech mode: 21 bands 50 Hz-8 kHz at 16 kHz; audio mode:
  32 bands 50 Hz-20 kHz at 48 kHz);
- log compression referenced to each item's reference peak, floored at a
  60 dB range and scaled to [0, 1];
- NSIM = luminance x structure with 3x3 uniform local statistics (separable
  3-tap means, elementwise fp32), averaged over cells weighted by the square
  root of the local reference intensity;
- a +-240 ms alignment search: NSIM at every frame shift in the range, the
  best shift winning per item. The shifts run one after another, so peak
  memory stays at one cell map.

The true ViSQOL maps NSIM per band through a trained SVR or lattice model
to MOS-LQO; those weights are not reproducible offline, so
:func:`nsim_to_moslqo` is a monotone piecewise-linear map anchored to
ViSQOL's published output range. Treat it as an uncertified estimate; the
raw NSIM is the stable metric.
"""
import functools

import numpy as np
import torch

from ..core import util
from ._fp32 import strict_fp32
from .fft import _frame
from .stoi import _common_length

__all__ = ["MODES", "gammatone_weights", "nsim_batch", "nsim_to_moslqo"]

MODES = {
    # fs, frame (pow2), hop, n_bands, fmin, fmax; 75% overlap: the alignment
    # search works at frame-hop granularity, so a finer hop bounds the
    # residual sub-frame misalignment penalty
    "speech": dict(fs=16000, frame=512, hop=128, n_bands=21, fmin=50.0, fmax=8000.0),
    "audio": dict(fs=48000, frame=2048, hop=512, n_bands=32, fmin=50.0, fmax=20000.0),
}
_DYN_DB = 60.0
_C1 = 0.01 ** 2
_C2 = 0.03 ** 2
_MAX_SHIFT_S = 0.24


def _erb(f):
    return 24.7 * (4.37 * f / 1000.0 + 1.0)


def _cam(f):
    return 21.4 * np.log10(4.37 * f / 1000.0 + 1.0)


def _cam_inv(c):
    return (10.0 ** (c / 21.4) - 1.0) / 4.37 * 1000.0


@functools.lru_cache(maxsize=None)
def gammatone_weights(mode: str):
    """``(n_bands, frame//2 + 1)`` squared-magnitude responses of a
    4th-order gammatone filterbank on an ERB-spaced grid, each band's
    weights summing to 1 (a white input gives flat band powers), and the
    center frequencies."""
    m = MODES[mode]
    f = np.fft.rfftfreq(m["frame"], d=1.0 / m["fs"])
    centers = _cam_inv(np.linspace(_cam(m["fmin"]), _cam(m["fmax"]), m["n_bands"]))
    b = 1.019 * _erb(centers)
    resp = (1.0 + ((f[None, :] - centers[:, None]) / b[:, None]) ** 2) ** -4.0
    resp /= resp.sum(axis=1, keepdims=True)
    return resp.astype(np.float32), centers


def _spectrogram(x, mode):
    """``(B, T)`` -> ``(B, n_bands, frames)`` gammatone power spectrogram."""
    m = MODES[mode]
    w = torch.from_numpy(np.hanning(m["frame"])).to(device=x.device, dtype=x.dtype)
    spec = torch.fft.rfft(_frame(x, m["frame"], m["hop"]) * w, dim=-1).abs() ** 2
    weights = torch.from_numpy(gammatone_weights(mode)[0]).to(x.device)
    with strict_fp32():
        return (spec @ weights.T).transpose(1, 2)


def _log_scale(p, ref_peak):
    """dB relative to the reference peak, floored to a 60 dB range and
    mapped to [0, 1]."""
    db = 10.0 * torch.log10(p + 1e-20) - ref_peak[:, None, None]
    return torch.clamp(db / _DYN_DB + 1.0, 0.0, 1.0)


def _mean3(a, dim):
    """3-tap uniform mean along ``dim`` with edge padding."""
    k = np.float32(1.0) / np.float32(3.0)
    n = a.shape[dim]
    pad = torch.cat([a.narrow(dim, 0, 1), a, a.narrow(dim, n - 1, 1)], dim=dim)
    return (pad.narrow(dim, 0, n) * k + pad.narrow(dim, 1, n) * k) + pad.narrow(dim, 2, n) * k


def _local_stats(img):
    """3x3 uniform local mean of ``(B, K, F)`` images, separable."""
    return _mean3(_mean3(img, 1), 2)


def _nsim_map(r, d, mu_r, var_r):
    """Per-cell NSIM between two [0, 1] spectrogram images ``(B, K, F)``;
    the reference's local statistics ``mu_r``, ``var_r`` do not depend on
    the shift and come from the caller."""
    mu_d = _local_stats(d)
    var_d = torch.clamp(_local_stats(d * d) - mu_d ** 2, min=0.0)
    cov = _local_stats(r * d) - mu_r * mu_d
    lum = (2.0 * mu_r * mu_d + _C1) / (mu_r ** 2 + mu_d ** 2 + _C1)
    struct = (cov + _C2) / (torch.sqrt(var_r * var_d) + _C2)
    return lum * struct


def _shifted_nsim(r, d, mu_r, var_r, w_base, shift, n_frames):
    """Reference-energy-weighted mean NSIM ``(B,)`` with the degraded
    spectrogram shifted by ``shift`` frames, masking the frames that fall
    off either edge."""
    d_s = torch.roll(d, shift, dims=2)
    idx = torch.arange(n_frames, device=r.device)
    valid = (idx >= max(shift, 0)) & (idx < n_frames + min(shift, 0))
    cell = _nsim_map(r, d_s, mu_r, var_r)
    w = w_base * valid.to(cell.dtype)[None, None, :]
    return (cell * w).sum(dim=(1, 2)) / (w.sum(dim=(1, 2)) + 1e-9)


def nsim_batch(references, estimates, mode: str = "speech") -> torch.Tensor:
    """Mean NSIM per item ``(B,)`` between ``(B, T)`` reference and degraded
    signals already at the mode's sample rate: scores in (0, 1], 1.0 for
    identical signals. Pairs of unequal length are trimmed to the shorter
    (the shift search absorbs offsets)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    m = MODES[mode]
    references, estimates = _common_length(references, estimates)
    if references.shape[-1] < m["frame"]:
        raise ValueError(
            f"signals too short for NSIM (need >= {m['frame']} samples, one {mode!r}-mode frame)")
    S_r = _spectrogram(references, mode)
    S_d = _spectrogram(estimates, mode)
    ref_peak = 10.0 * torch.log10(S_r.amax(dim=(1, 2)) + 1e-20)
    R = _log_scale(S_r, ref_peak)
    D = _log_scale(S_d, ref_peak)

    n_frames = R.shape[2]
    max_shift = min(int(_MAX_SHIFT_S * m["fs"] / m["hop"]), max(n_frames // 2 - 1, 0))
    mu_r = _local_stats(R)
    var_r = torch.clamp(_local_stats(R * R) - mu_r ** 2, min=0.0)
    w_base = torch.sqrt(mu_r)
    best = None
    for shift in range(-max_shift, max_shift + 1):
        score = _shifted_nsim(R, D, mu_r, var_r, w_base, shift, n_frames)
        best = score if best is None else torch.maximum(best, score)
    return best


# monotone anchors calibrated on AWGN/quantization/band-limit ladders,
# endpoints pinned to ViSQOL's published output range
_MOS_ANCHORS_NSIM = np.array([0.0, 0.45, 0.679, 0.85, 0.94, 0.984, 1.0])
_MOS_ANCHORS_MOS = np.array([1.0, 1.05, 1.5, 2.4, 3.3, 4.1, 4.73])


def nsim_to_moslqo(nsim) -> torch.Tensor:
    """Monotone piecewise-linear NSIM -> MOS-LQO estimate anchored to
    ViSQOL's output range (identical -> 4.73, floor 1.0), constant outside
    the anchors. Uncertified: treat raw NSIM as the stable metric."""
    nsim = util.as_device_tensor(nsim)
    xp = torch.as_tensor(_MOS_ANCHORS_NSIM, dtype=nsim.dtype, device=nsim.device)
    fp = torch.as_tensor(_MOS_ANCHORS_MOS, dtype=nsim.dtype, device=nsim.device)
    i = torch.clamp(torch.searchsorted(xp, nsim, right=True), 1, len(xp) - 1)
    f = fp[i - 1] + ((nsim - xp[i - 1]) / (xp[i] - xp[i - 1])) * (fp[i] - fp[i - 1])
    f = torch.where(nsim < xp[0], fp[0], f)
    return torch.where(nsim > xp[-1], fp[-1], f)
