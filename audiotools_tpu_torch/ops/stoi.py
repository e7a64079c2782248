"""Batched STOI (Taal et al. 2010/2011) and extended STOI (Jensen & Taal
2016) on ``(B, T)`` tensors at 10 kHz.

Counterpart of ``audiotools_tpu/ops/stoi.py``: the whole measure (framing,
silence removal, one-third-octave band envelopes, 384 ms sliding-window
correlations) over the batch, on the device of its inputs. Silence removal
keeps a static shape: a stable argsort compacts the retained frames to the
front (order preserved), dropped slots are zeroed, the compacted frames
overlap-add into a buffer of fixed length, and every later reduction is
masked by the retained-frame count. The band projection runs in full fp32
(``strict_fp32``). Matches the float64 host loop
(``metrics.quality.stoi``) to float32 precision.
"""
import functools

import numpy as np
import torch

from ..core import util
from ._fp32 import strict_fp32
from .fft import _frame, _overlap_add

__all__ = ["FS", "stoi_batch", "thirdoct"]

FS = 10000
N_FRAME = 256
HOP = N_FRAME // 2
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N = 30  # frames per intermediate-intelligibility window (384 ms)
BETA = -15.0
DYN_RANGE = 40.0


@functools.lru_cache(maxsize=None)
def thirdoct(fs=FS, nfft=NFFT, num_bands=NUMBAND, min_freq=MINFREQ):
    """One-third-octave band matrix ``(num_bands, nfft//2+1)`` and the band
    center frequencies."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6.0)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((num_bands, len(f)), dtype=np.float32)
    for i in range(num_bands):
        lo = np.argmin((f - freq_low[i]) ** 2)
        hi = np.argmin((f - freq_high[i]) ** 2)
        obm[i, lo:hi] = 1
    return obm, cf


@functools.lru_cache(maxsize=None)
def _window():
    return np.hanning(N_FRAME + 2)[1:-1].astype(np.float32)


def _band_envelopes(sig, w, obm):
    """``(B, T)`` spliced signals -> ``(B, NUMBAND, n_frames)`` band
    magnitudes."""
    frames = _frame(sig, N_FRAME, HOP) * w
    spec = torch.fft.rfft(frames, NFFT).abs() ** 2
    with strict_fp32():
        bands = spec @ obm.T
    return torch.sqrt(torch.clamp(bands, min=1e-15)).transpose(1, 2)


def _rcn(Z):
    """eSTOI's double normalization of ``(..., NUMBAND, N)`` segments: each
    band across the N frames, then each frame across the bands."""
    Z = Z - Z.mean(dim=-1, keepdim=True)
    Z = Z / (torch.linalg.vector_norm(Z, dim=-1, keepdim=True) + 1e-12)
    Z = Z - Z.mean(dim=-2, keepdim=True)
    return Z / (torch.linalg.vector_norm(Z, dim=-2, keepdim=True) + 1e-12)


def _stoi_parts(x, y, extended):
    """``(B, T)`` reference ``x`` and estimate ``y`` at 10 kHz -> scores
    ``(B,)`` and the number of frames kept by silence removal ``(B,)``."""
    w = torch.from_numpy(_window()).to(x.device)
    obm = torch.from_numpy(thirdoct()[0]).to(x.device)

    xf = _frame(x, N_FRAME, HOP) * w  # (B, n0, 256)
    yf = _frame(y, N_FRAME, HOP) * w
    n0 = xf.shape[1]

    # silence removal keyed on the REFERENCE frame energies: compact the
    # retained frames to the front in original order (unique integer keys
    # and a stable sort), zero the rest
    energies = 20.0 * torch.log10(torch.linalg.vector_norm(xf, dim=-1) + 1e-12)
    mask = energies > energies.max(dim=-1, keepdim=True).values - DYN_RANGE
    slot = torch.arange(n0, device=x.device)
    order = torch.argsort(torch.where(mask, slot, n0 + slot), dim=-1, stable=True)
    n_valid = mask.sum(dim=-1)
    keep = (slot < n_valid[:, None])[..., None]
    xk = torch.where(keep, torch.take_along_dim(xf, order[..., None], dim=1), 0.0)
    yk = torch.where(keep, torch.take_along_dim(yf, order[..., None], dim=1), 0.0)

    # splice retained frames (the zeroed tail keeps the buffer exact)
    out_len = (n0 - 1) * HOP + N_FRAME
    X = _band_envelopes(_overlap_add(xk, HOP, out_len), w, obm)  # (B, 15, n0)
    Y = _band_envelopes(_overlap_add(yk, HOP, out_len), w, obm)

    # all N-frame windows; window p covers frames [p, p+N) and is valid iff
    # it lies inside the retained region
    n_win = n0 - N + 1
    Xs = X.unfold(-1, N, 1).transpose(1, 2)  # (B, n_win, 15, N)
    Ys = Y.unfold(-1, N, 1).transpose(1, 2)
    if extended:
        d_win = (_rcn(Xs) * _rcn(Ys)).sum(dim=(-2, -1)) / N
    else:
        alpha = torch.linalg.vector_norm(Xs, dim=-1, keepdim=True) / (
            torch.linalg.vector_norm(Ys, dim=-1, keepdim=True) + 1e-12)
        aY = torch.minimum(Ys * alpha, Xs * (1 + 10 ** (-BETA / 20)))
        xm = Xs - Xs.mean(dim=-1, keepdim=True)
        ym = aY - aY.mean(dim=-1, keepdim=True)
        num = (xm * ym).sum(dim=-1)
        den = (torch.linalg.vector_norm(xm, dim=-1) * torch.linalg.vector_norm(ym, dim=-1)
               + 1e-12)
        d_win = (num / den).mean(dim=-1)

    valid = torch.arange(n_win, device=x.device) + N <= n_valid[:, None]
    d = torch.where(valid, d_win, 0.0).sum(dim=-1) / torch.clamp(valid.sum(dim=-1), min=1)

    # too little retained signal for even one window: undefined (host
    # parity: spliced length under N_FRAME * N samples)
    spliced_len = torch.clamp(n_valid - 1, min=0) * HOP + N_FRAME
    return torch.where(spliced_len < N_FRAME * N, torch.nan, d), n_valid


def _common_length(references, estimates):
    """Both batches as float32 tensors (a tensor stays on its device, an
    array goes to the card), trimmed to the shorter length."""
    references = util.as_device_tensor(references)
    estimates = util.as_device_tensor(estimates).to(references.device)
    T = min(references.shape[-1], estimates.shape[-1])
    return references[..., :T], estimates[..., :T]


def stoi_batch(references, estimates, extended: bool = False) -> torch.Tensor:
    """STOI for ``(B, T)`` reference/estimate pairs at 10 kHz -> ``(B,)``.

    Resampling to ``FS`` and the mono mixdown happen in the caller
    (``metrics.quality.stoi_device``). Pairs of unequal length are trimmed
    to the shorter; inputs too short for one window score NaN."""
    references, estimates = _common_length(references, estimates)
    if references.shape[-1] < N_FRAME + (N - 1) * HOP:
        # fewer than N frames in all: no window can ever be valid
        return torch.full((references.shape[0],), torch.nan, device=references.device)
    return _stoi_parts(references, estimates, extended)[0]
