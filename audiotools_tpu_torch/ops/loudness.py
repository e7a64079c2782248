"""ITU-R BS.1770-4 K-weighted gated loudness on tensors.

Counterpart of ``audiotools_tpu/ops/loudness.py`` for the exact meter:
the weighting cascade runs through ``filters.iir_cascade_blocked``, the
gating (eqs. 1-7: 400 ms blocks at 75% overlap, absolute gate at -70
LKFS, relative gate 10 LU below the ungated mean) in one tensor function
shared by the device meter and the host meter (``host_loudness``, which
filters with scipy's ``lfilter``).
"""
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .filters import iir_cascade_blocked

__all__ = [
    "GAIN_FACTOR",
    "MIN_LOUDNESS",
    "design_filters",
    "apply_k_weighting",
    "integrated_loudness",
    "host_loudness",
    "loudness",
]

GAIN_FACTOR = np.log(10) / 20
"""Amplitude <-> decibel conversion factor."""

MIN_LOUDNESS = -70.0

# channel gains G: L, R, C, Ls, Rs
CHANNEL_GAINS = np.array([1.0, 1.0, 1.0, 1.41, 1.41], dtype=np.float32)


def _rbj(filter_type: str, G: float, Q: float, fc: float, rate: float):
    """RBJ audio-EQ-cookbook biquad ``(b, a)`` normalized by ``a0``."""
    A = 10.0 ** (G / 40.0)
    w0 = 2.0 * np.pi * (fc / rate)
    alpha = np.sin(w0) / (2.0 * Q)
    cw = np.cos(w0)
    if filter_type == "high_shelf":
        b0 = A * ((A + 1) + (A - 1) * cw + 2 * np.sqrt(A) * alpha)
        b1 = -2 * A * ((A - 1) + (A + 1) * cw)
        b2 = A * ((A + 1) + (A - 1) * cw - 2 * np.sqrt(A) * alpha)
        a0 = (A + 1) - (A - 1) * cw + 2 * np.sqrt(A) * alpha
        a1 = 2 * ((A - 1) - (A + 1) * cw)
        a2 = (A + 1) - (A - 1) * cw - 2 * np.sqrt(A) * alpha
    elif filter_type == "high_pass":
        b0 = (1 + cw) / 2
        b1 = -(1 + cw)
        b2 = (1 + cw) / 2
        a0 = 1 + alpha
        a1 = -2 * cw
        a2 = 1 - alpha
    elif filter_type == "peaking":
        b0 = 1 + alpha * A
        b1 = -2 * cw
        b2 = 1 - alpha * A
        a0 = 1 + alpha / A
        a1 = -2 * cw
        a2 = 1 - alpha / A
    elif filter_type == "low_shelf":
        b0 = A * ((A + 1) - (A - 1) * cw + 2 * np.sqrt(A) * alpha)
        b1 = 2 * A * ((A - 1) - (A + 1) * cw)
        b2 = A * ((A + 1) - (A - 1) * cw - 2 * np.sqrt(A) * alpha)
        a0 = (A + 1) + (A - 1) * cw + 2 * np.sqrt(A) * alpha
        a1 = -2 * ((A - 1) + (A + 1) * cw)
        a2 = (A + 1) + (A - 1) * cw - 2 * np.sqrt(A) * alpha
    else:
        raise ValueError(f"Unknown filter type {filter_type}")
    b = np.array([b0, b1, b2], dtype=np.float64) / a0
    a = np.array([a0, a1, a2], dtype=np.float64) / a0
    return b, a


@functools.lru_cache(maxsize=None)
def design_filters(rate: int, filter_class: str = "K-weighting"):
    """Weighting cascade for a sample rate: ``((b, a), passband_gain)`` stages."""
    if filter_class == "K-weighting":
        # RBJ parameters fitted so the bilinear design reproduces BS.1770-4's
        # published 48 kHz table while scaling to any sample rate
        shelf = _rbj("high_shelf", 3.99979529, 0.707315703, 1500.51207, rate)
        _, hp_a = _rbj("high_pass", 0.0, 0.50032685, 38.13546889, rate)
        # BS.1770 fixes the high-pass numerator at [1, -2, 1]
        stages = [(shelf, 1.0), ((np.array([1.0, -2.0, 1.0]), hp_a), 1.0)]
    elif filter_class == "Fenton/Lee 1":
        stages = [
            (_rbj("high_shelf", 5.0, 1 / np.sqrt(2.0), 1500.0, rate), 1.0),
            (_rbj("high_pass", 0.0, 0.5, 130.0, rate), 1.0),
            (_rbj("peaking", 0.0, 1 / np.sqrt(2.0), 500.0, rate), 1.0),
        ]
    elif filter_class == "Fenton/Lee 2":
        stages = [
            (_rbj("high_shelf", 5.0, 1 / np.sqrt(2.0), 1500.0, rate), 1.0),
            (_rbj("high_pass", 0.0, 0.5, 130.0, rate), 1.0),
        ]
    elif filter_class == "Dash et al.":
        stages = [
            (_rbj("high_pass", 0.0, 0.375, 149.0, rate), 1.0),
            (_rbj("peaking", -13.24, 1 / np.sqrt(2.0), 1000.0, rate), 1.0),
        ]
    else:
        raise ValueError(f"Unknown filter class {filter_class}")
    return tuple(((b, a), g) for (b, a), g in stages)


def apply_k_weighting(audio: torch.Tensor, rate: int,
                      filter_class: str = "K-weighting") -> torch.Tensor:
    """Exact weighting cascade over the last axis of ``(..., T)`` audio."""
    stages = [(b, a, g) for (b, a), g in design_filters(rate, filter_class)]
    return iir_cascade_blocked(audio, stages)


@functools.lru_cache(maxsize=16)
def _channel_gains(nch: int, dtype: torch.dtype, device: torch.device):
    return torch.from_numpy(CHANNEL_GAINS[:nch]).to(device=device, dtype=dtype)


def _gated_lufs(filtered: torch.Tensor, rate: int, block_size: float) -> torch.Tensor:
    """BS.1770-4 gating (eqs. 1-7) of weighted ``(nb, nch, nt)`` audio."""
    nb, nch, nt = filtered.shape
    G = _channel_gains(nch, filtered.dtype, filtered.device)
    kernel = int(block_size * rate)
    stride = int(block_size * rate * 0.25)  # 75% overlap
    # ceil frame count, zero padding at the end
    n_frames = math.ceil((max(nt, kernel) - kernel) / stride) + 1
    padded = F.pad(filtered, (0, (n_frames - 1) * stride + kernel - nt))

    # mean square per block and channel (eq. 1)
    if kernel == 4 * stride:
        # a block is four strides: sums of non-overlapping partial sums
        s = (padded * padded).reshape(nb, nch, n_frames + 3, stride).sum(-1)
        z = (s[..., 0:n_frames] + s[..., 1 : n_frames + 1]
             + s[..., 2 : n_frames + 2] + s[..., 3 : n_frames + 3]) / (block_size * rate)
    else:
        frames = padded.unfold(-1, kernel, stride)
        z = (frames * frames).sum(-1) / (block_size * rate)

    # block loudness (eq. 2), absolute gate (eqs. 5-6)
    l = -0.691 + 10.0 * torch.log10((G[None, :, None] * z).sum(1, keepdim=True))
    l = l.expand(z.shape)
    above_abs = l > -70.0
    z_avg_abs = torch.where(above_abs, z, 0.0).sum(2) / above_abs.sum(2)
    gamma_r = -0.691 + 10.0 * torch.log10((z_avg_abs * G[None, :]).sum(-1)) - 10.0

    # relative and absolute gate (eq. 7)
    above_both = above_abs & (l > gamma_r[:, None, None])
    z_avg = torch.where(above_both, z, 0.0).sum(2) / above_both.sum(2)
    z_avg = torch.nan_to_num(
        z_avg, nan=0.0, posinf=torch.finfo(torch.float32).max,
        neginf=torch.finfo(torch.float32).min,
    )
    lufs = -0.691 + 10.0 * torch.log10((G[None, :] * z_avg).sum(1))
    return lufs.float()


def integrated_loudness(data: torch.Tensor, rate: int, filter_class: str = "K-weighting",
                        block_size: float = 0.400) -> torch.Tensor:
    """Integrated gated loudness (LUFS) of ``(nb, nt, nch)`` audio, ``(nb,)``."""
    if data.ndim == 1:
        data = data[None, :, None]
    elif data.ndim == 2:
        data = data[None]
    filtered = apply_k_weighting(data.float().transpose(-1, -2), rate, filter_class)
    return _gated_lufs(filtered, rate, block_size)


def host_loudness(audio_data: np.ndarray, sample_rate: int,
                  filter_class: str = "K-weighting", block_size: float = 0.400,
                  dtype=np.float64) -> np.ndarray:
    """Host meter of ``(nb, nch, nt)`` numpy audio: scipy ``lfilter`` for the
    cascade (exact IIR), the shared gating on CPU tensors. Pads to >= 0.5 s
    and clamps at -70 LKFS like :func:`loudness`."""
    from scipy.signal import lfilter

    data = np.asarray(audio_data, dtype=dtype)
    if data.ndim == 1:
        data = data[None, None, :]
    elif data.ndim == 2:
        data = data[None]
    min_len = int(0.5 * sample_rate)
    if data.shape[-1] < min_len:
        data = np.pad(data, ((0, 0), (0, 0), (0, min_len - data.shape[-1])))
    for (b, a), gain in design_filters(sample_rate, filter_class):
        data = gain * lfilter(np.asarray(b, dtype), np.asarray(a, dtype), data, axis=-1)
    lufs = _gated_lufs(torch.from_numpy(np.ascontiguousarray(data)), sample_rate, block_size)
    return np.maximum(lufs.numpy(), MIN_LOUDNESS).astype(np.float32)


def loudness(audio_data: torch.Tensor, sample_rate: int,
             filter_class: str = "K-weighting", block_size: float = 0.400) -> torch.Tensor:
    """Loudness of ``(nb, nch, nt)`` audio, padded to >= 0.5 s and clamped
    at -70 LKFS. Returns ``(nb,)``."""
    nt = audio_data.shape[-1]
    min_len = int(0.5 * sample_rate)
    if nt < min_len:
        audio_data = F.pad(audio_data, (0, min_len - nt))
    filtered = apply_k_weighting(audio_data.float(), sample_rate, filter_class)
    return torch.clamp(_gated_lufs(filtered, sample_rate, block_size), min=MIN_LOUDNESS)
