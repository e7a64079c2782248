"""ITU-R BS.1770-4 K-weighted gated loudness on tensors.

Counterpart of ``audiotools_tpu/ops/loudness.py``. The exact meter runs
the weighting cascade through ``filters.iir_cascade_blocked``; the FIR
meter (``use_fir=True``, the original library's GPU meter, selected for
every call by ``set_fast_meter(True)``) convolves with the stages'
truncated impulse responses composed into one causal kernel, through
kernel C (``hopper_kernels.fir_causal``) or an FFT convolution. The gating
(eqs. 1-7: 400 ms blocks at 75% overlap, absolute gate at -70 LKFS,
relative gate 10 LU below the ungated mean) is one tensor function shared
by the device meter and the host meter (``host_loudness``, which filters
with scipy's ``lfilter``).
"""
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .._hostprof import span
from . import hopper_kernels
from .filters import causal_fft_conv1d, fir_from_biquad, iir_cascade_blocked

__all__ = [
    "GAIN_FACTOR",
    "MIN_LOUDNESS",
    "design_filters",
    "k_weighting_coefficients",
    "set_fast_meter",
    "apply_k_weighting",
    "integrated_loudness",
    "host_loudness",
    "loudness",
]

GAIN_FACTOR = np.log(10) / 20
"""Amplitude <-> decibel conversion factor."""

MIN_LOUDNESS = -70.0

_METER_DEFAULTS = {"use_fir": False, "conv_method": "fft", "zeros": 512}

CONV_METHODS = ("fft", "fft_os", "pallas", "pallas_interpret")


def set_fast_meter(enable: bool = True, zeros: int = 512):
    """Set the process-wide default meter of every ``loudness()`` call that
    passes no options (``mix``, ``normalize`` and ``VolumeNorm`` included).

    ``enable=True`` selects the ``zeros``-tap truncated-FIR meter through
    kernel C (``conv_method="pallas"``): the original library's GPU meter,
    for agreement with it, not for speed. ``enable=False`` restores the
    exact cascade.
    """
    global _METER_DEFAULTS
    if enable:
        _METER_DEFAULTS = {"use_fir": True, "conv_method": "pallas", "zeros": zeros}
    else:
        _METER_DEFAULTS = {"use_fir": False, "conv_method": "fft", "zeros": 512}

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


def k_weighting_coefficients(rate: int):
    """K-weighting ``(b, a)`` per stage."""
    return [ba for ba, _ in design_filters(rate, "K-weighting")]


@functools.lru_cache(maxsize=None)
def _composed_fir(rate: int, filter_class: str, zeros: int) -> np.ndarray:
    """The stages' ``zeros``-tap truncated impulse responses composed into
    one causal kernel (host-side design): applying the truncated stage FIRs
    one after another is the same causal filter."""
    h = np.zeros(1, dtype=np.float64)
    h[0] = 1.0
    gain = 1.0
    for (b, a), g in design_filters(rate, filter_class):
        h = np.convolve(h, fir_from_biquad(b, a, zeros).astype(np.float64))
        gain *= g
    return (gain * h).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _exact_fir(rate: int, filter_class: str, max_taps: int = 1 << 16) -> np.ndarray:
    """The cascade's impulse response, cut where its tail falls below 1e-10
    of its peak (host-side design): convolving with it is exact to fp32."""
    from scipy.signal import lfilter

    impulse = np.zeros(max_taps)
    impulse[0] = 1.0
    h = impulse
    gain = 1.0
    for (b, a), g in design_filters(rate, filter_class):
        h = lfilter(b, a, h)
        gain *= g
    h = gain * h
    tail = np.abs(h) / (np.abs(h).max() + 1e-30)
    keep = np.nonzero(tail > 1e-10)[0]
    n_keep = int(keep[-1]) + 1 if len(keep) else 1
    return h[:n_keep].astype(np.float32)


@functools.lru_cache(maxsize=16)
def _composed_fir_on(rate: int, filter_class: str, zeros: int, device: torch.device):
    return torch.from_numpy(_composed_fir(rate, filter_class, zeros)).to(device)


def apply_k_weighting(audio: torch.Tensor, rate: int, filter_class: str = "K-weighting",
                      use_fir: bool = False, zeros: int = 512,
                      conv_method: str = "fft") -> torch.Tensor:
    """Weighting filters over the last axis of ``(..., T)`` audio.

    ``use_fir=False`` runs the exact cascade (block state-space lifting).
    ``use_fir=True`` convolves with the ``zeros``-tap composed FIR:
    ``conv_method="pallas"`` through kernel C when the kernel has at most
    ``hopper_kernels.MAX_TAPS`` taps (its plain version for CPU tensors),
    ``"pallas_interpret"`` (the JAX package's name for the kernel off its
    hardware) through C's plain version under the same rule, otherwise, and
    for ``"fft"``, one FFT convolution; ``"fft_os"`` in 8192-point
    overlap-save blocks.
    """
    if conv_method not in CONV_METHODS:
        raise ValueError(f"conv_method must be one of {CONV_METHODS}, got {conv_method!r}")
    if not use_fir:
        stages = [(b, a, g) for (b, a), g in design_filters(rate, filter_class)]
        return iir_cascade_blocked(audio, stages)
    kernel = _composed_fir_on(rate, filter_class, zeros, audio.device)
    if conv_method.startswith("pallas") and kernel.shape[0] <= hopper_kernels.MAX_TAPS:
        fir = (hopper_kernels.fir_causal_plain if conv_method == "pallas_interpret"
               else hopper_kernels.fir_causal)
        return fir(audio, kernel)
    return causal_fft_conv1d(audio, kernel, block_size=8192 if conv_method == "fft_os" else None)


def _meter_options(use_fir, zeros, conv_method):
    """Explicit meter options, the process-wide defaults for the rest."""
    return (
        _METER_DEFAULTS["use_fir"] if use_fir is None else use_fir,
        _METER_DEFAULTS["zeros"] if zeros is None else zeros,
        _METER_DEFAULTS["conv_method"] if conv_method is None else conv_method,
    )


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
                        block_size: float = 0.400, use_fir: bool = None, zeros: int = None,
                        conv_method: str = None) -> torch.Tensor:
    """Integrated gated loudness (LUFS) of ``(nb, nt, nch)`` audio, ``(nb,)``.
    Meter options left at ``None`` take the defaults of
    :func:`set_fast_meter`. The span ``loudness``."""
    with span("loudness"):
        if data.ndim == 1:
            data = data[None, :, None]
        elif data.ndim == 2:
            data = data[None]
        filtered = apply_k_weighting(data.float().transpose(-1, -2), rate, filter_class,
                                     *_meter_options(use_fir, zeros, conv_method))
        return _gated_lufs(filtered, rate, block_size)


def host_loudness(audio_data: np.ndarray, sample_rate: int,
                  filter_class: str = "K-weighting", block_size: float = 0.400,
                  dtype=np.float64) -> np.ndarray:
    """Host meter of ``(nb, nch, nt)`` numpy audio: scipy ``lfilter`` for the
    cascade (exact IIR), the shared gating on CPU tensors. Pads to >= 0.5 s
    and clamps at -70 LKFS like :func:`loudness`."""
    from scipy.signal import lfilter

    with span("salient_meter"):
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
             filter_class: str = "K-weighting", block_size: float = 0.400,
             use_fir: bool = None, zeros: int = None, conv_method: str = None) -> torch.Tensor:
    """Loudness of ``(nb, nch, nt)`` audio, padded to >= 0.5 s and clamped
    at -70 LKFS. Returns ``(nb,)``. Meter options as
    :func:`integrated_loudness` takes them. The span ``loudness``."""
    with span("loudness"):
        nt = audio_data.shape[-1]
        min_len = int(0.5 * sample_rate)
        if nt < min_len:
            audio_data = F.pad(audio_data, (0, min_len - nt))
        filtered = apply_k_weighting(audio_data.float(), sample_rate, filter_class,
                                     *_meter_options(use_fir, zeros, conv_method))
        return torch.clamp(_gated_lufs(filtered, sample_rate, block_size), min=MIN_LOUDNESS)
