"""FIR/IIR filtering on tensors: the mel-band graphic equalizer and the
exact blocked IIR cascade.

Counterpart of ``audiotools_tpu/ops/filters.py`` for the augmentation
path. The equalizer collapses its band-split into one per-item FIR and
runs it through kernel A (``hopper_kernels.fir_causal_batch``); the IIR
cascade runs by block state-space lifting: per-block Toeplitz matmuls in
fp32 plus a sequential recurrence over block states.
"""
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import hopper_kernels
from ._fp32 import strict_fp32

__all__ = ["mel_band_cutoffs", "equalizer", "iir_cascade_blocked"]


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=None)
def mel_band_cutoffs(sample_rate: int, n_bands: int) -> tuple:
    """Interior HTK-mel-spaced cutoffs (Hz) of an ``n_bands`` band split."""
    high = 2595.0 * math.log10(1 + (sample_rate / 2) / 700.0)
    mels = np.linspace(0.0, high, n_bands + 1)
    freqs = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    return tuple(float(f) for f in freqs[1:-1])


@functools.lru_cache(maxsize=None)
def _split_band_kernels(sample_rate: int, n_bands: int, zeros: int = 8):
    """Low-pass bank ``(n_bands - 1, 2 * half + 1)`` of the band splitter:
    every kernel shares the support of the smallest cutoff and its Hann
    window (one stacked conv weight)."""
    cutoffs = np.array(mel_band_cutoffs(sample_rate, n_bands)) / sample_rate
    half = int(zeros / cutoffs.min() / 2)
    t = np.arange(-half, half + 1, dtype=np.float64)
    win = np.hanning(2 * half + 1) if half > 0 else np.ones(1)
    kernels = np.zeros((len(cutoffs), 2 * half + 1))
    for i, c in enumerate(cutoffs):
        arg = 2 * c * np.pi * t
        sinc = np.where(np.abs(arg) < 1e-12, 1.0, np.sin(arg) / np.where(arg == 0, 1, arg))
        k = 2 * c * win * sinc
        kernels[i] = k / k.sum()
    return kernels.astype(np.float32), half


@functools.lru_cache(maxsize=32)
def _split_band_tensor(sample_rate: int, n_bands: int, zeros: int, device: torch.device):
    return torch.from_numpy(_split_band_kernels(sample_rate, n_bands, zeros)[0]).to(device)


def _edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate-pad the last axis of ``(B, C, T)``."""
    return F.pad(x, (pad, pad), mode="replicate")


def _fft_conv_valid(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Correlate ``(B, C, Tp)`` signals with per-item ``(B_k, L)`` kernels
    by FFT, returning full-convolution indices ``[L - 1:]``."""
    L = kernels.shape[-1]
    n = _next_pow2(x.shape[-1])
    X = torch.fft.rfft(x, n=n)
    H = torch.fft.rfft(kernels[:, None].flip(-1), n=n)
    return torch.fft.irfft(X * H, n=n)[..., L - 1 :]


def equalizer(audio: torch.Tensor, db, sample_rate: int, zeros: int = 8) -> torch.Tensor:
    """Mel-spaced graphic EQ of ``(B, C, T)`` audio: weight each band by
    ``10 ** db`` (``db``: ``(n_bands,)``, ``(1, n_bands)`` or ``(B,
    n_bands)``) and sum.

    With bands ``b_0 = lp_0``, ``b_i = lp_i - lp_{i-1}``, ``b_{n-1} = x -
    lp_{n-2}``, the weighted sum telescopes to ``w_{n-1} x + x * sum_i (w_i
    - w_{i+1}) k_i``: one per-item FIR. Kernels of at most
    ``hopper_kernels.MAX_TAPS`` taps go through kernel A (its plain version
    for CPU tensors); longer ones through an FFT convolution.
    """
    db = torch.as_tensor(db, dtype=torch.float32, device=audio.device)
    if db.ndim == 1:
        db = db[None, :]
    n_bands = db.shape[-1]
    weights = 10.0 ** db  # (B, n_bands)
    if n_bands == 1:
        return audio * weights[:, 0, None, None]
    half = _split_band_kernels(sample_rate, n_bands, zeros)[1]
    kernels = _split_band_tensor(sample_rate, n_bands, zeros, audio.device)
    with strict_fp32():
        combined = (weights[:, :-1] - weights[:, 1:]) @ kernels  # (B, L)
    x = _edge_pad(audio, half)
    L = 2 * half + 1
    T = audio.shape[-1]
    if L <= hopper_kernels.MAX_TAPS:
        # full-convolution index t + L - 1 is the causal conv of the padded
        # signal with the reversed kernel at time t + L - 1
        B_, C_, Tp = x.shape
        g = combined.flip(-1)
        if g.shape[0] == 1 and B_ > 1:  # one curve for the whole batch
            g = g.expand(B_, -1)
        if C_ > 1:
            g = g.repeat_interleave(C_, dim=0)
        y = hopper_kernels.fir_causal_batch(x.reshape(B_ * C_, Tp), g.contiguous())
        y = y.reshape(B_, C_, Tp)[..., L - 1 :]
    else:
        y = _fft_conv_valid(x, combined)
    return weights[:, -1, None, None] * audio + y[..., :T]


@functools.lru_cache(maxsize=None)
def _blocked_iir_operators(stages_key: tuple, block: int):
    """Block-lifted state-space operators of a biquad cascade (float64
    design, cast to float32).

    With ``s[n] = A s[n-1] + B x[n]``, ``y[n] = C s[n-1] + D x[n]``, a block
    of L samples is ``y = Phi_x x + Phi_s s_pre`` and ``s_end = A^L s_pre +
    Psi_x x``: ``Phi_x[i, j] = h[i-j]`` (Markov parameters, ``h[0] = D``,
    ``h[m] = C A^{m-1} B``), ``Phi_s[i] = C A^i``, ``Psi_x[:, j] =
    A^{L-1-j} B``. The realization is diagonally balanced first, so f32
    state rounding does not leak into y through oversized states.
    """
    from scipy.linalg import solve_discrete_lyapunov

    A = np.zeros((0, 0))
    Bv = np.zeros((0,))
    Cv = np.zeros((0,))
    Dg = 1.0
    for b, a, gain in stages_key:
        b = np.asarray(b, dtype=np.float64)
        a = np.asarray(a, dtype=np.float64)
        b = b / a[0] * gain
        a = a / a[0]
        A_i = np.array([[-a[1], 1.0], [-a[2], 0.0]])
        B_i = np.array([b[1] - a[1] * b[0], b[2] - a[2] * b[0]])
        C_i = np.array([1.0, 0.0])
        D_i = b[0]
        n = A.shape[0]
        A = np.block([[A, np.zeros((n, 2))], [np.outer(B_i, Cv), A_i]]) if n else A_i
        Bv = np.concatenate([Bv, B_i * Dg]) if n else B_i
        Cv = np.concatenate([D_i * Cv, C_i]) if n else C_i
        Dg = D_i * Dg

    ns = A.shape[0]
    P = solve_discrete_lyapunov(A, np.outer(Bv, Bv))
    Q = solve_discrete_lyapunov(A.T, np.outer(Cv, Cv))
    scale = (np.maximum(np.diag(P), 1e-20) / np.maximum(np.diag(Q), 1e-20)) ** 0.25
    A = A * (scale[None, :] / scale[:, None])
    Bv = Bv / scale
    Cv = Cv * scale

    powers = [np.eye(ns)]
    for _ in range(block):
        powers.append(A @ powers[-1])
    markov = np.zeros(block)
    markov[0] = Dg
    for m in range(1, block):
        markov[m] = Cv @ powers[m - 1] @ Bv
    idx = np.arange(block)
    diff = idx[:, None] - idx[None, :]
    phi_x = np.where(diff >= 0, markov[np.clip(diff, 0, block - 1)], 0.0)
    phi_s = np.stack([Cv @ powers[i] for i in range(block)])  # (L, ns)
    psi_x = np.stack([powers[block - 1 - j] @ Bv for j in range(block)], axis=1)  # (ns, L)
    return (
        phi_x.astype(np.float32),
        phi_s.astype(np.float32),
        psi_x.astype(np.float32),
        powers[block].astype(np.float32),
    )


@functools.lru_cache(maxsize=16)
def _iir_operators_on(stages_key: tuple, block: int, device: torch.device):
    """Transposed device copies ``(Phi_x^T, Phi_s^T, Psi_x^T, (A^L)^T)``."""
    return tuple(torch.from_numpy(m.T.copy()).to(device)
                 for m in _blocked_iir_operators(stages_key, block))


def iir_cascade_blocked(x: torch.Tensor, stages, block: int = 512) -> torch.Tensor:
    """Exact biquad-cascade filtering of ``(..., T)`` audio by block
    state-space lifting. ``stages``: ``(b, a, gain)`` triples.

    The block-state recurrence is a sequential loop over blocks: a tree
    scan would form explicit f32 powers of ``A^L`` and amplify rounding.
    """
    stages_key = tuple(
        (tuple(float(v) for v in b), tuple(float(v) for v in a), float(g))
        for b, a, g in stages
    )
    phi_x_t, phi_s_t, psi_x_t, a_l_t = _iir_operators_on(stages_key, block, x.device)
    T = x.shape[-1]
    batch_shape = x.shape[:-1]
    xf = F.pad(x.reshape(-1, T), (0, -T % block))
    rows = xf.shape[0]
    xb = xf.reshape(rows, -1, block)  # (B, nblk, L)
    n_blk = xb.shape[1]
    with strict_fp32():
        part = xb @ phi_x_t  # in-block response to the block's own input
        u = (xb @ psi_x_t).transpose(0, 1).contiguous()  # (nblk, B, ns)
        s_pre = torch.zeros_like(u)  # state before each block
        # one launch per block: s_pre[k + 1] = s_pre[k] A_L^T + u[k], in place
        s_k, u_k = s_pre.unbind(0), u.unbind(0)
        for k in range(n_blk - 1):
            torch.addmm(u_k[k], s_k[k], a_l_t, out=s_k[k + 1])
        y = part + s_pre.transpose(0, 1) @ phi_s_t
    return y.reshape(rows, -1)[:, :T].reshape(batch_shape + (T,))
