"""FIR/IIR filtering on tensors: the mel-band split and graphic
equalizer, the windowed-sinc low- and high-pass, pre-emphasis, valid,
causal and overlap-save FFT convolution, exact biquads, truncated biquad
FIRs and the exact blocked IIR cascade.

Counterpart of ``audiotools_tpu/ops/filters.py``. The equalizer collapses
its band-split into one per-item FIR and runs it through kernel A
(``hopper_kernels.fir_causal_batch``); the band split and the sinc filters
convolve by ``torch.fft`` in fp32; biquads and the IIR cascade run by
block state-space lifting: per-block Toeplitz matmuls in fp32 plus a
sequential recurrence over block states (kernel F,
``hopper_kernels.iir_block_scan``, on the card).
"""
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import hopper_kernels
from ._fp32 import strict_fp32

__all__ = [
    "fft_conv1d",
    "mel_band_cutoffs",
    "split_bands",
    "equalizer",
    "lowpass_kernel",
    "low_pass",
    "high_pass",
    "overlap_save_valid",
    "preemphasis",
    "causal_fft_conv1d",
    "biquad",
    "biquad_cascade",
    "fir_from_biquad",
    "iir_cascade_blocked",
]

CONV_METHODS = (None, "pallas", "pallas_interpret", "fft")


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


def fft_conv1d(x: torch.Tensor, kernels) -> torch.Tensor:
    """Valid-mode correlation (``conv1d``'s convention) of ``(..., T)``
    signals with ``(K, L)`` kernels by fp32 FFTs: ``(..., K, T - L + 1)``."""
    kernels = torch.as_tensor(kernels, device=x.device)
    T, L = x.shape[-1], kernels.shape[-1]
    n = _next_pow2(T)
    X = torch.fft.rfft(x, n=n)
    H = torch.fft.rfft(kernels.flip(-1), n=n)
    return torch.fft.irfft(X[..., None, :] * H, n=n)[..., L - 1 : T]


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


def _auto_block(overlap: int, scale: int, lo: int, hi: int) -> int:
    """Overlap-save block size: ``next_pow2(scale * overlap)`` clamped to
    ``[lo, hi]``, or ``None`` (one full-length FFT) when that block does
    not exceed twice the overlap. The JAX package's rule, kept so both
    packages take the same route."""
    bs = min(max(_next_pow2(max(1, scale * overlap)), lo), hi)
    return bs if bs > 2 * overlap else None


def overlap_save_valid(x: torch.Tensor, kernels: torch.Tensor, nfft: int,
                       correlate: bool = True) -> torch.Tensor:
    """Valid-mode overlap-save convolution in ``nfft``-point blocks.

    Returns full-convolution indices ``[L - 1 : T]`` of ``(..., T)`` signals
    against ``(..., L)`` kernels whose leading dims broadcast against the
    signal's. ``correlate=True`` flips the kernels (``conv1d``'s
    convention).
    """
    L = kernels.shape[-1]
    if nfft <= L - 1:
        raise ValueError(f"nfft ({nfft}) must exceed kernel overlap ({L - 1})")
    hop = nfft - (L - 1)
    T = x.shape[-1]
    n_out = T - (L - 1)
    nblk = -(-n_out // hop)
    total = (nblk - 1) * hop + nfft
    blocks = F.pad(x, (0, max(0, total - T))).unfold(-1, nfft, hop)  # (..., nblk, nfft)
    k = kernels.flip(-1) if correlate else kernels
    H = torch.fft.rfft(k[..., None, :], n=nfft)  # (..., 1, F)
    y = torch.fft.irfft(torch.fft.rfft(blocks, n=nfft) * H, n=nfft)[..., L - 1 :]
    return y.reshape(y.shape[:-2] + (nblk * hop,))[..., :n_out]


def lowpass_kernel(cutoff, zeros: int, half_size: int) -> torch.Tensor:
    """Windowed-sinc low-pass kernels over a fixed support.

    ``cutoff`` (a scalar or ``(B,)``, a fraction of the sample rate in (0,
    0.5]) gives taps ``2 c hann(2h + 1) sinc(2 pi c t)`` for ``|t| <= h``,
    ``h = floor(zeros / c / 2)``, normalized to unit sum, and zero outside;
    so any ``half_size >= h`` gives the same filter. A cutoff of at least
    0.5 gives the identity, one of at most 0 a zero kernel. Returns ``(B,
    2 half_size + 1)`` (or ``(2 half_size + 1,)`` for a scalar), fp32.
    """
    cutoff = torch.as_tensor(cutoff, dtype=torch.float32)
    scalar = cutoff.ndim == 0
    c = torch.atleast_1d(cutoff)[:, None]  # (B, 1)
    t = torch.arange(-half_size, half_size + 1, dtype=torch.float32, device=c.device)[None, :]
    h = torch.floor(torch.full_like(c, zeros) / c / 2.0)  # per-item half support
    inside = t.abs() <= h
    # hann_window(2h + 1, periodic=False) centered: cos^2(pi t / (2h))
    window = torch.cos(math.pi * t / (2.0 * torch.clamp(h, min=1.0))) ** 2
    arg = 2.0 * c * math.pi * t
    sinc = torch.where(arg.abs() < 1e-8, 1.0, torch.sin(arg) / torch.where(arg == 0, 1.0, arg))
    kernel = torch.where(inside, 2.0 * c * window * sinc, 0.0)
    kernel = kernel / kernel.sum(-1, keepdim=True)
    kernel = torch.where(c >= 0.5, (t == 0).to(kernel.dtype), kernel)
    kernel = torch.where(c <= 0.0, 0.0, kernel)
    return kernel[0] if scalar else kernel


def low_pass(audio: torch.Tensor, cutoffs, sample_rate: int, zeros: int = 51,
             min_cutoff_hz: float = 40.0, block_size="auto") -> torch.Tensor:
    """Low-pass ``(B, C, T)`` audio with per-item cutoffs in Hz (a scalar or
    ``(B,)``), replicate-padded at both ends.

    Cutoffs below ``min_cutoff_hz`` are raised to it; the sinc support is
    sized by the smallest cutoff given (read on the host), so it is as
    short as the cutoffs allow. ``block_size``: ``"auto"`` convolves in
    overlap-save blocks when the kernel is short enough for them to pay
    (``_auto_block``), ``None`` by one full-length FFT, an int in blocks of
    that size.
    """
    B, C, T = audio.shape
    c_in = torch.as_tensor(cutoffs, dtype=torch.float32)
    min_cutoff_hz = max(min_cutoff_hz, min(float(c_in.min()), sample_rate / 2))
    c = torch.atleast_1d(c_in).reshape(-1).to(audio.device).expand(B)
    c = torch.clamp(c, min=min_cutoff_hz) / sample_rate
    half = max(1, int(zeros / (min_cutoff_hz / sample_rate) / 2))
    kernels = lowpass_kernel(c, zeros, half)  # (B, 2 half + 1)
    x = _edge_pad(audio, half)
    L = kernels.shape[-1]
    if block_size == "auto":
        block_size = _auto_block(L - 1, 8, 4096, 32768)
    if block_size is not None and block_size > 2 * (L - 1):
        return overlap_save_valid(x, kernels[:, None, :], block_size)[..., :T]
    return _fft_conv_valid(x, kernels)[..., :T]


def high_pass(audio: torch.Tensor, cutoffs, sample_rate: int, zeros: int = 51,
              min_cutoff_hz: float = 40.0, block_size="auto") -> torch.Tensor:
    """High-pass: the audio less its :func:`low_pass`."""
    return audio - low_pass(audio, cutoffs, sample_rate, zeros, min_cutoff_hz, block_size)


def preemphasis(audio: torch.Tensor, coef: float = 0.85) -> torch.Tensor:
    """Pre-emphasis as a conv1d with kernel ``[1, -coef, 0]`` and padding 1
    computes it: ``y[n] = x[n - 1] - coef x[n]``, with ``x[-1] = 0``."""
    return F.pad(audio, (1, 0))[..., :-1] - coef * audio


def split_bands(audio: torch.Tensor, sample_rate: int, n_bands: int, zeros: int = 8,
                block_size="auto") -> torch.Tensor:
    """Split ``(B, C, T)`` audio into ``n_bands`` mel-spaced bands ``(B, C,
    T, n_bands)``: low-passes at the mel-spaced cutoffs, band ``i`` the
    difference of neighbouring low-passes and the last band the residual,
    so the bands sum to the input. ``block_size``: ``"auto"`` convolves in
    overlap-save blocks when they pay (``_auto_block``, the JAX package's
    rule), ``None`` by one full-length FFT, an int in blocks of that size.
    """
    if n_bands < 1:
        raise ValueError("n_bands must be >= 1")
    if n_bands == 1:
        return audio[..., None]
    half = _split_band_kernels(sample_rate, n_bands, zeros)[1]
    kernels = _split_band_tensor(sample_rate, n_bands, zeros, audio.device)
    x = _edge_pad(audio, half)
    if block_size == "auto":
        block_size = _auto_block(2 * half, 32, 16384, 65536)
    if block_size is not None and block_size > 2 * (2 * half):
        lows = overlap_save_valid(x[..., None, :], kernels, block_size)
    else:
        lows = fft_conv1d(x, kernels)
    lows = lows.movedim(-2, 0)  # (n_bands - 1, B, C, T)
    bands = [lows[0]] + [lows[i] - lows[i - 1] for i in range(1, n_bands - 1)]
    return torch.stack(bands + [audio - lows[-1]], dim=-1)


def equalizer(audio: torch.Tensor, db, sample_rate: int, zeros: int = 8,
              conv_method: str = None) -> torch.Tensor:
    """Mel-spaced graphic EQ of ``(B, C, T)`` audio: weight each band by
    ``10 ** db`` (``db``: ``(n_bands,)``, ``(1, n_bands)`` or ``(B,
    n_bands)``) and sum.

    With bands ``b_0 = lp_0``, ``b_i = lp_i - lp_{i-1}``, ``b_{n-1} = x -
    lp_{n-2}``, the weighted sum telescopes to ``w_{n-1} x + x * sum_i (w_i
    - w_{i+1}) k_i``: one per-item FIR. ``conv_method`` (the JAX package's
    names): ``"pallas"`` runs it through kernel A (its plain version for a
    CPU tensor), ``"pallas_interpret"`` through kernel A's plain version,
    ``"fft"`` by FFT convolution (overlap-save where it pays); ``None``
    takes kernel A. A FIR longer than ``hopper_kernels.MAX_TAPS_BATCH``
    taps always goes by FFT.
    """
    if conv_method not in CONV_METHODS:
        raise ValueError(f"conv_method must be one of {CONV_METHODS}, got {conv_method!r}")
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
    if conv_method != "fft" and L <= hopper_kernels.MAX_TAPS_BATCH:
        # full-convolution index t + L - 1 is the causal conv of the padded
        # signal with the reversed kernel at time t + L - 1
        fir = (hopper_kernels.fir_causal_batch_plain if conv_method == "pallas_interpret"
               else hopper_kernels.fir_causal_batch)
        B_, C_, Tp = x.shape
        g = combined.flip(-1)
        if g.shape[0] == 1 and B_ > 1:  # one curve for the whole batch
            g = g.expand(B_, -1)
        if C_ > 1:
            g = g.repeat_interleave(C_, dim=0)
        y = fir(x.reshape(B_ * C_, Tp), g.contiguous())
        y = y.reshape(B_, C_, Tp)[..., L - 1 :]
    else:
        block = _auto_block(L - 1, 8, 4096, 32768)
        if block is not None:
            y = overlap_save_valid(x, combined[:, None, :], block)
        else:
            y = _fft_conv_valid(x, combined)
    return weights[:, -1, None, None] * audio + y[..., :T]


def causal_fft_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                      block_size: int = None) -> torch.Tensor:
    """Causal convolution ``y[n] = sum_k h[k] x[n - k]`` of ``(..., T)``
    signals with one ``(L,)`` kernel, truncated to ``T``, by fp32 FFTs.
    ``block_size`` (above ``2 L``) switches to overlap-save in blocks of
    that power-of-two size."""
    T = x.shape[-1]
    L = kernel.shape[-1]
    if block_size is not None and block_size > 2 * L:
        return _causal_overlap_save(x, kernel, block_size)
    n = _next_pow2(T + L)
    y = torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(kernel, n=n), n=n)
    return y[..., :T]


def _causal_overlap_save(x: torch.Tensor, kernel: torch.Tensor, nfft: int) -> torch.Tensor:
    """Overlap-save causal convolution with ``nfft``-point blocks."""
    T = x.shape[-1]
    L = kernel.shape[-1]
    hop = nfft - (L - 1)
    nblk = -(-T // hop)
    xf = x.reshape(-1, T)
    # block b reads x[b hop - (L - 1) : b hop + hop]: front-pad with the
    # causal history, tail-pad to the block grid
    total = (nblk - 1) * hop + nfft
    xp = F.pad(xf, (L - 1, max(0, total - T - (L - 1))))
    blocks = xp.unfold(-1, nfft, hop)  # (B, nblk, nfft)
    Y = torch.fft.rfft(blocks, n=nfft) * torch.fft.rfft(kernel, n=nfft)
    y = torch.fft.irfft(Y, n=nfft)[..., L - 1 :]  # each block's hop valid samples
    return y.reshape(xf.shape[0], -1)[:, :T].reshape(x.shape)


def biquad(x: torch.Tensor, b, a) -> torch.Tensor:
    """Exact biquad over the last axis of ``x``: ``b`` and ``a`` are 3
    host coefficients (normalized by ``a[0]``) of a stable filter.
    :func:`biquad_cascade` of one stage."""
    return biquad_cascade(x, [(b, a, 1.0)])


def biquad_cascade(x: torch.Tensor, coeffs) -> torch.Tensor:
    """The ``(b, a, gain)`` biquad stages applied in turn, as one
    :func:`iir_cascade_blocked` of the whole cascade run in float64 and
    returned in ``x``'s dtype. For poles near the unit circle (the
    K-weighting high-pass) a log-depth scan over the 2 x 2 state recurrence
    misses a float64 ``lfilter`` by 4e-3 in fp32, and the blocked form's
    fp32 products by ~5e-5 of the level, which the card and the CPU then
    round differently; in float64 the products add no error of their own.
    On the card the cascade holds at most 8 stages (kernel F's limit of
    ``hopper_kernels.MAX_SCAN_STATES`` = 16 states, 2 a stage); more raise."""
    return iir_cascade_blocked(x.double(), coeffs).to(x.dtype)


def fir_from_biquad(b, a, n_taps: int) -> np.ndarray:
    """Truncated impulse response ``(n_taps,)`` float32 of a biquad
    (host-side design)."""
    from scipy.signal import lfilter

    impulse = np.zeros(n_taps)
    impulse[0] = 1.0
    return lfilter(b, a, impulse).astype(np.float32)


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
def _iir_operators_on(stages_key: tuple, block: int, device: torch.device,
                      dtype: torch.dtype = torch.float32):
    """Transposed device copies ``(Phi_x^T, Phi_s^T, Psi_x^T, (A^L)^T)`` in
    ``dtype``."""
    return tuple(torch.from_numpy(m.T.copy()).to(device=device, dtype=dtype)
                 for m in _blocked_iir_operators(stages_key, block))


def iir_cascade_blocked(x: torch.Tensor, stages, block: int = 512) -> torch.Tensor:
    """Exact biquad-cascade filtering of ``(..., T)`` audio by block
    state-space lifting. ``stages``: ``(b, a, gain)`` triples.

    The block-state recurrence is sequential over blocks (kernel F,
    ``hopper_kernels.iir_block_scan``, on the card): a tree scan would form
    explicit f32 powers of ``A^L`` and amplify rounding. On the card a
    cascade has at most ``hopper_kernels.MAX_SCAN_STATES`` states (2 a
    stage).
    """
    stages_key = tuple(
        (tuple(float(v) for v in b), tuple(float(v) for v in a), float(g))
        for b, a, g in stages
    )
    phi_x_t, phi_s_t, psi_x_t, a_l_t = _iir_operators_on(stages_key, block, x.device, x.dtype)
    T = x.shape[-1]
    batch_shape = x.shape[:-1]
    xf = F.pad(x.reshape(-1, T), (0, -T % block))
    rows = xf.shape[0]
    xb = xf.reshape(rows, -1, block)  # (B, nblk, L)
    with strict_fp32():
        part = xb @ phi_x_t  # in-block response to the block's own input
        u = xb @ psi_x_t  # (B, nblk, ns): each block's input term of the next state
        s_pre = hopper_kernels.iir_block_scan(u, a_l_t)  # state before each block
        y = part + s_pre @ phi_s_t
    return y.reshape(rows, -1)[:, :T].reshape(batch_shape + (T,))
