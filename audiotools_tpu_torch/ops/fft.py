"""Framed Fourier transforms on tensors: STFT / iSTFT and mel.

Counterpart of ``audiotools_tpu/ops/fft.py``. ``method="fft"`` (the
default, as in the JAX package) runs ``torch.fft`` on the windowed frames
in fp32. ``"matmul"`` evaluates the DFTs as matmuls against window-fused
real-DFT matrices designed on the host in float64 (the same numpy designs
as the JAX package), in full fp32. ``"matmul_bf16"`` rounds the operands
(frames or spectrum, and the matrices) to bf16 and sums the product in
fp32, as a bf16 matrix unit computes it, in both directions. On the card
the bf16 synthesis is one tensor-core product of the bf16 operands with
fp32 sums and an fp32 result, unless autograd records through it
(``BF16_SYNTHESIS_GEMMS`` counts those products). The synthesis also
takes ``"matmul_bf16_fused"``, the same numerics through kernel E
(``hopper_kernels.istft_synthesis_fused``), which never builds the frame
tensor, and ``"matmul_bf16_fused_interpret"``, the JAX package's name for
the kernel off its hardware, which runs E's plain version.
"""
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import hopper_kernels
from ._fp32 import strict_fp32

__all__ = [
    "get_window",
    "compute_stft_padding",
    "num_frames",
    "default_win_length",
    "stft",
    "istft",
    "mel_filters",
    "mel_spectrogram",
    "dct_matrix",
    "mfcc",
    "log_magnitude",
]


_STFT_METHODS = ("fft", "matmul", "matmul_bf16")

# calls of istft(method="matmul_bf16") that took the tensor-core product
BF16_SYNTHESIS_GEMMS = 0


def default_win_length(sample_rate: int) -> int:
    """``2 ** ceil(log2(0.032 * sr))``."""
    return int(2 ** (np.ceil(np.log2(0.032 * sample_rate))))


@functools.lru_cache(maxsize=None)
def get_window(window_type: str, window_length: int) -> np.ndarray:
    """Periodic window (scipy semantics, plus ``"average"`` and
    ``"sqrt_hann"``) as float32 numpy."""
    from scipy import signal

    if window_type == "average":
        window = np.ones(window_length) / window_length
    elif window_type == "sqrt_hann":
        window = np.sqrt(signal.get_window("hann", window_length))
    else:
        window = signal.get_window(window_type, window_length)
    return window.astype(np.float32)


def compute_stft_padding(length: int, window_length: int, hop_length: int,
                         match_stride: bool):
    """``(right_pad, pad)`` applied around the audio before the STFT."""
    if not match_stride:
        return 0, 0
    if hop_length != window_length // 4:
        raise ValueError("match_stride assumes hop_length == window_length // 4")
    right_pad = math.ceil(length / hop_length) * hop_length - length
    return right_pad, (window_length - hop_length) // 2


def num_frames(length: int, window_length: int, hop_length: int,
               match_stride: bool = False) -> int:
    """Number of STFT frames of a signal of ``length`` samples."""
    right_pad, pad = compute_stft_padding(length, window_length, hop_length, match_stride)
    nt = 1 + (length + 2 * pad + right_pad) // hop_length
    return nt - 4 if match_stride else nt


def _frame(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """``(..., T) -> (..., n_frames, frame_length)`` as a strided view."""
    return x.unfold(-1, frame_length, hop_length)


def _overlap_add(frames: torch.Tensor, hop_length: int, out_len: int) -> torch.Tensor:
    """Overlap-add ``(B, n_frames, L)`` frames into ``(B, out_len)``. When
    the hop divides ``L`` the frames fall into ``L // hop`` groups of
    non-overlapping frames, each added as one contiguous slice."""
    B, nt, L = frames.shape
    y = frames.new_zeros(B, out_len)
    if L % hop_length == 0:
        r = L // hop_length
        for j in range(min(r, nt)):
            flat = frames[:, j::r, :].reshape(B, -1)
            y[:, j * hop_length : j * hop_length + flat.shape[1]] += flat
        return y
    idx = (torch.arange(nt, device=frames.device)[:, None] * hop_length
           + torch.arange(L, device=frames.device)[None, :]).reshape(-1)
    return y.index_add_(1, idx, frames.reshape(B, -1))


@functools.lru_cache(maxsize=None)
def _dft_matrices(window_type: str, n_fft: int):
    """Window-fused real-DFT matrices ``(n_fft, n_freq)``: ``frames @ C +
    1j * frames @ S == rfft(frames * w)``."""
    w = get_window(window_type, n_fft).astype(np.float64)
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    return (
        (np.cos(ang) * w[:, None]).astype(np.float32),
        (np.sin(ang) * w[:, None]).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _idft_matrices(window_type: str, n_fft: int):
    """Window-fused inverse real-DFT matrices ``(n_freq, n_fft)``:
    ``Re(S) @ Ci + Im(S) @ Si == irfft(S) * w``.

    Assembled in f32 as the JAX package assembles them for its matmul
    iSTFTs (``_idft_matrices_device``): the float64 columns ``n =
    0..n_fft/2`` cast to f32, mirrored for the other half (``sin`` with a
    sign flip), times the f32 window. They differ from a float64 design cast
    once by an f32 ulp here and there; the same f32 values round to the same
    bf16 values, which the bf16 synthesis needs to agree with the JAX
    package's.
    """
    k = np.arange(n_fft // 2 + 1)[:, None]
    n = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    scale = np.full((n_fft // 2 + 1, 1), 2.0)
    scale[0] = 1.0
    if n_fft % 2 == 0:
        scale[-1] = 1.0
    ci = (scale * np.cos(ang) / n_fft).astype(np.float32)
    si = (-scale * np.sin(ang) / n_fft).astype(np.float32)
    w = get_window(window_type, n_fft)[None, :]
    mirror = slice(n_fft // 2 - 1, 0, -1)  # columns n_fft/2 - 1 .. 1
    return (
        np.concatenate([ci, ci[:, mirror]], axis=1) * w,
        np.concatenate([si, -si[:, mirror]], axis=1) * w,
    )


@functools.lru_cache(maxsize=32)
def _on_device(design, args: tuple, device: torch.device):
    """Device copies of a cached host design (numpy arrays or CPU tensors),
    made once per device."""
    return tuple(torch.as_tensor(m).to(device) for m in design(*args))


def _pad(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad the last axis of ``(B, T)``; ``mode`` as ``F.pad`` takes it. A
    reflection wider than the signal reflects again, as ``jnp.pad`` does
    (``F.pad`` refuses it): a clip shorter than half the window."""
    T = x.shape[-1]
    if mode == "reflect" and max(left, right) >= T:
        idx = torch.arange(-left, T + right, device=x.device)
        if T == 1:
            return x[:, torch.zeros_like(idx)]
        period = 2 * (T - 1)
        idx = idx.remainder(period)
        return x[:, torch.where(idx >= T, period - idx, idx)]
    return F.pad(x[:, None], (left, right), mode=mode)[:, 0]


def stft(audio: torch.Tensor, window_length: int, hop_length: int,
         window_type: str = "hann", match_stride: bool = False,
         padding_type: str = "reflect", method: str = "fft") -> torch.Tensor:
    """Short-time Fourier transform of ``(..., T)`` audio.

    Returns complex64 ``(..., n_freq, n_frames)`` (``torch.stft(center=True)``
    framing). The result is a transposed view of a time-major ``(...,
    n_frames, n_freq)`` tensor, the layout the phase vocoder reads.
    ``method``: ``"fft"`` (``rfft`` of the windowed frames) or ``"matmul"``
    (window-fused DFT matrices), both fp32; ``"matmul_bf16"``, the frames
    and the matrices rounded to bf16 and the products summed in fp32 (within
    2^-8 of the fp32 spectrum's scale; for loss stacks that tolerate bf16
    magnitudes), differentiable through the roundings.
    """
    if method not in _STFT_METHODS:
        raise ValueError(f"Unknown stft method: {method!r}")
    length = audio.shape[-1]
    right_pad, pad = compute_stft_padding(length, window_length, hop_length, match_stride)
    batch_shape = audio.shape[:-1]
    x = audio.reshape(-1, length)
    if pad + right_pad > 0:
        x = _pad(x, pad, pad + right_pad, padding_type)
    cpad = window_length // 2
    x = _pad(x, cpad, cpad, "reflect")

    frames = _frame(x, window_length, hop_length)  # (B, n_frames, n_fft)
    spec = _analysis(frames, window_type, method).transpose(-1, -2)
    if match_stride:
        spec = spec[..., 2:-2]
    return spec.reshape(batch_shape + spec.shape[1:])


def _analysis(frames: torch.Tensor, window_type: str, method: str) -> torch.Tensor:
    """``rfft(frames * window)`` of ``(..., n_frames, n_fft)`` frames by
    ``method`` (see :func:`stft`): complex64 ``(..., n_frames, n_freq)``.
    The single-device and the sequence-parallel STFT both call it."""
    window_length = frames.shape[-1]
    if method == "fft":
        (window,) = _on_device(_window_design, (window_type, window_length), frames.device)
        return torch.fft.rfft(frames * window, dim=-1)
    C, S = _on_device(_dft_matrices, (window_type, window_length), frames.device)
    if method == "matmul_bf16":
        frames, C, S = _bf16(frames), _bf16(C), _bf16(S)
    with strict_fp32():
        return torch.complex(frames @ C, frames @ S)


def _window_design(window_type: str, window_length: int):
    return (get_window(window_type, window_length),)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _bf16_synthesis_design(window_type: str, n_fft: int):
    """The window-fused iDFT matrices rounded to bf16 and interleaved as
    ``view_as_real`` lays out a spectrum's bins: row ``2k`` is ``Ci[k]``,
    row ``2k + 1`` is ``Si[k]``, then zero rows up to a multiple of 8 (rows
    of 16 bytes, which the tensor-core kernels take)."""
    Ci, Si = _idft_matrices(window_type, n_fft)
    n_freq = Ci.shape[0]
    w = torch.zeros(-(-2 * n_freq // 8) * 8, n_fft, dtype=torch.bfloat16)
    w[: 2 * n_freq].view(n_freq, 2, n_fft).copy_(torch.from_numpy(np.stack([Ci, Si], axis=1)))
    return (w,)


def _bf16_synthesis_operand(S: torch.Tensor, edge: int, rows: int) -> torch.Tensor:
    """The spectrum ``(B, nt, n_freq)`` rounded to bf16 in one pass, as
    ``(B * (nt + 2 * edge), rows)``: re and im interleaved (``view_as_real``),
    ``edge`` zero frames at each end and zero columns up to ``rows``."""
    B, nt, n_freq = S.shape
    a = S.new_zeros((B, nt + 2 * edge, rows), dtype=torch.bfloat16)
    a[:, edge : edge + nt, : 2 * n_freq].unflatten(-1, (n_freq, 2)).copy_(torch.view_as_real(S))
    return a.view(-1, rows)


def _bf16_synthesis_gemm(S: torch.Tensor, window_type: str, n_fft: int,
                         edge: int) -> torch.Tensor:
    """The ``matmul_bf16`` frames of a card spectrum ``(B, nt, n_freq)``
    as one bf16 tensor-core product with fp32 sums and an fp32 result: the
    interleaved operand times the interleaved weights. The products of bf16
    values are exact in fp32, so this is the emulated product of
    :func:`istft` summed in another order. Returns ``(B, nt + 2 * edge,
    n_fft)`` float32, the window applied."""
    global BF16_SYNTHESIS_GEMMS
    (w,) = _on_device(_bf16_synthesis_design, (window_type, n_fft), S.device)
    a = _bf16_synthesis_operand(S, edge, w.shape[0])
    BF16_SYNTHESIS_GEMMS += 1
    return torch.mm(a, w, out_dtype=torch.float32).view(S.shape[0], -1, n_fft)


def _synthesis_design(window_type: str, n_fft: int, hop_length: int):
    """Kernel E's bf16 weights for the window-fused iDFT matrices."""
    Ci, Si = _idft_matrices(window_type, n_fft)
    return (hopper_kernels.synthesis_weights(torch.from_numpy(Ci), torch.from_numpy(Si),
                                             hop_length),)


@functools.lru_cache(maxsize=32)
def _inverse_envelope(window_type: str, window_length: int, hop_length: int, nt: int):
    """Reciprocal of the window-square overlap-add envelope (1 where it
    vanishes), as a one-element tuple for :func:`_on_device`."""
    window = get_window(window_type, window_length)
    norm = np.zeros(window_length + hop_length * (nt - 1), dtype=np.float32)
    wsq = (window * window).astype(np.float32)
    for i in range(nt):
        norm[i * hop_length : i * hop_length + window_length] += wsq
    return (np.where(norm > 1e-11, 1.0 / np.maximum(norm, 1e-11), 1.0).astype(np.float32),)


def istft(stft_data: torch.Tensor, window_length: int, hop_length: int,
          window_type: str = "hann", match_stride: bool = False,
          length: int = None, original_length: int = None,
          method: str = "fft") -> torch.Tensor:
    """Inverse STFT of ``(..., n_freq, n_frames)`` complex data: windowed
    overlap-add with window-square normalization (``torch.istft``
    semantics), center padding trimmed, cut to ``length``.

    ``method``: ``"fft"`` (``irfft`` then the window) and ``"matmul"`` are
    fp32; ``"matmul_bf16"`` rounds the spectrum and the iDFT matrices to
    bf16 and accumulates in fp32 (one tensor-core product for a card
    spectrum that autograd does not record through, else two fp32 products
    of the rounded values); ``"matmul_bf16_fused"`` computes the same
    in one pass of kernel E when the hop divides the window into at most 8
    parts, and is ``"matmul_bf16"`` otherwise (the JAX package's rule);
    ``"matmul_bf16_fused_interpret"`` follows the same rule with E's plain
    version in the kernel's place, on the spectrum's own device.
    """
    if method not in _STFT_METHODS + ("matmul_bf16_fused", "matmul_bf16_fused_interpret"):
        raise ValueError(f"Unknown istft method: {method!r}")
    if length is None and original_length is None:
        raise ValueError("Provide either `length` or `original_length`.")
    right_pad, pad = compute_stft_padding(
        original_length if original_length is not None else length,
        window_length, hop_length, match_stride,
    )
    if length is None:
        length = original_length + 2 * pad + right_pad

    batch_shape = stft_data.shape[:-2]
    nf, nt = stft_data.shape[-2], stft_data.shape[-1]
    S = stft_data.reshape(-1, nf, nt).transpose(-1, -2)  # (B, nt, n_freq)
    edge = 2 if match_stride else 0  # match_stride's zero frames at each end

    out_len = window_length + hop_length * (nt + 2 * edge - 1)
    (inv_env,) = _on_device(
        _inverse_envelope, (window_type, window_length, hop_length, nt + 2 * edge), S.device
    )
    trim = (window_length, length, match_stride, pad, right_pad, batch_shape)
    if method.startswith("matmul_bf16_fused"):
        if window_length % hop_length == 0 and window_length // hop_length <= 8:
            (w,) = _on_device(_synthesis_design, (window_type, window_length, hop_length),
                              S.device)
            synthesis = (hopper_kernels.istft_synthesis_fused_plain
                         if method == "matmul_bf16_fused_interpret"
                         else hopper_kernels.istft_synthesis_fused)
            y = synthesis(S, w, hop_length, inv_env, edge)
            return _istft_trim(y, *trim)
        method = "matmul_bf16"
    if (method == "matmul_bf16" and S.is_cuda
            and not (torch.is_grad_enabled() and S.requires_grad)):
        frames = _bf16_synthesis_gemm(S, window_type, window_length, edge)
        y = _overlap_add(frames, hop_length, out_len) * inv_env
        return _istft_trim(y, *trim)
    if edge:
        S = F.pad(S, (0, 0, edge, edge))

    if method == "fft":
        (window,) = _on_device(_window_design, (window_type, window_length), S.device)
        frames = torch.fft.irfft(S, n=window_length, dim=-1) * window
    else:
        Ci, Si = _on_device(_idft_matrices, (window_type, window_length), S.device)
        re, im = S.real, S.imag
        if method == "matmul_bf16":
            re, im, Ci, Si = _bf16(re), _bf16(im), _bf16(Ci), _bf16(Si)
        with strict_fp32():
            frames = re @ Ci + im @ Si  # (B, nt, n_fft), window applied
    y = _overlap_add(frames, hop_length, out_len) * inv_env
    return _istft_trim(y, *trim)


def _istft_trim(y, window_length, length, match_stride, pad, right_pad, batch_shape):
    """Shared iSTFT tail: drop the center padding, cut to ``length``, undo
    the match-stride padding, restore the batch shape."""
    y = y[:, window_length // 2 :]
    if y.shape[1] < length:
        y = F.pad(y, (0, length - y.shape[1]))
    y = y[:, :length]
    if match_stride:
        y = y[:, pad : y.shape[1] - (pad + right_pad)]
    return y.reshape(batch_shape + (y.shape[-1],))


def _hz_to_mel(freq):
    """Slaney-scale Hz -> mel."""
    freq = np.asanyarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    if freq.ndim:
        log_t = freq >= min_log_hz
        mels[log_t] = min_log_mel + np.log(freq[log_t] / min_log_hz) / logstep
    elif freq >= min_log_hz:
        mels = min_log_mel + np.log(freq / min_log_hz) / logstep
    return mels


def _mel_to_hz(mels):
    """Slaney-scale mel -> Hz."""
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep * (mels[log_t] - min_log_mel))
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filters(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                fmax: float = None) -> np.ndarray:
    """Slaney-scale, slaney-normalized mel filterbank ``(n_mels, 1 + n_fft//2)``."""
    if fmax is None:
        fmax = float(sr) / 2
    fftfreqs = np.linspace(0, float(sr) / 2, 1 + n_fft // 2, endpoint=True)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def _mel_design(*args):
    return (mel_filters(*args),)


def mel_spectrogram(audio: torch.Tensor, sample_rate: int, n_mels: int = 80,
                    mel_fmin: float = 0.0, mel_fmax: float = None,
                    window_length: int = None, hop_length: int = None,
                    window_type: str = "hann", match_stride: bool = False,
                    padding_type: str = "reflect",
                    method: str = "fft") -> torch.Tensor:
    """Mel spectrogram ``(..., n_mels, n_frames)``: ``|STFT|`` (``method``
    as :func:`stft` takes it) projected on the mel basis in fp32."""
    if window_length is None:
        window_length = default_win_length(sample_rate)
    if hop_length is None:
        hop_length = window_length // 4
    spec = stft(audio, window_length, hop_length, window_type, match_stride,
                padding_type, method)
    (basis,) = _on_device(
        _mel_design, (sample_rate, window_length, n_mels, mel_fmin, mel_fmax),
        spec.device,
    )
    with strict_fp32():
        return basis @ spec.abs()


@functools.lru_cache(maxsize=None)
def dct_matrix(n_mfcc: int, n_mels: int, norm: str = "ortho") -> np.ndarray:
    """DCT-II matrix ``(n_mels, n_mfcc)`` float32, designed in float64 on
    the host (``torchaudio.functional.create_dct``'s matrix)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[:, None]
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k)  # (n_mfcc, n_mels)
    if norm is None:
        dct *= 2.0
    else:
        if norm != "ortho":
            raise ValueError(f"norm must be 'ortho' or None, got {norm!r}")
        dct[0] *= 1.0 / np.sqrt(2.0)
        dct *= np.sqrt(2.0 / n_mels)
    return dct.T.astype(np.float32)


def _dct_design(n_mfcc: int, n_mels: int, norm: str):
    """The DCT as it multiplies from the left, ``(n_mfcc, n_mels)``."""
    return (np.ascontiguousarray(dct_matrix(n_mfcc, n_mels, norm).T),)


def mfcc(audio: torch.Tensor, sample_rate: int, n_mfcc: int = 40, n_mels: int = 80,
         log_offset: float = 1e-6, **kwargs) -> torch.Tensor:
    """MFCCs ``(..., n_mfcc, n_frames)``: the DCT of ``log(mel +
    log_offset)`` (``kwargs`` as :func:`mel_spectrogram` takes them), in
    full fp32."""
    log_mel = torch.log(mel_spectrogram(audio, sample_rate, n_mels=n_mels, **kwargs) + log_offset)
    (dct_t,) = _on_device(_dct_design, (n_mfcc, n_mels, "ortho"), log_mel.device)
    with strict_fp32():
        return dct_t @ log_mel


def log_magnitude(magnitude: torch.Tensor, ref_value: float = 1.0, amin: float = 1e-5,
                  top_db: float = 80.0) -> torch.Tensor:
    """Magnitude in dB (librosa's ``amplitude_to_db``): ``10 log10(max(|x|^2,
    amin^2)) - 10 log10(max(amin^2, ref))``, floored at ``top_db`` below the
    largest value of the whole tensor."""
    amin = amin ** 2
    log_spec = 10.0 * torch.log10(torch.clamp(magnitude ** 2, min=amin))
    log_spec = log_spec - 10.0 * np.log10(np.maximum(amin, ref_value))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec
