"""Framed Fourier transforms on tensors: matmul STFT / iSTFT and mel.

Counterpart of ``audiotools_tpu/ops/fft.py`` for the augmentation path.
The analysis and synthesis DFTs are matmuls against window-fused real-DFT
matrices designed on the host in float64 (the same numpy designs as the
JAX package). ``stft`` runs in full fp32; ``istft`` in fp32
(``"matmul"``) or with bf16 operands and fp32 accumulation
(``"matmul_bf16"``: the spectrum and the matrices are rounded to bf16 and
the product is summed in fp32, as a bf16 matrix unit computes it).
"""
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ._fp32 import strict_fp32

__all__ = [
    "get_window",
    "compute_stft_padding",
    "default_win_length",
    "stft",
    "istft",
    "mel_filters",
    "mel_spectrogram",
]


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
    ``Re(S) @ Ci + Im(S) @ Si == irfft(S) * w``."""
    w = get_window(window_type, n_fft).astype(np.float64)
    k = np.arange(n_fft // 2 + 1)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    scale = np.full((n_fft // 2 + 1, 1), 2.0)
    scale[0] = 1.0
    if n_fft % 2 == 0:
        scale[-1] = 1.0
    return (
        (scale * np.cos(ang) * w[None, :] / n_fft).astype(np.float32),
        (-scale * np.sin(ang) * w[None, :] / n_fft).astype(np.float32),
    )


@functools.lru_cache(maxsize=32)
def _on_device(design, args: tuple, device: torch.device):
    """Device copies of a cached host design, made once per device."""
    return tuple(torch.from_numpy(m).to(device) for m in design(*args))


def _pad(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad the last axis of ``(B, T)``; ``mode`` as ``F.pad`` takes it."""
    return F.pad(x[:, None], (left, right), mode=mode)[:, 0]


def stft(audio: torch.Tensor, window_length: int, hop_length: int,
         window_type: str = "hann", match_stride: bool = False,
         padding_type: str = "reflect", method: str = "matmul") -> torch.Tensor:
    """Short-time Fourier transform of ``(..., T)`` audio.

    Returns complex64 ``(..., n_freq, n_frames)`` (``torch.stft(center=True)``
    framing). The result is a transposed view of a time-major ``(...,
    n_frames, n_freq)`` tensor, the layout the phase vocoder reads.
    """
    if method != "matmul":
        raise NotImplementedError(
            f"stft method {method!r} is not ported yet (ROADMAP.md, Queue 1: ops/fft.py)"
        )
    length = audio.shape[-1]
    right_pad, pad = compute_stft_padding(length, window_length, hop_length, match_stride)
    batch_shape = audio.shape[:-1]
    x = audio.reshape(-1, length)
    if pad + right_pad > 0:
        x = _pad(x, pad, pad + right_pad, padding_type)
    cpad = window_length // 2
    x = _pad(x, cpad, cpad, "reflect")

    frames = _frame(x, window_length, hop_length)  # (B, n_frames, n_fft)
    C, S = _on_device(_dft_matrices, (window_type, window_length), x.device)
    with strict_fp32():
        spec = torch.complex(frames @ C, frames @ S)  # (B, n_frames, n_freq)
    spec = spec.transpose(-1, -2)
    if match_stride:
        spec = spec[..., 2:-2]
    return spec.reshape(batch_shape + spec.shape[1:])


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


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
          method: str = "matmul") -> torch.Tensor:
    """Inverse STFT of ``(..., n_freq, n_frames)`` complex data: windowed
    overlap-add with window-square normalization (``torch.istft``
    semantics), center padding trimmed, cut to ``length``.

    ``method="matmul"`` is fp32; ``"matmul_bf16"`` rounds the spectrum and
    the iDFT matrices to bf16 and accumulates in fp32.
    """
    if method not in ("matmul", "matmul_bf16"):
        raise NotImplementedError(
            f"istft method {method!r} is not ported yet (ROADMAP.md, Queue 1: ops/fft.py)"
        )
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
    spec = stft_data.reshape(-1, nf, nt)
    if match_stride:
        spec = F.pad(spec, (2, 2))
        nt = nt + 4

    out_len = window_length + hop_length * (nt - 1)
    Ci, Si = _on_device(_idft_matrices, (window_type, window_length), spec.device)
    S = spec.transpose(-1, -2)  # (B, nt, n_freq)
    re, im = S.real, S.imag
    if method == "matmul_bf16":
        re, im, Ci, Si = _bf16(re), _bf16(im), _bf16(Ci), _bf16(Si)
    with strict_fp32():
        frames = re @ Ci + im @ Si  # (B, nt, n_fft), window applied
    y = _overlap_add(frames, hop_length, out_len)
    (inv_env,) = _on_device(
        _inverse_envelope, (window_type, window_length, hop_length, nt), y.device
    )
    y = y * inv_env

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
                    method: str = "matmul") -> torch.Tensor:
    """Mel spectrogram ``(..., n_mels, n_frames)``: ``|STFT|`` projected on
    the mel basis in fp32."""
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
