"""Polyphase windowed-sinc resampling.

Counterpart of ``audiotools_tpu/ops/resample.py``. After reducing
``old_sr / new_sr`` by their gcd, output sample ``j`` lands at input
position ``j * old / new``, so the interpolation is ``new`` polyphase FIR
kernels applied with stride ``old``: one strided ``conv1d`` on the device
(full fp32), or a numpy evaluation of the same bank on the host.
"""
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ._fp32 import strict_fp32

__all__ = ["resample_kernels", "resample"]


@functools.lru_cache(maxsize=None)
def resample_kernels(old_sr: int, new_sr: int, zeros: int = 24, rolloff: float = 0.945):
    """Polyphase kernel bank ``(new_sr, width*2 + old_sr)`` and ``width``.
    ``old_sr``/``new_sr`` must be coprime. Each phase is a Hann^2-windowed
    sinc at cutoff ``rolloff * min(old, new)``, normalized to unit sum."""
    if math.gcd(old_sr, new_sr) != 1:
        raise ValueError(f"rates must be reduced by their gcd, got {old_sr}/{new_sr}")
    sr = min(new_sr, old_sr) * rolloff
    width = math.ceil(zeros * old_sr / sr)
    idx = np.arange(-width, width + old_sr, dtype=np.float64)
    kernels = []
    for i in range(new_sr):
        t = (-i / new_sr + idx / old_sr) * sr
        t = np.clip(t, -zeros, zeros)
        t *= np.pi
        window = np.cos(t / zeros / 2) ** 2
        sinc = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
        kernel = sinc * window
        kernel /= kernel.sum()
        kernels.append(kernel)
    return np.stack(kernels).astype(np.float32), width


def _resample_host_impl(audio: np.ndarray, old: int, new: int,
                        kernels: np.ndarray, width: int) -> np.ndarray:
    """Numpy evaluation of the bank for the host data path."""
    T = audio.shape[-1]
    batch_shape = audio.shape[:-1]
    x = audio.reshape((-1, T)).astype(np.float32)
    x = np.pad(x, ((0, 0), (width, width + old)), mode="edge")
    W = kernels.shape[-1]
    n_blocks = (x.shape[-1] - W) // old + 1
    s0, s1 = x.strides
    frames = np.lib.stride_tricks.as_strided(
        x, shape=(x.shape[0], n_blocks, W), strides=(s0, s1 * old, s1), writeable=False,
    )
    y = np.einsum("btw,pw->btp", frames, kernels).reshape((x.shape[0], -1))
    out_len = int(T * new / old)
    return y[..., :out_len].reshape(batch_shape + (out_len,))


@functools.lru_cache(maxsize=32)
def _bank(old: int, new: int, zeros: int, rolloff: float, device: torch.device):
    kernels, _ = resample_kernels(old, new, zeros, rolloff)
    return torch.from_numpy(kernels)[:, None, :].to(device)  # (new, 1, W)


def resample(audio, old_sr: int, new_sr: int, zeros: int = 24, rolloff: float = 0.945):
    """Resample ``(..., T)`` audio to ``int(T * new_sr / old_sr)`` samples.

    A numpy array is resampled on the host and stays numpy; a tensor goes
    through replicate-edge padding and one stride-``old`` ``conv1d``
    against the bank, whose ``new`` output channels interleave into the
    output phases.
    """
    if old_sr == new_sr:
        return audio
    gcd = math.gcd(int(old_sr), int(new_sr))
    old, new = int(old_sr) // gcd, int(new_sr) // gcd
    kernels, width = resample_kernels(old, new, zeros, rolloff)
    if isinstance(audio, np.ndarray):
        return _resample_host_impl(audio, old, new, kernels, width)

    T = audio.shape[-1]
    batch_shape = audio.shape[:-1]
    x = audio.reshape(-1, 1, T).float()
    xp = F.pad(x, (width, width + old), mode="replicate")
    with strict_fp32():
        y = F.conv1d(xp, _bank(old, new, int(zeros), float(rolloff), x.device), stride=old)
    # interleave phases: out[p * new + i] = y[:, i, p]
    out_len = int(T * new / old)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)[:, :out_len]
    return y.reshape(batch_shape + (out_len,))
