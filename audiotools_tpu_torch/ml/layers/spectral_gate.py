"""Spectral-gating noise reduction: noise statistics per frequency, a
threshold, a smoothed binary mask and the masked inverse STFT.

Counterpart of ``audiotools_tpu/ml/layers/spectral_gate.py``.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core import util
from ...core.signal import AudioSignal, STFTParams
from ...ops._fp32 import strict_fp32


def _triangle(n: int) -> np.ndarray:
    """``n + 2`` ramp steps up and down, without the zero ends."""
    return np.concatenate([np.linspace(0, 1, n + 2)[:-1], np.linspace(1, 0, n + 2)])[1:-1]


class SpectralGate(nn.Module):
    """Spectral gate for noise reduction.

    Parameters
    ----------
    n_freq : int
        Frequency bins to smooth the mask by, default 3.
    n_time : int
        Frames to smooth the mask by, default 5.
    """

    def __init__(self, n_freq: int = 3, n_time: int = 5):
        super().__init__()
        smoothing = np.outer(_triangle(n_freq), _triangle(n_time))
        smoothing = smoothing / smoothing.sum()
        self.register_buffer(
            "smoothing_filter", torch.from_numpy(smoothing[None, None].astype(np.float32)))

    @staticmethod
    def _fresh_stft(signal: AudioSignal, params: STFTParams) -> AudioSignal:
        """A clone with the gate's analysis parameters and no cached STFT."""
        out = signal.clone()
        out.stft_data = None
        out.stft_params = params
        return out

    def forward(self, audio_signal: AudioSignal, nz_signal: AudioSignal,
                denoise_amount=1.0, n_std: float = 3.0, win_length: int = 2048,
                hop_length: int = 512) -> AudioSignal:
        """Denoise ``audio_signal`` by the statistics of ``nz_signal``: a
        cell whose level lies below the noise's mean plus ``n_std`` standard
        deviations (per frequency) is attenuated by ``denoise_amount`` (per
        item), through a mask smoothed over frequency and time."""
        stft_params = STFTParams(win_length, hop_length, "sqrt_hann")
        audio_signal = self._fresh_stft(audio_signal, stft_params)
        nz_signal = self._fresh_stft(nz_signal, stft_params)

        nz_stft_db = 20 * torch.log10(torch.clamp(nz_signal.magnitude, min=1e-4))
        nz_thresh = (nz_stft_db.mean(dim=-1, keepdim=True)
                     + nz_stft_db.std(dim=-1, correction=0, keepdim=True) * n_std)

        stft_db = 20 * torch.log10(torch.clamp(audio_signal.magnitude, min=1e-4))
        nb, nac, nf, nt = stft_db.shape
        stft_mask = (stft_db < nz_thresh.expand(nb, nac, nf, nt)).float()

        smoothing = self.smoothing_filter.to(stft_mask.device)
        pad = (smoothing.shape[-2] // 2, smoothing.shape[-1] // 2)
        with strict_fp32():
            stft_mask = F.conv2d(stft_mask.reshape(nb * nac, 1, nf, nt), smoothing, padding=pad)
        stft_mask = stft_mask.reshape(nb, nac, nf, nt)
        stft_mask = stft_mask * util.ensure_tensor(denoise_amount, ndim=stft_mask.ndim,
                                                   device=stft_mask.device)
        stft_mask = 1 - stft_mask

        audio_signal.stft_data = audio_signal.stft_data * stft_mask
        audio_signal.istft()
        return audio_signal
