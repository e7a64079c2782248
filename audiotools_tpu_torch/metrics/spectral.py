"""Spectral losses over AudioSignals: multi-scale STFT, multi-scale mel
and magnitude-weighted phase.

Counterpart of ``audiotools_tpu/metrics/spectral.py``. The STFT and mel
losses analyse with ``stft_method="matmul"`` by default, as the JAX
package does: window-fused DFT matrices in full fp32 (``ops.fft.stft``).
``stft_method`` takes every method of ``ops.fft.stft``: ``"fft"``, or
``"matmul_bf16"`` (frames and matrices rounded to bf16, summed in fp32;
within 2^-8 of the fp32 spectrum's scale) for loss stacks that tolerate
bf16 magnitudes.
"""
from typing import List

import numpy as np
import torch

from ..core import AudioSignal
from ..core.signal import STFTParams
from .distance import l1_loss

__all__ = ["MultiScaleSTFTLoss", "MelSpectrogramLoss", "PhaseLoss"]


def _make_scales(window_lengths, match_stride, window_type):
    """One STFTParams per analysis scale, hop = window / 4."""
    return [STFTParams(w, w // 4, window_type, match_stride) for w in window_lengths]


class _ScaledSpectralLoss:
    """Skeleton of the multi-scale losses: per scale, compare a spectral
    feature ``f`` of x and y as ``log_weight * L(log10(clamp(f) ** pow)) +
    mag_weight * L(f)``, summed over the scales."""

    def _compare(self, x_feat, y_feat):
        log_term = self.loss_fn(
            torch.log10(x_feat.clamp(min=self.clamp_eps) ** self.pow),
            torch.log10(y_feat.clamp(min=self.clamp_eps) ** self.pow),
        )
        return self.log_weight * log_term + self.mag_weight * self.loss_fn(x_feat, y_feat)

    def __call__(self, x: AudioSignal, y: AudioSignal):
        return sum(self._compare(*feats) for feats in self._features(x, y))

    def forward(self, x, y):
        return self(x, y)


class MultiScaleSTFTLoss(_ScaledSpectralLoss):
    """Multi-scale STFT magnitude loss (DDSP style)."""

    def __init__(self, window_lengths: List[int] = [2048, 512], loss_fn=l1_loss,
                 clamp_eps: float = 1e-5, mag_weight: float = 1.0, log_weight: float = 1.0,
                 pow: float = 2.0, weight: float = 1.0, match_stride: bool = False,
                 window_type: str = None, stft_method: str = "matmul"):
        self.stft_params = _make_scales(window_lengths, match_stride, window_type)
        self.loss_fn = loss_fn
        self.log_weight, self.mag_weight = log_weight, mag_weight
        self.clamp_eps, self.pow = clamp_eps, pow
        self.weight = weight
        self.stft_method = stft_method

    def _features(self, x, y):
        for s in self.stft_params:
            x.stft(s.window_length, s.hop_length, s.window_type, method=self.stft_method)
            y.stft(s.window_length, s.hop_length, s.window_type, method=self.stft_method)
            yield x.magnitude, y.magnitude


class MelSpectrogramLoss(_ScaledSpectralLoss):
    """Multi-scale mel-spectrogram loss."""

    def __init__(self, n_mels: List[int] = [150, 80], window_lengths: List[int] = [2048, 512],
                 loss_fn=l1_loss, clamp_eps: float = 1e-5, mag_weight: float = 1.0,
                 log_weight: float = 1.0, pow: float = 2.0, weight: float = 1.0,
                 match_stride: bool = False, mel_fmin: List[float] = [0.0, 0.0],
                 mel_fmax: List[float] = [None, None], window_type: str = None,
                 stft_method: str = "matmul"):
        self.stft_params = _make_scales(window_lengths, match_stride, window_type)
        self.n_mels = n_mels
        self.loss_fn = loss_fn
        self.log_weight, self.mag_weight = log_weight, mag_weight
        self.clamp_eps, self.pow = clamp_eps, pow
        self.weight = weight
        self.mel_fmin, self.mel_fmax = mel_fmin, mel_fmax
        self.stft_method = stft_method

    def _features(self, x, y):
        for n_mels, fmin, fmax, s in zip(self.n_mels, self.mel_fmin, self.mel_fmax,
                                         self.stft_params):
            kwargs = dict(mel_fmin=fmin, mel_fmax=fmax, window_length=s.window_length,
                          hop_length=s.hop_length, window_type=s.window_type,
                          method=self.stft_method)
            yield x.mel_spectrogram(n_mels, **kwargs), y.mel_spectrogram(n_mels, **kwargs)


class PhaseLoss:
    """Magnitude-weighted circular phase difference (``"fft"`` STFT)."""

    def __init__(self, window_length: int = 2048, hop_length: int = 512, weight: float = 1.0):
        self.weight = weight
        self.stft_params = STFTParams(window_length, hop_length)

    def __call__(self, x: AudioSignal, y: AudioSignal):
        s = self.stft_params
        x.stft(s.window_length, s.hop_length, s.window_type)
        y.stft(s.window_length, s.hop_length, s.window_type)

        # circular difference, with the original library's quirk kept: the
        # > pi branch adds 2 pi instead of subtracting it
        diff = x.phase - y.phase
        diff = torch.where(diff < -np.pi, diff + 2 * np.pi, diff)
        diff = torch.where(diff > np.pi, diff + 2 * np.pi, diff)

        # the true magnitude scaled to weights in [0, 1]
        x_mag = x.magnitude
        x_min, x_max = x_mag.min(), x_mag.max()
        weights = (x_mag - x_min) / (x_max - x_min)
        return ((weights * diff) ** 2).mean()

    forward = __call__
