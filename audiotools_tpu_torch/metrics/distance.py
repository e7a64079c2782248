"""Waveform distance losses over AudioSignals or tensors.

Counterpart of ``audiotools_tpu/metrics/distance.py``.
"""
import torch

from ..core import AudioSignal

__all__ = ["L1Loss", "SISDRLoss", "l1_loss", "sisdr_loss"]


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


class L1Loss:
    """L1 loss between an attribute (default ``audio_data``) of two
    AudioSignals, or between two tensors; ``weight`` is its weight in a
    sum of losses."""

    def __init__(self, attribute: str = "audio_data", weight: float = 1.0):
        self.attribute = attribute
        self.weight = weight

    def __call__(self, x, y):
        if isinstance(x, AudioSignal):
            x = getattr(x, self.attribute)
            y = getattr(y, self.attribute)
        return l1_loss(x, y)

    forward = __call__


def sisdr_loss(references: torch.Tensor, estimates: torch.Tensor, scaling: bool = True,
               reduction: str = "mean", zero_mean: bool = True,
               clip_min: float = None) -> torch.Tensor:
    """Negative scale-invariant SDR of ``estimates`` against ``references``
    per item, reduced by ``"mean"``, ``"sum"`` or not at all."""
    eps = 1e-8
    nb = references.shape[0]
    references = references.reshape(nb, 1, -1).transpose(1, 2)
    estimates = estimates.reshape(nb, 1, -1).transpose(1, 2)

    if zero_mean:
        references = references - references.mean(dim=1, keepdim=True)
        estimates = estimates - estimates.mean(dim=1, keepdim=True)

    references_projection = (references ** 2).sum(dim=-2) + eps
    references_on_estimates = (estimates * references).sum(dim=-2) + eps
    scale = (references_on_estimates / references_projection)[:, None] if scaling else 1

    e_true = scale * references
    e_res = estimates - e_true
    signal = (e_true ** 2).sum(dim=1)
    noise = (e_res ** 2).sum(dim=1)
    sdr = -10 * torch.log10(signal / noise + eps)

    if clip_min is not None:
        sdr = sdr.clamp(min=clip_min)
    if reduction == "mean":
        sdr = sdr.mean()
    elif reduction == "sum":
        sdr = sdr.sum()
    return sdr


class SISDRLoss:
    """Scale-invariant source-to-distortion ratio loss between two
    AudioSignals (``x`` the reference) or two tensors."""

    def __init__(self, scaling: bool = True, reduction: str = "mean", zero_mean: bool = True,
                 clip_min: float = None, weight: float = 1.0):
        self.scaling = scaling
        self.reduction = reduction
        self.zero_mean = zero_mean
        self.clip_min = clip_min
        self.weight = weight

    def __call__(self, x, y):
        if isinstance(x, AudioSignal):
            x, y = x.audio_data, y.audio_data
        return sisdr_loss(x, y, scaling=self.scaling, reduction=self.reduction,
                          zero_mean=self.zero_mean, clip_min=self.clip_min)

    forward = __call__
