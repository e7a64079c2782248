"""Codec training step: reconstruction (multi-scale STFT, mel and waveform)
and VQ losses, one backward pass and one optimizer update.

Counterpart of ``audiotools_tpu/models/train.py``. The JAX package's
optimizer ``optax.adamw(1e-4)`` is, in PyTorch,
``torch.optim.AdamW(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
weight_decay=1e-4)``: torch's default weight decay is 1e-2, so it must be
given.
"""
import torch

from ..core import AudioSignal
from ..metrics.distance import l1_loss
from ..metrics.spectral import MelSpectrogramLoss, MultiScaleSTFTLoss

__all__ = ["LOSS_WEIGHTS", "codec_loss", "make_train_step"]

LOSS_WEIGHTS = {
    "waveform": 1.0,
    "mel": 15.0,
    "stft": 1.0,
    "vq/commitment_loss": 0.25,
    "vq/codebook_loss": 1.0,
}


def codec_loss(model, audio: torch.Tensor, sample_rate: int, return_recon: bool = False):
    """Reconstruction and VQ losses of ``model`` on a batch ``(B, 1, T)``:
    ``(loss, metrics)``, and the reconstruction with ``return_recon`` (so an
    adversarial step reuses the one generator pass)."""
    out = model(audio)
    recon = out["audio"]

    est = AudioSignal(recon, sample_rate)
    ref = AudioSignal(audio, sample_rate)
    mel_loss = MelSpectrogramLoss()(est.clone(), ref.clone())
    stft_loss = MultiScaleSTFTLoss()(est.clone(), ref.clone())
    wav_loss = l1_loss(recon, audio)

    loss = (
        LOSS_WEIGHTS["waveform"] * wav_loss
        + LOSS_WEIGHTS["mel"] * mel_loss
        + LOSS_WEIGHTS["stft"] * stft_loss
        + LOSS_WEIGHTS["vq/commitment_loss"] * out["vq/commitment_loss"]
        + LOSS_WEIGHTS["vq/codebook_loss"] * out["vq/codebook_loss"]
    )
    metrics = {
        "loss": loss,
        "loss/waveform": wav_loss,
        "loss/mel": mel_loss,
        "loss/stft": stft_loss,
        "loss/commitment": out["vq/commitment_loss"],
        "loss/codebook": out["vq/codebook_loss"],
    }
    if return_recon:
        return loss, metrics, recon
    return loss, metrics


def make_train_step(model, optimizer, sample_rate: int):
    """A step ``audio -> metrics``: one forward of ``model``, one backward,
    one ``optimizer`` update of the model's parameters in place. The metrics
    are detached tensors on the model's device (reading them waits for the
    step)."""

    def train_step(audio):
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = codec_loss(model, audio, sample_rate)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step
