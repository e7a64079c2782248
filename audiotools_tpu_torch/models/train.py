"""Codec training step: reconstruction (multi-scale STFT, mel and waveform)
and VQ losses, one backward pass and one optimizer update.

Counterpart of ``audiotools_tpu/models/train.py``. The JAX package's
optimizer ``optax.adamw(1e-4)`` is, in PyTorch,
``torch.optim.AdamW(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
weight_decay=1e-4)``: torch's default weight decay is 1e-2, so it must be
given.

Model parallelism (:func:`shard_params`) runs one process per device on a
``DeviceMesh`` ``{"dp": D, "tp": P}``: conv, transposed-conv and dense
weights sharded on their output channels over ``tp``, everything else
replicated, batches sharded over ``dp`` (each process passes its own share
to the step). The steps stay as they are: the layers gather their output
channels (``parallel.tensor``), hooks average the gradients over ``dp``, and
a placed model's metrics are the global batch's.
"""
import torch

from ..core import AudioSignal
from ..metrics.distance import l1_loss
from ..metrics.spectral import MelSpectrogramLoss, MultiScaleSTFTLoss
from ..parallel import tensor as _tp

__all__ = ["LOSS_WEIGHTS", "codec_loss", "make_train_step", "shard_params_rules",
           "shard_params"]

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
    step); for a model placed on a mesh, the global batch's."""

    def train_step(audio):
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = codec_loss(model, audio, sample_rate)
        loss.backward()
        optimizer.step()
        return _tp.data_mean(model, {k: v.detach() for k, v in metrics.items()})

    return train_step


def shard_params_rules(mesh, tensor_axis: str = "tp"):
    """The partition rule of model parallelism: ``spec_for(name, param,
    layer)`` -> a ``PartitionSpec``-like tuple over the torch layout. A conv,
    transposed-conv or dense weight (``ndim >= 2``) whose output channels
    divide by and are at least the tensor axis's size is sharded on them
    (dim 0; dim 1 of a transposed conv's ``(in, out, k)``); biases, scales,
    codebooks and Snake's alphas are replicated. The JAX rule selects the
    same weights by their flax names and the last dim of flax's layouts."""
    tp_size = mesh.size(_tp._dim_index(mesh, tensor_axis))

    def spec_for(name: str, param, layer=None):
        leaf = name.rsplit(".", 1)[-1]
        out = getattr(layer, "_tp_dims", {}).get(leaf)
        if (out is not None and param.ndim >= 2 and param.shape[out] % tp_size == 0
                and param.shape[out] >= tp_size):
            spec = [None] * param.ndim
            spec[out] = tensor_axis
            return tuple(spec)
        return ()

    return spec_for


def shard_params(model, mesh, tensor_axis: str = "tp"):
    """Place ``model`` on ``mesh`` for (dp, tp) training: every parameter a
    ``DTensor``, sharded over ``tensor_axis`` by :func:`shard_params_rules`
    and replicated elsewhere, its gradients averaged over the mesh's
    ``"dp"`` dimension when it has one; returns the model. The parameters
    are the ones the ranks already hold, which must be equal (the same seed,
    or the same converted JAX tree)."""
    return _tp.place(model, mesh, shard_params_rules(mesh, tensor_axis))
