"""Adversarial codec training: least-squares GAN and feature-matching
losses over the :class:`~.discriminators.Discriminator` ensemble, and the
two-optimizer step.

Counterpart of ``audiotools_tpu/models/adversarial.py``, with its update
order: the generator is updated first, against the *current*
discriminator, from one generator forward; then the discriminator, on that
forward's reconstruction, detached. The generator's backward accumulates
into the generator's parameters only (``backward(inputs=...)``), so no
gradient of the generator's loss reaches the discriminator's update.
Placed on a mesh (``models.train.shard_params``), both models train as the
reconstruction step does, and the metrics are the global batch's.
"""
import torch

from .._hostprof import span
from ..parallel import tensor as _tp
from .train import codec_loss

__all__ = [
    "ADV_LOSS_WEIGHTS",
    "discriminator_loss",
    "generator_adversarial_loss",
    "feature_matching_loss",
    "make_adversarial_train_step",
]

ADV_LOSS_WEIGHTS = {
    # published DAC weighting: mel 15 / adv 1 / feature-matching 2
    "adv/gen": 1.0,
    "adv/feature": 2.0,
}


def discriminator_loss(real_outs, fake_outs):
    """Least squares, summed over the ensemble: real logits to 1, fake to 0."""
    loss = 0.0
    for real, fake in zip(real_outs, fake_outs):
        loss = loss + ((1.0 - real[-1]) ** 2).mean() + (fake[-1] ** 2).mean()
    return loss


def generator_adversarial_loss(fake_outs):
    """Least squares: fake logits to 1."""
    loss = 0.0
    for fake in fake_outs:
        loss = loss + ((1.0 - fake[-1]) ** 2).mean()
    return loss


def feature_matching_loss(real_outs, fake_outs):
    """L1 between real and fake feature maps (logits excluded), averaged per
    map and summed over the ensemble."""
    loss = 0.0
    for real, fake in zip(real_outs, fake_outs):
        for r, f in zip(real[:-1], fake[:-1]):
            loss = loss + (r.float() - f.float()).abs().mean()
    return loss


def make_adversarial_train_step(gen, disc, g_optimizer, d_optimizer, sample_rate: int):
    """A step ``audio -> metrics`` updating ``gen`` and ``disc`` in place.

    Generator: ``codec_loss`` plus the LSGAN and feature-matching terms
    against the current discriminator (its outputs on the real audio are
    constants of this update). Discriminator: LSGAN real against fake on
    the step's reconstruction. The metrics are detached tensors; for models
    placed on a mesh, the global batch's (over ``gen``'s data axis). The
    step's phases are the spans ``generator`` (``codec_loss``),
    ``discriminator`` (the ensemble's four calls), ``backward`` and
    ``optimizer`` (both optimizers' ``zero_grad`` and ``step``).
    """
    g_params = [p for p in gen.parameters() if p.requires_grad]

    def train_step(audio):
        with span("optimizer"):
            g_optimizer.zero_grad(set_to_none=True)
        with span("generator"):
            recon_loss, metrics, recon = codec_loss(gen, audio, sample_rate, return_recon=True)
        with span("discriminator"):
            fake_outs = disc(recon)
            with torch.no_grad():
                real_outs = disc(audio)
        adv = generator_adversarial_loss(fake_outs)
        fm = feature_matching_loss(real_outs, fake_outs)
        loss = recon_loss + ADV_LOSS_WEIGHTS["adv/gen"] * adv + ADV_LOSS_WEIGHTS["adv/feature"] * fm
        with span("backward"):
            loss.backward(inputs=g_params)
        with span("optimizer"):
            g_optimizer.step()
        metrics = dict(metrics, **{"loss": loss, "loss/adv": adv, "loss/feature": fm})

        with span("optimizer"):
            d_optimizer.zero_grad(set_to_none=True)
        recon = recon.detach()
        with span("discriminator"):
            real_outs, fake_outs = disc(audio), disc(recon)
        d_loss = discriminator_loss(real_outs, fake_outs)
        with span("backward"):
            d_loss.backward()
        with span("optimizer"):
            d_optimizer.step()
        metrics["loss/discriminator"] = d_loss
        return _tp.data_mean(gen, {k: v.detach() for k, v in metrics.items()})

    return train_step
