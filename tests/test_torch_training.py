"""One reconstruction step and one adversarial step of the port against the
JAX package on the CPU, from the same weights (through ``models.convert``)
on the same batch, and the GAN losses. The models are the tiny
configurations of ``test_torch_models.py``, whose fixtures this file uses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu.models import adversarial as JA
from audiotools_tpu.models import train as JT
from audiotools_tpu_torch.models import DAC, Discriminator
from audiotools_tpu_torch.models import adversarial as PA
from audiotools_tpu_torch.models import convert
from audiotools_tpu_torch.models import train as PT
from tests.test_torch_models import DISC, FWD_RTOL, GEN, SR, _audio, _np_tree, disc, gen  # noqa: F401


def test_gan_losses_match_jax(disc):
    model, params, port = disc
    real, fake = _audio(5, (2, 1, 2048)), _audio(6, (2, 1, 2048))
    jreal, jfake = (jax.jit(model.apply)(params, jnp.asarray(a)) for a in (real, fake))
    with torch.no_grad():
        preal, pfake = port(torch.from_numpy(real)), port(torch.from_numpy(fake))
    for got, want in ((PA.discriminator_loss(preal, pfake), JA.discriminator_loss(jreal, jfake)),
                      (PA.generator_adversarial_loss(pfake), JA.generator_adversarial_loss(jfake)),
                      (PA.feature_matching_loss(preal, pfake),
                       JA.feature_matching_loss(jreal, jfake))):
        assert abs(float(got) - float(want)) / abs(float(want)) < FWD_RTOL


# -- the training steps --------------------------------------------------------


def _adamw(params):
    # optax.adamw(1e-4)'s defaults; torch's own default weight decay is 1e-2
    return torch.optim.AdamW(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _fresh_port(cls, kwargs, to_sd, params):
    port = cls(**kwargs)
    port.load_state_dict(to_sd(_np_tree(params)))
    return port


def _assert_update_matches(port, state_before, to_sd, jparams_after, lr=1e-4):
    """Parameters after one AdamW step. Each moves by ``lr * (m / (sqrt(v) +
    eps) + wd p)``, about ``lr`` for any gradient well above ``eps``; where
    the two packages' gradients differ in their last bits the move differs
    in its last bits too, so every parameter must agree within 1e-3 lr. A
    gradient within rounding of zero can flip its sign between packages
    and move by ``2 lr`` instead: at most 1 in 1000 entries may, and none by
    more."""
    want = to_sd(_np_tree(jparams_after))
    got = port.state_dict()
    worst, flipped, total = 0.0, 0, 0
    for name, w in want.items():
        diff = (got[name] - w).abs()
        worst = max(worst, float(diff.max()))
        flipped += int((diff > 1e-3 * lr).sum())
        total += diff.numel()
        moved = (got[name] - state_before[name]).abs()
        assert float(moved.max()) <= 1.01 * lr * (1 + 1e-4 * float(state_before[name].abs().max()))
    assert worst <= 2.01 * lr
    assert flipped <= total // 1000


def _grad_agreement(got, want):
    """Norm-wise relative difference of two gradient lists."""
    num = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
    den = sum(float((w ** 2).sum()) for w in want)
    return (num / den) ** 0.5


def test_train_step_matches_jax(gen):
    """One ``make_train_step`` step from the same weights on the same batch:
    every metric, the generator's gradients (norm-wise within 1e-3: the
    log-magnitude losses magnify rounding at quiet bins, see
    ``test_torch_losses.py``), and the parameters after AdamW."""
    model, params, _ = gen
    audio = _audio(7, (2, 1, 4096))
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.codec_loss(model, p, jnp.asarray(audio), SR), has_aux=True))(params)
    opt = optax.adamw(1e-4)
    jparams_after, _, _ = jax.jit(JT.make_train_step(model, opt, SR))(
        params, opt.init(params), jnp.asarray(audio))

    port = _fresh_port(DAC, GEN, convert.dac_state_dict, params)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    metrics = PT.make_train_step(port, _adamw(port.parameters()), SR)(torch.from_numpy(audio))
    assert sorted(metrics) == sorted(jmetrics)
    for key, value in metrics.items():
        assert abs(float(value) - float(jmetrics[key])) / abs(float(jmetrics[key])) < 1e-5, key
    want = convert.dac_state_dict(_np_tree(jgrads))
    names = list(want)
    grads = dict(port.named_parameters())
    assert _grad_agreement([grads[n].grad for n in names], [want[n] for n in names]) < 1e-3
    _assert_update_matches(port, before, convert.dac_state_dict, jparams_after)


def test_adversarial_step_matches_jax(gen, disc):
    """One ``make_adversarial_train_step`` step: both losses and every other
    metric, and both parameter trees after their updates (the generator
    against the current discriminator, then the discriminator on the
    detached reconstruction, as in the JAX step)."""
    gmodel, gparams, _ = gen
    dmodel, dparams, _ = disc
    audio = _audio(8, (2, 1, 4096))
    gopt, dopt = optax.adamw(1e-4), optax.adamw(1e-4)
    step = jax.jit(JA.make_adversarial_train_step(gmodel, dmodel, gopt, dopt, SR))
    jg_after, jd_after, _, _, jmetrics = step(gparams, dparams, gopt.init(gparams),
                                              dopt.init(dparams), jnp.asarray(audio))

    pgen = _fresh_port(DAC, GEN, convert.dac_state_dict, gparams)
    pdisc = _fresh_port(Discriminator, DISC, convert.discriminator_state_dict, dparams)
    gbefore = {k: v.clone() for k, v in pgen.state_dict().items()}
    dbefore = {k: v.clone() for k, v in pdisc.state_dict().items()}
    metrics = PA.make_adversarial_train_step(
        pgen, pdisc, _adamw(pgen.parameters()), _adamw(pdisc.parameters()), SR,
    )(torch.from_numpy(audio))
    assert sorted(metrics) == sorted(jmetrics)
    for key, value in metrics.items():
        assert abs(float(value) - float(jmetrics[key])) / abs(float(jmetrics[key])) < 1e-5, key
    _assert_update_matches(pgen, gbefore, convert.dac_state_dict, jg_after)
    _assert_update_matches(pdisc, dbefore, convert.discriminator_state_dict, jd_after)
