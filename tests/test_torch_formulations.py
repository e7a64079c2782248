"""The DAC's ``hybrid`` and ``matmul`` formulations against the JAX package's.

The JAX package computes its residual units' convs as shifted matmuls over
the convs' own parameters (all of them under ``matmul``; those of at most 64
channels under ``hybrid``); the port computes every formulation as convs
over the same parameters, so a JAX tree of any formulation converts into a
port model of any formulation. The width here (decoder 256) puts one decoder
stage above 64 channels, so the JAX ``hybrid`` runs both kinds of unit.
Tolerances as in ``test_torch_models.py``: fp32 sums in other orders give
~1e-6 relative on a forward pass, and codes must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu.models import DAC as JDAC
from audiotools_tpu_torch.models import DAC, convert
from audiotools_tpu_torch.models.dac import FORMULATIONS

SR = 16000
GEN = dict(encoder_dim=8, encoder_rates=(2, 4, 4), latent_dim=16, decoder_dim=256, n_codebooks=2,
           codebook_size=32, codebook_dim=4, sample_rate=SR)
FWD_RTOL = 1e-5  # a forward pass, fp32 in another order


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_models():
    """The JAX DAC in each formulation over one ``hybrid`` tree."""
    params = jax.jit(JDAC(**GEN, formulation="hybrid").init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 1024)))
    return {f: JDAC(**GEN, formulation=f) for f in FORMULATIONS}, params


def _port(formulation, params):
    port = DAC(**GEN, formulation=formulation)
    port.load_state_dict(convert.dac_state_dict(jax.tree.map(np.asarray, params)))
    return port


def _audio(seed, shape):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(np.float32)


@pytest.mark.parametrize("formulation", ["hybrid", "matmul"])
def test_formulation_matches_jax(jax_models, formulation):
    models, params = jax_models
    audio = _audio(0, (2, 1, 1000))
    want = models[formulation].apply(params, jnp.asarray(audio))
    with torch.no_grad():
        got = _port(formulation, params)(torch.from_numpy(audio))
    assert got["audio"].shape == (2, 1, 1000)
    assert _rel(got["audio"], want["audio"]) < FWD_RTOL
    assert _rel(got["z"].transpose(1, 2), want["z"]) < FWD_RTOL
    assert np.array_equal(got["codes"].numpy(), np.asarray(want["codes"]))


@pytest.mark.parametrize("formulation", FORMULATIONS)
def test_a_jax_hybrid_tree_loads_into_every_formulation(jax_models, formulation):
    """One JAX ``hybrid`` checkpoint, three port formulations: each decodes
    the JAX model's codes and reconstructs its audio."""
    models, params = jax_models
    audio = _audio(1, (2, 1, 1024))
    want = models["hybrid"].apply(params, jnp.asarray(audio))
    port = _port(formulation, params)
    with torch.no_grad():
        got = port(torch.from_numpy(audio))
        decoded = port.decode_from_codes(torch.from_numpy(np.asarray(want["codes"])))
    assert np.array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    assert _rel(got["audio"], want["audio"]) < FWD_RTOL
    assert _rel(decoded[..., :1024], want["audio"]) < FWD_RTOL


@pytest.mark.parametrize("formulation", ["hybrid", "matmul"])
def test_every_formulation_is_the_conv_model(formulation):
    """The port computes every formulation as convs: the same parameters
    from the same seed, and the same outputs and gradients bit for bit."""
    audio = torch.from_numpy(_audio(2, (2, 1, 1024)))
    models = [DAC(**GEN, seed=3), DAC(**GEN, seed=3, formulation=formulation)]
    outs = []
    for model in models:
        out = model(audio)
        (out["audio"] - audio).abs().mean().backward()
        outs.append((out["audio"].detach(), [p.grad for p in model.parameters()]))
    want, got = models[0].state_dict(), models[1].state_dict()
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    assert torch.equal(outs[0][0], outs[1][0])
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.parametrize("formulation", FORMULATIONS)
def test_save_and_load_keep_the_formulation(tmp_path, formulation):
    model = DAC(**GEN, formulation=formulation)
    model.save(tmp_path / "dac.pth")
    loaded = DAC.load(tmp_path / "dac.pth", device="cpu")
    assert loaded.formulation == formulation
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 loaded.state_dict().values()))


def test_unknown_formulation_raises():
    with pytest.raises(ValueError, match="formulation"):
        DAC(**GEN, formulation="shifted")
