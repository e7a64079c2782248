"""The DAC's and the discriminators' bf16 compute dtype in the port against
the JAX package on the CPU: the JAX parameters carried over through
``models.convert`` into ``DAC(dtype=torch.bfloat16)`` and
``Discriminator(dtype=torch.bfloat16)``.

Tolerance: bf16 against fp32 is a rounding gap, not an error of either
package, and the two round differently, so each output's relative L2
distance between the port's bf16 and fp32 runs is held to at most 1.5x the
same distance in the JAX package (measured: within 0.5% of it). The
parameters stay fp32, the outputs are fp32 and the gradients finite, as
``tests/models/test_dac.py`` holds the JAX model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu.models import DAC as JDAC
from audiotools_tpu.models import Discriminator as JDisc
from audiotools_tpu_torch.models import DAC, Discriminator, convert
from audiotools_tpu_torch.models.adversarial import make_adversarial_train_step
from audiotools_tpu_torch.models.train import codec_loss

SR = 16000
GEN = dict(encoder_dim=8, encoder_rates=(2, 4, 4), latent_dim=16, decoder_dim=64, n_codebooks=2,
           codebook_size=32, codebook_dim=4, sample_rate=SR)
DISC = dict(periods=(2, 3), fft_sizes=(256, 128), mpd_channels=(4, 8), mrd_channels=4)
GAP_RATIO = 1.5


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _audio(seed, shape):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def gens():
    """The JAX models at fp32 and bf16 on one parameter tree, and the port's
    two models carrying it."""
    j32, j16 = JDAC(**GEN), JDAC(**GEN, dtype=jnp.bfloat16)
    params = jax.jit(j32.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, 1024)))
    sd = convert.dac_state_dict(_np_tree(params))
    ports = {}
    for key, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        ports[key] = DAC(**GEN, dtype=dtype)
        ports[key].load_state_dict(sd)
    return {"fp32": j32, "bf16": j16}, params, ports


@pytest.fixture(scope="module")
def discs():
    j32, j16 = JDisc(**DISC), JDisc(**DISC, dtype=jnp.bfloat16)
    params = jax.jit(j32.init)(jax.random.PRNGKey(1), jnp.zeros((1, 1, 2048)))
    sd = convert.discriminator_state_dict(_np_tree(params))
    ports = {}
    for key, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        ports[key] = Discriminator(**DISC, dtype=dtype)
        ports[key].load_state_dict(sd)
    return {"fp32": j32, "bf16": j16}, params, ports


def _jax_outputs(model, params, x):
    """The full pass's audio, the encoder's latents and the decoder on the
    fp32 model's latents."""
    xt = jnp.swapaxes(jnp.asarray(x), 1, 2)
    audio = jax.jit(model.apply)(params, jnp.asarray(x))["audio"]
    z = jax.jit(lambda p, a: model.apply(p, a, method=lambda m, v: m.encoder(v)))(params, xt)
    return audio, z


def test_dac_bf16_gap_is_the_jax_packages(gens):
    jax_models, params, ports = gens
    x = _audio(0, (2, 1, 4096))
    xt = jnp.swapaxes(jnp.asarray(x), 1, 2)
    j = {k: _jax_outputs(m, params, x) for k, m in jax_models.items()}
    z32 = j["fp32"][1]
    j_dec = {k: jax.jit(lambda p, z, m=m: m.apply(p, z, method=lambda mm, v: mm.decoder(v)))(
        params, z32) for k, m in jax_models.items()}
    xp = torch.from_numpy(x)
    with torch.no_grad():
        p = {k: (m(xp)["audio"], m.encoder(xp)) for k, m in ports.items()}
        pz32 = p["fp32"][1]
        p_dec = {k: m.decoder(pz32) for k, m in ports.items()}
    gaps = {
        "audio": (_rel_l2(p["bf16"][0], p["fp32"][0]), _rel_l2(j["bf16"][0], j["fp32"][0])),
        "latents": (_rel_l2(p["bf16"][1], p["fp32"][1]), _rel_l2(j["bf16"][1], j["fp32"][1])),
        "decoded": (_rel_l2(p_dec["bf16"], p_dec["fp32"]), _rel_l2(j_dec["bf16"], j_dec["fp32"])),
    }
    for name, (port_gap, jax_gap) in gaps.items():
        assert 0 < port_gap <= GAP_RATIO * jax_gap, (name, port_gap, jax_gap)
    assert xt.shape == (2, 4096, 1)
    for out in (*p["bf16"], p_dec["bf16"]):
        assert out.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in ports["bf16"].state_dict().values())


def test_discriminator_bf16_gap_is_the_jax_packages(discs):
    """Every feature map and logit map, concatenated (the port's NCHW maps
    moved to the JAX package's NHWC)."""
    jax_models, params, ports = discs
    x = _audio(1, (2, 1, 4096))

    def flat(outs, nchw):
        return np.concatenate([
            (np.moveaxis(np.asarray(f, np.float64), 1, -1) if nchw else np.asarray(f, np.float64))
            .ravel() for o in outs for f in o])

    j = {k: flat(jax.jit(m.apply)(params, jnp.asarray(x)), False) for k, m in jax_models.items()}
    with torch.no_grad():
        outs = {k: m(torch.from_numpy(x)) for k, m in ports.items()}
    assert all(f.dtype == torch.float32 for o in outs["bf16"] for f in o)
    p = {k: flat([[f.numpy() for f in o] for o in v], True) for k, v in outs.items()}
    assert _rel_l2(p["fp32"], j["fp32"]) < 1e-5  # the same maps in the same order
    port_gap, jax_gap = _rel_l2(p["bf16"], p["fp32"]), _rel_l2(j["bf16"], j["fp32"])
    assert np.isfinite(p["bf16"]).all()
    assert 0 < port_gap <= GAP_RATIO * jax_gap, (port_gap, jax_gap)


def test_bf16_gradients_are_finite_and_parameters_stay_fp32(gens, discs):
    """One reconstruction loss backward and one adversarial step of the bf16
    models: finite fp32 gradients, finite losses, fp32 parameters."""
    gen = DAC(**GEN, dtype=torch.bfloat16)
    gen.load_state_dict(gens[2]["fp32"].state_dict())
    disc = Discriminator(**DISC, dtype=torch.bfloat16)
    disc.load_state_dict(discs[2]["fp32"].state_dict())
    audio = torch.from_numpy(_audio(2, (2, 1, 4096)))

    loss, metrics = codec_loss(gen, audio, SR)
    loss.backward()
    grads = [p.grad for p in gen.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)

    opt = lambda m: torch.optim.AdamW(m.parameters(), lr=1e-4, weight_decay=1e-4)  # noqa: E731
    step = make_adversarial_train_step(gen, disc, opt(gen), opt(disc), SR)
    metrics = step(audio)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert all(p.dtype == torch.float32 for m in (gen, disc) for p in m.parameters())
    assert all(torch.isfinite(p).all() for m in (gen, disc) for p in m.parameters())


def test_dtype_survives_save_and_load(tmp_path, gens):
    model = gens[2]["bf16"]
    path = model.save(tmp_path / "model.pth")
    loaded = DAC.load(path, device="cpu")
    assert loaded.dtype == torch.bfloat16 and loaded.metadata["kwargs"]["dtype"] == torch.bfloat16
    assert loaded.encoder.conv_in.compute_dtype == torch.bfloat16
    assert loaded.decoder.blocks[0].conv.compute_dtype == torch.bfloat16
    x = torch.from_numpy(_audio(3, (1, 1, 2048)))
    with torch.no_grad():
        assert torch.equal(loaded(x)["audio"], model(x)["audio"])
    folder = model.save_to_folder(tmp_path / "folder")
    again, _ = DAC.load_from_folder(folder.parent, device="cpu")
    assert again.dtype == torch.bfloat16
    assert DAC(**GEN).dtype is None
