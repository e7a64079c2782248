"""The codec training slice of the port against the JAX package on the CPU:
the DAC generator, the MPD + MRD discriminators and the weight converter
(the training steps: ``test_torch_training.py``).

The JAX models are the JAX tests' tiny configurations
(``tests/models/test_dac.py``, ``tests/models/test_adversarial.py``),
initialized under ``jax.jit``; their parameters reach the port through
``models.convert``. Tolerances are stated where they are used: fp32 sums in
other orders give ~1e-6 relative on a forward pass; gradients through the
log-magnitude losses are held as ``test_torch_losses.py`` holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

import flax.linen as fnn
from audiotools_tpu.models import DAC as JDAC
from audiotools_tpu.models import Discriminator as JDisc
from audiotools_tpu_torch.models import DAC, Discriminator
from audiotools_tpu_torch.models import adversarial as PA
from audiotools_tpu_torch.models import convert
from audiotools_tpu_torch.models.dac import ConvTranspose1dSame
from audiotools_tpu_torch.models.discriminators import WNConv2d

SR = 16000
GEN = dict(encoder_dim=8, encoder_rates=(2, 4, 4), latent_dim=16, decoder_dim=64, n_codebooks=2,
           codebook_size=32, codebook_dim=4, sample_rate=SR)
DISC = dict(periods=(2, 3), fft_sizes=(256, 128), mpd_channels=(4, 8), mrd_channels=4)
FWD_RTOL = 1e-5  # a forward pass, fp32 in another order


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def gen():
    model = JDAC(**GEN)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, 1024)))
    port = DAC(**GEN)
    port.load_state_dict(convert.dac_state_dict(_np_tree(params)))
    return model, params, port


@pytest.fixture(scope="module")
def disc():
    model = JDisc(**DISC)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 1, 2048)))
    port = Discriminator(**DISC)
    port.load_state_dict(convert.discriminator_state_dict(_np_tree(params)))
    return model, params, port


def _audio(seed, shape):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(np.float32)


# -- layers alone --------------------------------------------------------------


@pytest.mark.parametrize("stride", [2, 3, 4, 8])
def test_conv_transpose_same_matches_flax(stride):
    """flax's ``ConvTranspose(padding="SAME")`` (no kernel flip) against the
    port's layer on the converted kernel, at every stride of the full
    config (2, 4, 8) and an odd one, whose crops differ."""
    k, c_in, c_out, T = 2 * stride, 3, 5, 13
    layer = fnn.ConvTranspose(c_out, (k,), (stride,), padding="SAME")
    x = _audio(stride, (2, T, c_in))
    params = layer.init(jax.random.PRNGKey(stride), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.1, params)  # a nonzero bias
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    port = ConvTranspose1dSame(c_in, c_out, k, stride)
    sd = {}
    convert._conv_transpose(convert._Tree(_np_tree(params)), (), sd, "conv")
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).detach().numpy()
    assert got.shape == want.shape == (2, T * stride, c_out)
    assert _rel(got, want) < FWD_RTOL


@pytest.mark.parametrize("weight_norm", [True, False])
@pytest.mark.parametrize("kernel,stride,hw", [((5, 1), (3, 1), (25, 3)), ((5, 1), (3, 1), (26, 2)),
                                               ((3, 9), (1, 2), (7, 33)), ((3, 9), (1, 2), (6, 20)),
                                               ((3, 3), (1, 1), (5, 11))])
def test_weight_normed_conv2d_matches_flax(kernel, stride, hw, weight_norm):
    """flax's SAME padding (asymmetric at these lengths) and ``WeightNorm``
    (gain starting at ones, the norm over all but the output features,
    epsilon 1e-12) against ``WNConv2d``; the gain is perturbed so a wrong
    axis would show."""
    class Layer(fnn.Module):  # the discriminators' ``_conv``, in a parent's scope
        @fnn.compact
        def __call__(self, x):
            conv = fnn.Conv(4, kernel, stride)
            return (fnn.WeightNorm(conv) if weight_norm else conv)(x)

    layer = Layer()
    x = _audio(sum(hw), (2, *hw, 3))
    params = layer.init(jax.random.PRNGKey(2), jnp.asarray(x))
    params = jax.tree.map(lambda a: a * (1.0 + 0.1 * np.arange(a.shape[-1])), params)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    tree = {"m": _np_tree(params)["params"]}
    sd = {}
    convert._wn_conv(convert._Tree(tree), ("m",), 0, sd, "conv")
    port = WNConv2d(3, 4, kernel, stride, weight_norm)
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < FWD_RTOL


# -- the converter and the port's own initialization ---------------------------


def test_converter_raises_on_unknown_and_missing_leaves(gen, disc):
    tree = _np_tree(gen[1])
    extra = jax.tree.map(lambda a: a, tree)
    extra["params"]["encoder"]["Conv_9"] = {"kernel": np.zeros((3, 1, 1), np.float32)}
    with pytest.raises(KeyError, match="no module takes"):
        convert.dac_state_dict(extra)
    missing = jax.tree.map(lambda a: a, tree)
    del missing["params"]["decoder"]["DecoderBlock_1"]["ResidualUnit_2"]["Snake_1"]
    with pytest.raises(KeyError, match="lacks decoder/DecoderBlock_1/ResidualUnit_2/Snake_1"):
        convert.dac_state_dict(missing)
    dtree = _np_tree(disc[1])
    del dtree["params"]["mrd_1"]["WeightNorm_3"]
    with pytest.raises(RuntimeError, match="Missing key"):
        Discriminator(**DISC).load_state_dict(convert.discriminator_state_dict(dtree))


def test_full_size_models_take_the_full_size_trees():
    """``DAC()`` and ``Discriminator()`` at their defaults load the converted
    trees of the JAX defaults (shapes from ``jax.eval_shape``, no compute),
    strictly: every parameter has its counterpart, at its layout."""
    audio = jax.ShapeDtypeStruct((1, 1, 1024), jnp.float32)
    for jmodel, port, to_sd in ((JDAC(), DAC(), convert.dac_state_dict),
                                (JDisc(), Discriminator(), convert.discriminator_state_dict)):
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), audio)
        tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        port.load_state_dict(to_sd(tree))
        assert sum(p.numel() for p in port.parameters()) == sum(
            int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


def test_own_initialization_follows_flax():
    """Without a JAX tree the port initializes as flax does: lecun-normal
    kernels (variance 1 / fan-in, truncated at two deviations), zero
    biases, the residual units' output conv at deviation 1e-2, unit-normal
    codebooks, Snake alpha and weight-norm gains of ones; the seed decides
    the draw."""
    model = DAC(encoder_dim=16, latent_dim=64, decoder_dim=256, seed=3)
    conv = model.decoder.blocks[0].units[1].conv1.weight  # (128, 128, 7)
    fan_in = 128 * 7
    assert abs(float(conv.std()) * np.sqrt(fan_in) - 1.0) < 0.02
    assert float(conv.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-7
    near = model.decoder.blocks[0].units[1].conv2.weight
    assert abs(float(near.std()) - 1e-2) < 5e-4
    codebook = model.quantizer.quantizers[0].codebook
    assert abs(float(codebook.std()) - 1.0) < 0.05
    assert all(float(m.bias.abs().max()) == 0.0 for m in model.modules()
               if isinstance(m, torch.nn.Conv1d))
    assert float(model.encoder.snake.alpha.min()) == float(model.encoder.snake.alpha.max()) == 1.0
    disc = Discriminator(**DISC)
    assert float(disc.mrd[0].band_convs[2][1].scale.min()) == 1.0
    same = DAC(encoder_dim=16, latent_dim=64, decoder_dim=256, seed=3)
    other = DAC(encoder_dim=16, latent_dim=64, decoder_dim=256, seed=4)
    assert torch.equal(same.decoder.blocks[0].units[1].conv1.weight, conv)
    assert not torch.equal(other.decoder.blocks[0].units[1].conv1.weight, conv)


# -- the DAC -------------------------------------------------------------------


def _code_margins(port, audio):
    """Top-1 minus top-2 cosine similarity of every code the port picks."""
    margins = []
    with torch.no_grad():
        residual = port.encoder(port._pad(audio))
        for vq in port.quantizer.quantizers:
            z_e = vq.in_proj(residual.transpose(1, 2))
            z_n = z_e / (z_e.norm(dim=-1, keepdim=True) + 1e-8)
            c_n = vq.codebook / (vq.codebook.norm(dim=-1, keepdim=True) + 1e-8)
            top = (z_n @ c_n.T).topk(2, dim=-1).values
            margins.append(top[..., 0] - top[..., 1])
            residual = residual - vq(residual)[0]
    return torch.stack(margins)


def test_dac_forward_matches_jax(gen):
    """Audio, latents, codes and both VQ losses. Codes must be equal, and the
    smallest top-2 similarity margin must lie far (100x) above the fp32
    rounding of the similarities (~1e-6), so that equal codes are not luck."""
    model, params, port = gen
    audio = _audio(0, (2, 1, 1000))
    want = model.apply(params, jnp.asarray(audio))
    with torch.no_grad():
        got = port(torch.from_numpy(audio))
    assert got["audio"].shape == (2, 1, 1000)
    assert _rel(got["audio"], want["audio"]) < FWD_RTOL
    assert _rel(got["z"].transpose(1, 2), want["z"]) < FWD_RTOL
    assert np.array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    assert float(_code_margins(port, torch.from_numpy(audio)).min()) > 1e-4
    for key in ("vq/commitment_loss", "vq/codebook_loss"):
        assert abs(float(got[key]) - float(want[key])) / float(want[key]) < FWD_RTOL
    assert port.hop_length == model.hop_length == 32


def test_dac_encode_and_decode_paths_match_jax(gen):
    model, params, port = gen
    audio = _audio(1, (2, 1, 1024))
    z_want, codes_want = model.apply(params, jnp.asarray(audio), method=JDAC.encode)
    with torch.no_grad():
        z_got, codes_got = port.encode(torch.from_numpy(audio))
        from_codes = port.decode_from_codes(codes_got)
        from_latents = port.decode_from_latents(z_got)
        one_stage = port.decode_from_codes(codes_got[:, :1])
    assert np.array_equal(codes_got.numpy(), np.asarray(codes_want))
    assert _rel(z_got.transpose(1, 2), z_want) < FWD_RTOL
    for got, codes in ((from_codes, codes_want), (one_stage, codes_want[:, :1])):
        want = model.apply(params, codes, method=JDAC.decode_from_codes)
        assert got.shape == (2, 1, 1024) and _rel(got, want) < FWD_RTOL
    want = model.apply(params, z_want, method=JDAC.decode_from_latents)
    assert _rel(from_latents, want) < FWD_RTOL


# -- the discriminators --------------------------------------------------------


def test_discriminator_features_match_jax(disc):
    """Every feature map of every sub-discriminator, in the JAX order (MPD
    at each period, then MRD at each window), NHWC against NCHW."""
    model, params, port = disc
    audio = _audio(2, (2, 1, 2048))
    want = jax.jit(model.apply)(params, jnp.asarray(audio))
    with torch.no_grad():
        got = port(torch.from_numpy(audio))
        flat = port(torch.from_numpy(audio[:, 0]))
    assert len(got) == len(want) == 4
    for feats_p, feats_j, feats_flat in zip(got, want, flat):
        assert len(feats_p) == len(feats_j)
        for fp, fj, ff in zip(feats_p, feats_j, feats_flat):
            fj = np.asarray(fj).transpose(0, 3, 1, 2)
            assert tuple(fp.shape) == fj.shape
            assert _rel(fp, fj) < FWD_RTOL
            assert torch.equal(fp, ff)
