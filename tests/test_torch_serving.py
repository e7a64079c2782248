"""The codec's serving path in the port against the JAX package on the CPU:
``BaseModel`` save and load, streaming encode and decode, and compressed
artifacts.

The JAX model is the tiny DAC of ``tests/models/test_streaming.py``,
initialized under ``jax.jit``; its weights reach the port through
``models.convert.dac_state_dict``. Codes are held bit for bit (against the
JAX package and against the port's own whole pass); decoded audio within
2e-6, the JAX package's own pin for streamed against whole decoding
(``tests/models/test_streaming.py``).
"""
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores
from torch import nn

from audiotools_tpu import AudioSignal as JSignal
from audiotools_tpu.models import DAC as JDAC
from audiotools_tpu.models import artifacts as JA
from audiotools_tpu.models import streaming as JST
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch.ml import BaseModel
from audiotools_tpu_torch.models import DAC, convert
from audiotools_tpu_torch.models import artifacts as PA
from audiotools_tpu_torch.models import streaming as PST

SR = 16000
TINY = dict(encoder_dim=8, encoder_rates=(2, 4, 4), latent_dim=16, decoder_dim=64, n_codebooks=2,
            codebook_size=32, codebook_dim=4, sample_rate=SR)
AUDIO_ATOL = 2e-6  # tests/models/test_streaming.py's pin


@pytest.fixture(scope="module")
def jax_model():
    model = JDAC(**TINY)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, 1024)))
    return model, params


@pytest.fixture(scope="module")
def port(jax_model):
    port = DAC(**TINY)
    port.load_state_dict(convert.dac_state_dict(jax.tree.map(np.asarray, jax_model[1])))
    return port


@pytest.fixture(scope="module")
def audio():
    return (np.random.RandomState(7).randn(2, 1, 3000) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_codes(jax_model, audio):
    model, params = jax_model
    encode = jax.jit(lambda p, a: model.apply(p, a, method=JDAC.encode)[1])
    return np.asarray(encode(params, jnp.asarray(audio)))


@pytest.fixture(scope="module")
def jax_decoded(jax_model, jax_codes):
    model, params = jax_model
    decode = jax.jit(lambda p, c: model.apply(p, c, method=JDAC.decode_from_codes))
    return np.asarray(decode(params, jnp.asarray(jax_codes)))


@pytest.fixture(scope="module")
def whole(port, audio):
    """The port's whole pass: codes and decoded audio."""
    with torch.no_grad():
        codes = port.encode(torch.from_numpy(audio))[1]
        return codes, port.decode_from_codes(codes)


# -- halos ----------------------------------------------------------------------


@pytest.mark.parametrize("rates", [(2, 4, 4), (2, 4, 8, 8), (2, 2), (8, 2), (4, 4, 2), (3, 5)])
def test_halos_equal_the_jax_functions(rates):
    config = dict(TINY, encoder_rates=rates)
    port, model = DAC(**config), JDAC(**config)
    assert PST.encoder_halo_frames(port) == JST.encoder_halo_frames(model)
    assert PST.decoder_halo_frames(port) == JST.decoder_halo_frames(model)
    assert PST.encoder_halo_frames(port, margin=0) == JST.encoder_halo_frames(model, margin=0)


def test_full_size_halos():
    """``DAC()``'s halos: 12 encoder and 14 decoder frames, so windows of
    128-frame chunks are 152 frames (77,824 samples) and 156 frames."""
    port = SimpleNamespace(encoder_rates=(2, 4, 8, 8), hop_length=512)  # the halos' geometry
    assert PST.encoder_halo_frames(port) == JST.encoder_halo_frames(JDAC()) == 12
    assert PST.decoder_halo_frames(port) == JST.decoder_halo_frames(JDAC()) == 14


@pytest.mark.parametrize("total,chunk,halo,W", [(94, 4, 12, 28), (94, 16, 12, 40), (2584, 128, 12, 152),
                                                (41, 16, 14, 44), (7, 3, 1, 5)])
def test_window_starts_equal_the_jax_geometry(total, chunk, halo, W):
    assert list(PST._window_starts(total, chunk, halo, W)) == list(
        JST._window_starts(total, chunk, halo, W))


# -- streaming encode and decode -----------------------------------------------


@pytest.mark.parametrize("chunk", [4, 16])
def test_stream_encode_equals_jax_and_whole_pass(port, audio, jax_codes, whole, chunk):
    codes = PST.stream_encode(port, audio, chunk_frames=chunk)
    assert codes.shape == whole[0].shape == jax_codes.shape  # 3000 samples: not a hop multiple
    assert torch.equal(codes, whole[0])
    assert np.array_equal(codes.numpy(), jax_codes)


@pytest.mark.parametrize("n", [200, 61 * 32 + 7])
def test_stream_encode_other_lengths(jax_model, port, n):
    """A stream shorter than one window (one call of the whole model), and
    one 7 samples past a whole number of hops."""
    model, params = jax_model
    x = (np.random.RandomState(n).randn(1, 1, n) * 0.3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a: model.apply(p, a, method=JDAC.encode)[1])(params, x))
    with torch.no_grad():
        own = port.encode(torch.from_numpy(x))[1]
    got = PST.stream_encode(port, torch.from_numpy(x), chunk_frames=16)
    assert torch.equal(got, own) and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [4, 16])
def test_stream_decode_matches_jax(port, jax_codes, jax_decoded, whole, chunk):
    got = PST.stream_decode(port, jax_codes, chunk_frames=chunk)
    assert got.shape == jax_decoded.shape == whole[1].shape
    np.testing.assert_allclose(got.numpy(), jax_decoded, atol=AUDIO_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), whole[1].numpy(), atol=AUDIO_ATOL, rtol=0)


def test_stream_decode_short_stream(port, jax_codes, whole):
    """A code stream shorter than one window decodes through one call."""
    short = torch.from_numpy(jax_codes[:, :, :10])
    with torch.no_grad():
        want = port.decode_from_codes(short)
    got = PST.stream_decode(port, short, chunk_frames=16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=AUDIO_ATOL, rtol=0)


def test_irregular_push_blocks(port, audio, jax_codes):
    """Any push() block sizes, numpy and tensors mixed, emit the same code
    stream, as tensors."""
    enc = PST.StreamingEncoder(port, batch_size=2, chunk_frames=8)
    out = []
    cuts = [0, 37, 38, 501, 502, 1700, 2999, 3000]
    for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        block = audio[:, :, a:b]
        out += list(enc.push(torch.from_numpy(block) if i % 2 else block))
    out += list(enc.flush())
    assert all(isinstance(c, torch.Tensor) for c in out)
    assert np.array_equal(torch.cat(out, dim=-1).numpy(), jax_codes)


def test_streaming_decoder_push_blocks(port, jax_codes, jax_decoded):
    """Blocks of any size, as int32 arrays, uint16 arrays (an artifact's
    dtype) and tensors."""
    dec = PST.StreamingDecoder(port, batch_size=2, chunk_frames=8)
    out = []
    n = jax_codes.shape[-1]
    for i, (a, b) in enumerate(zip([0, 3, 30, 31, 60], [3, 30, 31, 60, n])):
        block = jax_codes[:, :, a:b]
        out += list(dec.push([block, block.astype(np.uint16), torch.from_numpy(block)][i % 3]))
    out += list(dec.flush())
    np.testing.assert_allclose(torch.cat(out, dim=-1).numpy(), jax_decoded, atol=AUDIO_ATOL, rtol=0)


def test_bounded_buffer(port):
    """The buffer stays O(window) however long the stream: history is one
    window back from the next frame, and unemitted samples reach at most
    (next - halo) + W before the next drain."""
    enc = PST.StreamingEncoder(port, batch_size=1, chunk_frames=8)
    rng = np.random.RandomState(9)
    cap = enc.W + (enc.chunk + enc.halo) * enc.hop
    emitted = 0
    for _ in range(12):
        for codes in enc.push((rng.randn(1, 1, 600) * 0.1).astype(np.float32)):
            emitted += codes.shape[-1]
        assert enc._buf.shape[-1] <= cap
        assert enc._buf.device == port.device
    assert emitted > 0


def test_push_after_flush_raises(port):
    enc = PST.StreamingEncoder(port, batch_size=1, chunk_frames=8)
    list(enc.flush())
    with pytest.raises(RuntimeError):
        list(enc.push(np.zeros((1, 1, 10), np.float32)))
    dec = PST.StreamingDecoder(port, batch_size=1, chunk_frames=8)
    list(dec.push(np.zeros((1, 2, 3), np.int64)))
    list(dec.flush())
    with pytest.raises(RuntimeError):
        list(dec.push(np.zeros((1, 2, 3), np.int64)))


def test_bad_shapes_raise(port):
    with pytest.raises(ValueError):
        PST.stream_encode(port, np.zeros((1, 100), np.float32))
    with pytest.raises(ValueError):
        PST.stream_decode(port, np.zeros((4, 10), np.int32))
    enc = PST.StreamingEncoder(port, batch_size=1, chunk_frames=8)
    with pytest.raises(ValueError):
        list(enc.push(np.zeros((2, 1, 10), np.float32)))
    dec = PST.StreamingDecoder(port, batch_size=2, chunk_frames=8)
    with pytest.raises(ValueError):
        list(dec.push(np.zeros((1, 2, 10), np.int64)))
    with pytest.raises(ValueError):
        PST.StreamingEncoder(port, chunk_frames=0)


def test_n_quantizers_truncation(jax_model, port, audio):
    model, params = jax_model
    want = np.asarray(jax.jit(lambda p, a: model.apply(p, a, method=JDAC.encode,
                                                       n_quantizers=1)[1])(params, audio))
    codes = PST.stream_encode(port, audio, chunk_frames=16, n_quantizers=1)
    assert codes.shape[1] == 1 and np.array_equal(codes.numpy(), want)


@pytest.mark.parametrize("rates", [(2, 2), (8, 2), (4, 4, 2)], ids=lambda r: "x".join(map(str, r)))
def test_halo_covers_arbitrary_architectures(rates):
    """The analytic halos cover the receptive field of any encoder_rates:
    streamed codes equal the whole pass bit for bit, audio within 2e-6."""
    m = DAC(encoder_dim=8, encoder_rates=rates, latent_dim=8, decoder_dim=32, n_codebooks=1,
            codebook_size=16, codebook_dim=4, sample_rate=SR, seed=1)
    x = (np.random.RandomState(11).randn(1, 1, 61 * m.hop_length + 7) * 0.3).astype(np.float32)
    with torch.no_grad():
        ref = m.encode(torch.from_numpy(x))[1]
        dec_ref = m.decode_from_codes(ref)
    assert torch.equal(PST.stream_encode(m, x, chunk_frames=8), ref)
    np.testing.assert_allclose(PST.stream_decode(m, ref, chunk_frames=8).numpy(), dec_ref.numpy(),
                               atol=AUDIO_ATOL, rtol=0)


# -- artifacts -------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_artifact(jax_model, audio, tmp_path_factory):
    """An artifact compressed and written by the JAX package, and the JAX
    package's decompression of it."""
    model, params = jax_model
    art = JA.compress(model, params, audio)
    path = str(tmp_path_factory.mktemp("art") / "clip.npz")
    JA.save_artifact(path, art)
    return path, art, np.asarray(JA.decompress(model, params, art).audio_data)


def test_jax_artifact_decompresses_in_the_port(port, jax_artifact):
    path, _, want = jax_artifact
    art = PA.load_artifact(path)
    for streaming in (False, True):
        got = PA.decompress(port, art, streaming=streaming, chunk_frames=16)
        assert isinstance(got, AudioSignal) and got.sample_rate == SR
        assert got.audio_data.shape == want.shape == (2, 1, 3000)
        np.testing.assert_allclose(got.numpy(), want, atol=AUDIO_ATOL, rtol=0)


def test_port_artifact_equals_jax_and_loads_there(jax_model, port, audio, jax_artifact, tmp_path):
    model, params = jax_model
    _, want, want_audio = jax_artifact
    for streaming in (False, True):
        art = PA.compress(port, audio, streaming=streaming, chunk_frames=16)
        assert set(art) == set(want)
        assert art["codes"].dtype == np.uint16 and np.array_equal(art["codes"], want["codes"])
        assert {k: v for k, v in art.items() if k != "codes"} == {
            k: v for k, v in want.items() if k != "codes"}
    path = PA.save_artifact(str(tmp_path / "port.npz"), art)
    back = JA.load_artifact(path)
    np.testing.assert_allclose(np.asarray(JA.decompress(model, params, back).audio_data),
                               want_audio, atol=0, rtol=0)


def test_compress_resamples_and_mixes_down(jax_model, port):
    """A stereo signal at 44.1 kHz is resampled to the model's rate and
    mixed down, in both packages, to the same codes."""
    model, params = jax_model
    x = (np.random.RandomState(3).randn(1, 2, 8820) * 0.2).astype(np.float32)
    want = JA.compress(model, params, JSignal(x, 44100))
    got = PA.compress(port, AudioSignal(x, 44100, device="cpu"))
    assert got["n_samples"] == want["n_samples"] == 3200
    assert np.array_equal(got["codes"], want["codes"])


def test_decompress_guards_raise_before_decoding(port, audio):
    art = PA.compress(port, audio)
    bad = [dict(art, sample_rate=44100), dict(art, codebook_size=64),
           dict(art, codes=np.concatenate([art["codes"]] * 2, axis=1)),
           dict(art, codes=np.full_like(art["codes"], 32))]
    for artifact, match in zip(bad, ["Hz", "codebook_size", "stages", "outside"]):
        with pytest.raises(ValueError, match=match):
            PA.decompress(port, artifact)
    big = DAC(**dict(TINY, codebook_size=65537, decoder_dim=8))
    with pytest.raises(ValueError, match="uint16"):
        PA.compress(big, audio)


def test_streaming_artifacts_match_the_whole_pass(port, audio):
    art = PA.compress(port, audio)
    art_s = PA.compress(port, torch.from_numpy(audio), streaming=True, chunk_frames=16)
    assert np.array_equal(art["codes"], art_s["codes"]) and art["n_samples"] == art_s["n_samples"]
    rec = PA.decompress(port, art)
    rec_s = PA.decompress(port, art, streaming=True, chunk_frames=16)
    np.testing.assert_allclose(rec_s.numpy(), rec.numpy(), atol=AUDIO_ATOL, rtol=0)


# -- BaseModel -------------------------------------------------------------------


class TinyModel(BaseModel):
    def __init__(self, hidden: int = 8, scale: float = 1.0):
        super().__init__()
        self.layer = nn.Linear(5, hidden)
        self.scale = scale

    def forward(self, x):
        return self.layer(x) * self.scale


def _same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k].cpu()) for k in sa)


@pytest.mark.parametrize("package", [True, False])
def test_model_save_load_roundtrip(tmp_path, package):
    model = TinyModel(hidden=3, scale=2.0)
    path = tmp_path / "model.pth"
    model.save(path, metadata={"note": "x"}, package=package)
    blob = torch.load(path, weights_only=False)
    assert (blob.get("source") is not None) == package
    back = TinyModel.load(path, device="cpu")
    assert isinstance(back, TinyModel) and back.layer.out_features == 3 and back.scale == 2.0
    assert back.metadata == {"note": "x", "kwargs": {"hidden": 3, "scale": 2.0}}
    assert _same_weights(model, back)
    x = torch.randn(2, 5)
    assert torch.equal(model(x), back(x))
    # saved kwargs are updated by the caller's and filtered to the signature
    other = TinyModel.load(path, device="cpu", scale=3.0, unknown=1)
    assert other.scale == 3.0 and not hasattr(other, "unknown")


def test_model_package_resolves_class_without_import(tmp_path):
    """Packaged source re-materializes the class when its module cannot be
    imported, through the base class's generic load."""
    model = TinyModel(hidden=2)
    path = tmp_path / "m.pth"
    model.save(path, package=True)
    blob = torch.load(path, weights_only=False)
    assert "class TinyModel" in blob["source"]
    blob["class_module"] = "no_such_package.no_such_module"
    torch.save(blob, path)
    back = BaseModel.load(path, device="cpu")
    assert type(back).__name__ == "TinyModel" and type(back) is not TinyModel
    assert _same_weights(model, back)


def test_model_device_and_default(tmp_path):
    model = TinyModel()
    assert model.device == torch.device("cpu")
    path = model.save(tmp_path / "m.pth")
    if torch.cuda.is_available():
        assert TinyModel.load(path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TinyModel.load(path)


def test_dac_folder_roundtrip(jax_model, port, audio, jax_codes, tmp_path):
    """``save_to_folder`` / ``load_from_folder`` of the converted DAC: the
    configuration (``seed`` included) and the weights come back bit-equal,
    with the extra data, through the packaged and the weights-only files."""
    target = port.save_to_folder(tmp_path, extra_data={"tracker.pth": {"step": 5},
                                                        "opt.pth": {"m": torch.ones(3)}})
    assert target == tmp_path / "dac"
    assert {p.name for p in target.iterdir()} == {"package.pth", "weights.pth", "tracker.pth",
                                                  "opt.pth"}
    for package in (True, False):
        back, extra = DAC.load_from_folder(tmp_path, package=package, device="cpu")
        assert back.metadata["kwargs"] == dict(TINY, encoder_rates=(2, 4, 4), seed=0, dtype=None,
                                               formulation="conv")
        assert _same_weights(port, back)
        assert extra["tracker.pth"] == {"step": 5} and torch.equal(extra["opt.pth"]["m"], torch.ones(3))
        assert np.array_equal(PA.compress(back, audio)["codes"], jax_codes)


def test_jax_saved_dac_reaches_the_port(jax_model, jax_codes, audio, tmp_path):
    """A file saved by the JAX ``BaseModel`` (flax msgpack weights) reaches the
    port through ``convert.dac_state_dict``."""
    import flax

    model, params = jax_model
    path = tmp_path / "jax.pth"
    model.save(str(path), params)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    kwargs = {k: v for k, v in blob["metadata"]["kwargs"].items() if k in TINY}
    port = DAC(**kwargs)
    port.load_state_dict(convert.dac_state_dict(flax.serialization.msgpack_restore(blob["params"])))
    assert np.array_equal(PA.compress(port, audio)["codes"], jax_codes)
