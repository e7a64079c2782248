"""The port's host codecs (``io/codecs.py``, ``io/amrnb.py``) and its
``apply_codec`` presets against the JAX package's on the CPU.

The two packages bind the same system libraries (libmp3lame, libmpg123,
libvorbis*, libgsm) and carry the same numpy ACELP coder, so a codec fed
the same samples gives the same bits: MP3 and Ogg files, their decodes,
GSM and AMR-NB round trips, AMR-NB bitstreams. A preset whose library is
absent skips, as the JAX package's tests do. Clips are at most 0.5 s.
"""
import struct

import numpy as np
import pytest
import scipy.signal as ss
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from audiotools_tpu import AudioSignal as JSignal
from audiotools_tpu.io import amrnb as jamrnb
from audiotools_tpu.io import codecs as jcodecs
from audiotools_tpu.io import load_audio as j_load_audio
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch import io as pio
from audiotools_tpu_torch.io import amrnb as pamrnb
from audiotools_tpu_torch.io import codecs as pcodecs
from tests.fixtures import speech_like
from tests.test_amrnb import _voiced

SR = 44100
mp3 = pytest.mark.skipif(not jcodecs.mp3_available(), reason="no mp3 libraries")
vorbis = pytest.mark.skipif(
    not (jcodecs.vorbis_available() and jcodecs.vorbis_encode_available()),
    reason="no vorbis libraries")
gsm = pytest.mark.skipif(not jcodecs.gsm_available(), reason="no libgsm")


def _speech(seed, channels=1, duration=0.5, sr=SR):
    return np.stack([speech_like(seed + c, duration, sr) for c in range(channels)])


def _same(got, want):
    (g, gsr), (w, wsr) = got, want
    assert gsr == wsr and g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


def test_availability_matches_jax():
    for name in ("mp3_available", "vorbis_available", "vorbis_encode_available",
                 "gsm_available"):
        assert getattr(pcodecs, name)() == getattr(jcodecs, name)(), name
    assert pamrnb.amrnb_available() and pamrnb.bitrate() == jamrnb.bitrate()


def test_ctypes_layouts_are_the_jax_packages():
    for name in ("_VorbisInfo", "_OggPacket", "_OggPage"):
        mine, theirs = getattr(pcodecs, name), getattr(jcodecs, name)
        assert mine._fields_ == theirs._fields_ and ctypes_size(mine) == ctypes_size(theirs)


def ctypes_size(struct_type):
    import ctypes

    return ctypes.sizeof(struct_type)


# -- MP3 ----------------------------------------------------------------------------


@mp3
@pytest.mark.parametrize("kwargs", [{}, {"bitrate": 64}, {"vbr_quality": 9}, {"vbr_quality": 2}])
@pytest.mark.parametrize("channels,sr", [(1, SR), (2, 22050)])
def test_mp3_files_and_decodes_match_jax(tmp_path, kwargs, channels, sr):
    x = _speech(1, channels, sr=sr)
    ours, theirs = tmp_path / "p.mp3", tmp_path / "j.mp3"
    pcodecs.write_mp3(ours, x, sr, **kwargs)
    jcodecs.write_mp3(theirs, x, sr, **kwargs)
    assert ours.read_bytes() == theirs.read_bytes()
    _same(pcodecs.read_mp3(ours), jcodecs.read_mp3(ours))
    _same(pcodecs.read_mp3(ours, offset=0.1, duration=0.2),
          jcodecs.read_mp3(ours, offset=0.1, duration=0.2))
    _same(pio.load_audio(ours), j_load_audio(ours))
    assert pio.audio_info(ours).num_frames == pcodecs.read_mp3(ours)[0].shape[-1]


@mp3
def test_mp3_signal_io(tmp_path):
    sig = AudioSignal(_speech(2)[None], SR, device="cpu")
    sig.write(tmp_path / "x.mp3")
    loaded = AudioSignal(tmp_path / "x.mp3", device="cpu")
    jloaded = JSignal(tmp_path / "x.mp3")
    assert loaded.sample_rate == SR and loaded.num_channels == 1
    np.testing.assert_array_equal(loaded.audio_data.numpy(), np.asarray(jloaded.audio_data))


# -- Ogg/Vorbis ---------------------------------------------------------------------------


@vorbis
@pytest.mark.parametrize("quality", [-0.1, 0.3, 1.0])
@pytest.mark.parametrize("channels", [1, 2])
def test_ogg_decodes_match_jax(tmp_path, quality, channels):
    x = _speech(3, channels)
    ours, theirs = tmp_path / "p.ogg", tmp_path / "j.ogg"
    pcodecs.write_ogg(ours, x, SR, quality)
    jcodecs.write_ogg(theirs, x, SR, quality)
    for path in (ours, theirs):
        _same(pcodecs.read_ogg(path), jcodecs.read_ogg(path))
        _same(pcodecs.read_ogg(path, offset=0.1, duration=0.2),
              jcodecs.read_ogg(path, offset=0.1, duration=0.2))
        _same(pio.load_audio(path), j_load_audio(path))
    # the encoders agree on the audio (the stream serial may differ)
    _same(pcodecs.read_ogg(ours), jcodecs.read_ogg(theirs))
    assert pcodecs.read_ogg(ours)[0].shape == x.shape  # sample-accurate


# -- GSM and AMR-NB --------------------------------------------------------------------


@gsm
@pytest.mark.parametrize("shape", [(1, 8000), (2, 4001), (160,)])
def test_gsm_roundtrip_matches_jax(shape):
    x = (np.random.RandomState(4).randn(*shape) * 0.2).astype(np.float32)
    got, want = pcodecs.gsm_roundtrip(x), jcodecs.gsm_roundtrip(x)
    assert got.shape == x.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


AMR_ITEMS = {
    "voiced": lambda: _voiced(0.5),
    "voiced_high": lambda: _voiced(0.5, f0=180.0),
    "tone": lambda: 0.3 * np.sin(2 * np.pi * 220 * np.arange(4000) / 8000),
    "silence": lambda: np.zeros(4000),
    "full_scale": lambda: np.sign(np.sin(2 * np.pi * 50 * np.arange(4000) / 8000)),
    "noise": lambda: np.random.RandomState(5).randn(4000) * 0.1,
}


@pytest.mark.parametrize("name", list(AMR_ITEMS))
def test_amrnb_bitstream_and_decode_match_jax(name):
    x = np.asarray(AMR_ITEMS[name](), np.float32)
    stream = pamrnb.encode(x)
    assert stream == jamrnb.encode(x)
    np.testing.assert_array_equal(pamrnb.decode(stream), jamrnb.decode(stream))
    np.testing.assert_array_equal(pamrnb.amrnb_roundtrip(x), jamrnb.amrnb_roundtrip(x))


def test_amrnb_batch_matches_jax_and_the_scalar_coder():
    items = np.stack([np.asarray(f(), np.float32) for f in AMR_ITEMS.values()])
    streams = pamrnb.encode_batch(items)
    assert streams == jamrnb.encode_batch(items)
    out = pamrnb.decode_batch(streams)
    np.testing.assert_array_equal(out, jamrnb.decode_batch(streams))
    for i, item in enumerate(items):
        assert streams[i] == pamrnb.encode(item)
    batch = items.reshape(3, 2, -1)
    np.testing.assert_array_equal(pamrnb.amrnb_roundtrip_batch(batch),
                                  jamrnb.amrnb_roundtrip_batch(batch))


def test_amrnb_rejects_what_the_jax_package_rejects():
    for call in (lambda m: m.encode_batch(np.zeros((2, 3, 4))),
                 lambda m: m.decode_batch([m.encode(np.zeros(160)), m.encode(np.zeros(320))]),
                 lambda m: m.decode(b"JUNK" + m.encode(np.zeros(320))[4:]),
                 lambda m: m.decode(b"ATNB" + struct.pack("<I", 1 << 31))):
        with pytest.raises(ValueError):
            call(pamrnb)
        with pytest.raises(ValueError):
            call(jamrnb)
    assert pamrnb.decode_batch([]).shape == (0, 0)


AMR_BASE = pamrnb.encode((0.4 * np.sin(2 * np.pi * 300 * np.arange(4000) / 8000))
                         .astype(np.float32))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.integers(0, len(AMR_BASE) - 1), st.integers(1, 255), st.integers(8, len(AMR_BASE)))
def test_amrnb_corrupted_streams_decode_like_jax(at, flip, keep):
    blob = bytearray(AMR_BASE)
    blob[at] ^= flip
    blob = bytes(blob[:keep])
    outcome = []
    for module in (pamrnb, jamrnb):
        try:
            outcome.append(module.decode(blob))
        except (ValueError, MemoryError, OverflowError) as e:
            outcome.append(type(e).__name__)
    if isinstance(outcome[1], str):
        assert outcome[0] == outcome[1]
    else:
        np.testing.assert_array_equal(outcome[0], outcome[1])
        assert outcome[0].dtype == np.float32


# -- compressed files: corruption raises or decodes, as in the JAX package --------------


@pytest.mark.parametrize("suffix", [".mp3", ".ogg"])
def test_corrupted_compressed_files_load_like_jax(tmp_path, suffix):
    if suffix == ".mp3" and not jcodecs.mp3_available():
        pytest.skip("no mp3 libraries")
    if suffix == ".ogg" and not (jcodecs.vorbis_available() and jcodecs.vorbis_encode_available()):
        pytest.skip("no vorbis libraries")
    base_path = tmp_path / f"base{suffix}"
    pio.save_audio(base_path, _speech(6, 2, 0.25, 8000), 8000)
    base = base_path.read_bytes()
    path = tmp_path / f"fuzz{suffix}"

    @settings(max_examples=30, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.function_scoped_fixture])
    @given(st.integers(0, len(base) - 1), st.binary(min_size=1, max_size=32))
    def check(at, junk):
        path.write_bytes(base[:at] + junk + base[at + len(junk):])
        outcome = []
        for load in (pio.load_audio, j_load_audio):
            try:
                outcome.append(load(path, duration=1.0))
            except (ValueError, RuntimeError, MemoryError, OverflowError) as e:
                outcome.append(type(e).__name__)
        if isinstance(outcome[1], str):
            assert outcome[0] == outcome[1]
        else:
            _same(outcome[0], outcome[1])

    check()


# -- apply_codec --------------------------------------------------------------------


def _pair(x, sr=SR):
    return AudioSignal(x.copy(), sr, device="cpu"), JSignal(x.copy(), sr)


@mp3
@pytest.mark.parametrize("kwargs", [dict(format="mp3"), dict(format="mp3", compression=96),
                                    dict(format="mp3", compression=-4.5)])
def test_apply_codec_mp3_options_match_jax(kwargs):
    x = np.stack([_speech(7 + i, 2, 0.25) for i in range(2)])
    p, j = _pair(x)
    got = p.apply_codec(**kwargs)
    assert got is p and got.shape == x.shape and got.device.type == "cpu"
    np.testing.assert_array_equal(got.audio_data.numpy(), np.asarray(j.apply_codec(**kwargs)
                                                                     .audio_data))


@mp3
def test_mp3_preset_is_aligned_and_heavier_than_the_default():
    x = np.stack([_speech(9 + i) for i in range(2)])
    p, _ = _pair(x)
    preset = p.clone().apply_codec("MP3").audio_data.numpy()
    default = p.clone().apply_codec(format="mp3").audio_data.numpy()
    for i in range(2):
        assert np.corrcoef(preset[i, 0], x[i, 0])[0, 1] > 0.9
    assert np.abs(preset - x).mean() > 1.5 * np.abs(default - x).mean()


@vorbis
@pytest.mark.parametrize("kwargs", [dict(format="ogg"), dict(format="vorbis", compression=5),
                                    dict(format="ogg", compression=-3)])
def test_apply_codec_vorbis_options_match_jax(kwargs):
    x = np.stack([_speech(11 + i, 1, 0.25) for i in range(2)])
    p, j = _pair(x)
    got = p.apply_codec(**kwargs)
    np.testing.assert_array_equal(got.audio_data.numpy(), np.asarray(j.apply_codec(**kwargs)
                                                                     .audio_data))


@pytest.mark.parametrize("preset", ["GSM-FR", "Amr-nb"])
@pytest.mark.parametrize("sr", [16000, 22050])
def test_telephone_presets_keep_rate_and_length(preset, sr):
    if preset == "GSM-FR" and not jcodecs.gsm_available():
        pytest.skip("no libgsm")
    x = ss.resample_poly(_voiced(0.5), sr, 8000)[None, None].astype(np.float32)
    p, _ = _pair(x, sr)
    out = p.clone().apply_codec(preset)
    assert out.sample_rate == sr and out.signal_length == x.shape[-1]
    assert out.audio_data.dtype == torch.float32
    assert np.abs(out.audio_data.numpy() - x).max() > 1e-3  # the codec altered it


def test_missing_libraries_and_unknown_formats_raise(monkeypatch):
    p = AudioSignal(_speech(13, 1, 0.1)[None], SR, device="cpu")
    with pytest.raises(RuntimeError, match="Codec format 'aac'"):
        p.clone().apply_codec(format="aac")
    for name, preset in (("mp3_available", "MP3"), ("gsm_available", "GSM-FR"),
                         ("vorbis_available", "Ogg")):
        monkeypatch.setattr(pcodecs, name, lambda: False)
        with pytest.raises(RuntimeError, match="not available"):
            p.clone().apply_codec(preset)
    with pytest.raises(ValueError, match="Unknown preset"):
        p.apply_codec("AAC")
