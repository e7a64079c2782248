"""The port's host I/O (``native/``, ``io/``) against the JAX package's on
the CPU.

Both packages build the same C++ sources with the same flags and decode
the same files, so every comparison here is bit for bit: native WAV and
FLAC reads and ``read_batch``, FLAC written by either package and read by
the other, the numpy WAV codec's edge formats (the JAX package's own
blobs, tests/test_wav_codec_edges.py), libav containers, and
hypothesis-drawn corruptions of valid files (no crash; a ``ValueError``
or a decode, and the same outcome in both packages). Clips are at most
0.5 s.
"""
import struct
from dataclasses import astuple

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from audiotools_tpu import native as jnative
from audiotools_tpu.io import audio_info as j_audio_info
from audiotools_tpu.io import load_audio as j_load_audio
from audiotools_tpu.io import wav as JW
from audiotools_tpu_torch import AudioSignal, _build
from audiotools_tpu_torch import io as pio
from audiotools_tpu_torch import native as pnative
from audiotools_tpu_torch.core import util as pu
from audiotools_tpu_torch.io import wav as PW
from tests.test_wav_codec_edges import _wav_bytes

SR = 22050
SUBTYPES = {"mono16": (1, "PCM_16"), "stereo16": (2, "PCM_16"), "mono24": (1, "PCM_24"),
            "mono32": (1, "PCM_32"), "monof32": (1, "FLOAT"), "stereo24": (2, "PCM_24"),
            "stereof32": (2, "FLOAT_32")}


def _noise(seed, shape, scale=0.2):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def jax_native_libraries(tmp_path_factory):
    """The JAX package's WAV, FLAC and libav libraries built for this module
    alone, from the package's sources with its flags. The package builds
    each into its own directory at first use; there another test process
    may still be writing the file while this one loads it, and a library
    that failed to load stays unloaded for the life of the process."""
    root = tmp_path_factory.mktemp("jax_native")
    with pytest.MonkeyPatch.context() as mp:
        for lib, path, tried in (("_lib", "_LIB_PATH", "_tried"),
                                 ("_flac_lib", "_FLAC_LIB_PATH", "_flac_tried"),
                                 ("_av_lib", "_AV_LIB_PATH", "_av_tried")):
            mp.setattr(jnative, path, root / getattr(jnative, path).name)
            mp.setattr(jnative, lib, None)
            mp.setattr(jnative, tried, False)
        assert jnative.available() and jnative.flac_available()
        yield


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_native")
    files = {}
    for i, (name, (ch, subtype)) in enumerate(SUBTYPES.items()):
        data = _noise(i, (ch, SR // 2), 0.1)
        path = root / f"{name}.wav"
        PW.write_wav(path, data, SR, subtype=subtype)
        files[name] = (path, data)
    return files


def _same(got, want):
    (g, gsr), (w, wsr) = got, want
    assert gsr == wsr and g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


# -- the build ------------------------------------------------------------------


def test_host_libraries_build_into_the_ignored_cache():
    for name in ("wavio", "flacio"):
        path = _build.host_library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}-")
    pnative.get_library()
    pnative.get_flac_library()
    assert _build.host_library_path("wavio").exists()
    assert _build.host_library_path("flacio").exists()
    # the port ships sources only
    assert not list((_build.NATIVE).glob("*.so"))
    assert "audiotools_tpu_torch/_build/" in (_build._PKG.parent / ".gitignore").read_text()


def test_flags_and_source_key_the_cache(monkeypatch):
    before = _build.host_library_path("flacio")
    monkeypatch.setitem(_build.HOST_FLAGS, "flacio", _build.HOST_FLAGS["flacio"] + ["-g"])
    assert _build.host_library_path("flacio") != before


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "wavio.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "NATIVE", tmp_path / "src")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(pnative, "_bound", {})
    with pytest.raises(RuntimeError, match=r"g\+\+ failed building wavio(.|\n)*error"):
        pnative.read_wav(tmp_path / "any.wav")
    with pytest.raises(RuntimeError, match="failed building wavio"):
        pio.load_audio(tmp_path / "any.wav")  # no quiet fallback to the numpy reader


def test_av_is_unavailable_where_libav_does_not_link(tmp_path, monkeypatch):
    monkeypatch.setitem(_build.HOST_LIBS, "avio", ["-lno_such_libav_here"])
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(pnative, "_bound", {})
    monkeypatch.setattr(pnative, "_av_missing", None)
    assert pnative.av_available() is False
    with pytest.raises(RuntimeError, match="libav shim unavailable"):
        pnative.read_av(tmp_path / "x.m4a")
    with pytest.raises(ValueError, match="Unsupported audio format"):
        pio.load_audio(tmp_path / "x.m4a")
    with pytest.raises(ValueError, match="Native write support"):
        pio.save_audio(tmp_path / "x.m4a", np.zeros((1, 10), np.float32), SR)


def test_av_availability_matches_jax():
    assert pnative.av_available() == jnative.av_available()


# -- native WAV -------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SUBTYPES))
def test_wav_info_and_read_match_jax(wavs, name):
    path, _ = wavs[name]
    assert pnative.wav_info(path) == jnative.wav_info(path)
    _same(pnative.read_wav(path), jnative.read_wav(path))
    _same(pnative.read_wav(path, offset=0.1, duration=0.2),
          jnative.read_wav(path, offset=0.1, duration=0.2))
    _same(pio.load_audio(path, offset=0.05), j_load_audio(path, offset=0.05))
    assert pio.audio_info(path) == PW.wav_info(path)


@pytest.mark.parametrize("offset,duration", [(0.4, 5.0), (-3.0, 0.1), (0.0, -0.5), (0.6, 0.1)])
def test_wav_clamps_like_jax(wavs, offset, duration):
    path, _ = wavs["stereo16"]
    _same(pnative.read_wav(path, offset, duration), jnative.read_wav(path, offset, duration))


def test_load_audio_takes_g711_to_the_numpy_codec(tmp_path):
    """The port's native reader refuses the format tags it does not decode
    (the JAX package's decodes A-law and mu-law bytes as 8-bit PCM), so
    ``load_audio`` gives the numpy codec's G.711 decode, which is the JAX
    package's numpy codec's to the bit."""
    for tag in (JW.WAVE_FORMAT_MULAW, JW.WAVE_FORMAT_ALAW):
        path = tmp_path / f"g711_{tag}.wav"
        path.write_bytes(_wav_bytes(tag, 8, bytes(range(256))))
        with pytest.raises(ValueError, match="could not parse WAV"):
            pnative.read_wav(path)
        _same(pio.load_audio(path), JW.read_wav(path))
        _same(pio.load_audio(path), PW.read_wav(path))


def test_truncated_stereo_reads_like_jax(wavs, tmp_path):
    src, _ = wavs["stereo16"]
    raw = src.read_bytes()
    path = tmp_path / "trunc.wav"
    path.write_bytes(raw[: PW.wav_info(src).data_offset + (SR // 3) * 4])
    _same(pnative.read_wav(path), jnative.read_wav(path))
    got, _ = pnative.read_batch([path], [0.0], [0.5])
    want, _ = jnative.read_batch([path], [0.0], [0.5])
    np.testing.assert_array_equal(got[0], want[0])
    assert np.abs(got[0][:, SR // 3:]).max() == 0


# -- read_batch ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mixed")
    paths = []
    for i in range(6):
        x = _noise(10 + i, (1 + i % 2, 8000))
        if i % 3 == 1:
            path = root / f"m{i}.flac"
            pnative.write_flac(path, x, 16000, bits=24 if i == 4 else 16)
        else:
            path = root / f"m{i}.wav"
            pio.save_audio(path, x, 16000, subtype="FLOAT" if i % 2 else "PCM_16")
        paths.append(path)
    return paths


@pytest.mark.parametrize("offset,duration,threads", [(0.1, 0.25, 0), (0.4, 0.25, 2),
                                                     (0.0, 0.5, 1), (-1.0, 0.1, 3)])
def test_read_batch_matches_jax_and_single_reads(mixed, offset, duration, threads):
    n = len(mixed)
    got, srs = pnative.read_batch(mixed, [offset] * n, [duration] * n, n_threads=threads)
    want, jsrs = jnative.read_batch(mixed, [offset] * n, [duration] * n, n_threads=threads)
    assert srs == jsrs == [16000] * n
    for g, w, path in zip(got, want, mixed):
        np.testing.assert_array_equal(g, w)
        one, _ = pio.load_audio(path, offset=max(offset, 0.0), duration=duration)
        np.testing.assert_array_equal(g[:, : one.shape[-1]], one)
        assert not g[:, one.shape[-1]:].any()  # zero-padded past the end


def test_read_batch_reports_the_failing_item(mixed, tmp_path):
    with pytest.raises(ValueError, match="could not parse|item"):
        pnative.read_batch([mixed[0], tmp_path / "missing.wav"], [0, 0], [0.1, 0.1])


# -- FLAC ------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("channels", [1, 2])
def test_flac_written_by_either_package_decodes_alike(tmp_path, bits, channels):
    x = _noise(20 + bits + channels, (channels, SR // 3), 0.3)
    x[:, :100] = 0.0  # a constant run (the encoder's CONSTANT subframes)
    ours, theirs = tmp_path / "p.flac", tmp_path / "j.flac"
    pnative.write_flac(ours, x, SR, bits=bits)
    jnative.write_flac(theirs, x, SR, bits=bits)
    assert ours.read_bytes() == theirs.read_bytes()
    scale = float(1 << (bits - 1))
    lossless = np.clip(np.rint(x * scale), -scale, scale - 1) / scale
    for path in (ours, theirs):
        assert pnative.flac_info(path) == jnative.flac_info(path) == (SR, x.shape[1], channels,
                                                                      bits)
        _same(pnative.read_flac(path), jnative.read_flac(path))
        np.testing.assert_array_equal(pnative.read_flac(path)[0], lossless.astype(np.float32))
        _same(pnative.read_flac(path, 0.1, 0.05), jnative.read_flac(path, 0.1, 0.05))
        _same(pio.load_audio(path, 0.02, 0.1), j_load_audio(path, 0.02, 0.1))
        info = pio.audio_info(path)
        assert (info.num_frames, info.num_channels, info.bits_per_sample) == (x.shape[1], channels,
                                                                              bits)


def test_save_audio_flac_subtype_picks_the_depth(tmp_path):
    x = _noise(30, (1, 1000))
    pio.save_audio(tmp_path / "a.flac", x, SR, subtype="PCM_24")
    assert pio.audio_info(tmp_path / "a.flac").bits_per_sample == 24
    sig = AudioSignal(x, SR, device="cpu").write(tmp_path / "b.flac")
    assert sig.path_to_file == tmp_path / "b.flac"
    loaded = AudioSignal(tmp_path / "b.flac", device="cpu")
    assert loaded.sample_rate == SR and loaded.signal_length == 1000
    assert pu.info(tmp_path / "b.flac").num_frames == 1000


def test_find_audio_collects_every_format(tmp_path):
    for ext in (".wav", ".flac", ".mp3", ".ogg", ".txt"):
        (tmp_path / f"a{ext}").write_bytes(b"")
    from audiotools_tpu.core import util as ju

    assert sorted(p.name for p in pu.find_audio(tmp_path)) == sorted(
        p.name for p in ju.find_audio(tmp_path))


# -- the numpy WAV codec: edge formats -------------------------------------------------


EDGE_BLOBS = {
    "ulaw": _wav_bytes(JW.WAVE_FORMAT_MULAW, 8, bytes(range(256))),
    "alaw": _wav_bytes(JW.WAVE_FORMAT_ALAW, 8, bytes(range(256))),
    "extensible": _wav_bytes(JW.WAVE_FORMAT_EXTENSIBLE, 16,
                             np.array([1000, -1000], "<i2").tobytes(), fmt_size=40,
                             extra=struct.pack("<HHI16s", 22, 16, 0,
                                               struct.pack("<H", 1) + b"\x00" * 14)),
    "rf64": _wav_bytes(JW.WAVE_FORMAT_PCM, 16, np.array([1000, -1000, 0, 500], "<i2").tobytes(),
                       data_size=0xFFFFFFFF, riff=b"RF64",
                       ds64=struct.pack("<QQQI", 0, 8, 4, 0)),
    "not_riff": b"RIFX" + b"\x00" * 20,
    "zero_rate": _wav_bytes(JW.WAVE_FORMAT_PCM, 16, b"", sr=0),
    "no_ds64": _wav_bytes(JW.WAVE_FORMAT_PCM, 16, b"", data_size=0xFFFFFFFF, riff=b"RF64"),
    "sub_byte": _wav_bytes(JW.WAVE_FORMAT_PCM, 4, b"\x00"),
    "pcm48": _wav_bytes(JW.WAVE_FORMAT_PCM, 48, b"\x00" * 6),
    "float16": _wav_bytes(JW.WAVE_FORMAT_IEEE_FLOAT, 16, b"\x00" * 2),
    "unknown_tag": _wav_bytes(0x0050, 16, b"\x00" * 2),
}


def _outcome(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("name", list(EDGE_BLOBS))
def test_wav_edge_formats_match_jax(tmp_path, name):
    """``load_audio`` and the numpy codec give the JAX package's numpy
    codec's decode, or its error."""
    path = tmp_path / f"{name}.wav"
    path.write_bytes(EDGE_BLOBS[name])
    want = _outcome(JW.read_wav, path)
    for got in (_outcome(PW.read_wav, path), _outcome(pio.load_audio, path)):
        if isinstance(want, str):
            assert got == want
        else:
            _same(got, want)


@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE", "FLOAT_64"])
def test_wav_writer_bytes_match_jax(tmp_path, subtype):
    x = _noise(40, (2, 300), 0.5)
    PW.write_wav(tmp_path / "p.wav", x, SR, subtype=subtype)
    JW.write_wav(tmp_path / "j.wav", x, SR, subtype=subtype)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    with pytest.raises(ValueError, match="subtype"):
        PW.write_wav(tmp_path / "x.wav", x, SR, subtype="PCM_12")


# -- libav containers -------------------------------------------------------------


@pytest.fixture
def av():
    if not (pnative.av_available() and jnative.av_available()):
        pytest.skip("no system libavformat/libavcodec")


@pytest.mark.parametrize("suffix", [".m4a", ".mp4", ".aac"])
def test_av_containers_decode_like_jax(tmp_path, av, suffix):
    x = _noise(50, (2, SR // 2), 0.2)
    ours, theirs = tmp_path / f"p{suffix}", tmp_path / f"j{suffix}"
    pnative.write_av(ours, x, SR)
    jnative.write_av(theirs, x, SR)
    for path in (ours, theirs):
        assert pnative.av_info(path) == jnative.av_info(path)
        _same(pnative.read_av(path), jnative.read_av(path))
        _same(pio.load_audio(path, offset=0.1, duration=0.2),
              j_load_audio(path, offset=0.1, duration=0.2))
        assert astuple(pio.audio_info(path)) == astuple(j_audio_info(path))
    _same(pnative.read_av(ours), pnative.read_av(theirs))  # the encoders agree too


def test_av_unknown_bytes_fail_cleanly(tmp_path, av):
    path = tmp_path / "junk.mkv"
    path.write_bytes(b"\x00garbage" * 100)
    with pytest.raises(ValueError, match="libav"):
        pio.load_audio(path)
    with pytest.raises(ValueError, match="libav"):
        pio.audio_info(path)


# -- malformed files: the port's native decoders never crash --------------------------


def _base_wav():
    t = np.arange(2000) / 8000.0
    x = np.stack([0.5 * np.sin(2 * np.pi * 440 * t), 0.3 * np.sin(2 * np.pi * 220 * t)])
    pcm = np.clip(np.rint(x.T * 32768), -32768, 32767).astype("<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, 8000, 32000, 4, 16)
            + b"data" + struct.pack("<I", len(pcm)) + pcm), x.astype(np.float32)


def _base_flac(tmp_path_factory=None):
    import tempfile
    from pathlib import Path

    wav, x = _base_wav()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "base.flac"
        pnative.write_flac(path, x, 8000)
        return path.read_bytes()


BASES = {".wav": _base_wav()[0]}
MUTATION = st.tuples(st.integers(0, 4), st.integers(0, 2 ** 31 - 1), st.integers(1, 255),
                     st.binary(min_size=1, max_size=64))


def _mutate(base: bytes, mutation) -> bytes:
    kind, at, value, junk = mutation
    d = bytearray(base)
    p = at % len(d)
    if kind == 0:  # one byte flipped
        d[p] ^= value
    elif kind == 1:  # a burst overwritten
        d[p: p + len(junk)] = junk[: len(d) - p]
    elif kind == 2:  # truncated
        d = d[: max(8, p)]
    elif kind == 3:  # the header area
        d[p % min(128, len(d))] = value
    else:  # garbage spliced in
        d = d[:p] + junk + d[p:]
    return bytes(d)


def _decode(path, load, info):
    try:
        info(path)
        return load(path, duration=1.0)
    except (ValueError, RuntimeError, MemoryError, OverflowError) as e:
        return type(e).__name__


@pytest.mark.parametrize("suffix", [".wav", ".flac"])
def test_malformed_files_raise_or_decode(tmp_path, suffix):
    """Every corruption decodes or raises a Python error (never a crash).
    FLAC, and WAV wherever the port's native reader accepts the header,
    decode to the JAX package's bits (the two share the decoders)."""
    base = BASES[".wav"] if suffix == ".wav" else _base_flac()
    path = tmp_path / f"fuzz{suffix}"

    @settings(max_examples=60, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.function_scoped_fixture])
    @given(MUTATION)
    def check(mutation):
        path.write_bytes(_mutate(base, mutation))
        got = _decode(path, pio.load_audio, pio.audio_info)
        if isinstance(got, str):
            assert got in ("ValueError", "RuntimeError", "MemoryError", "OverflowError")
            if suffix == ".flac":
                assert _decode(path, j_load_audio, j_audio_info) == got
            return
        assert got[0].dtype == np.float32 and got[0].ndim == 2
        native_ok = suffix == ".flac" or not isinstance(_outcome(pnative.read_wav, path), str)
        if native_ok:
            _same(got, _decode(path, j_load_audio, j_audio_info))

    check()
