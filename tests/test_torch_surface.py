"""The port's signal, DSP, ops and effects surface that completes its first
slice, against the JAX package's on the CPU.

Inputs are at most 2 x 1 x 1 s, made from a seed with numpy. Each
tolerance is the JAX package's own pin for the function: biquads 1e-4
against ``scipy.signal.lfilter`` (tests/core/test_filters_resample.py),
the band split 1e-4 against julius and its partition of unity 1e-6
(tests/parity/test_parity.py), the FFT convolution 1e-4 against a direct
correlation, the time stretch 3e-4 of the largest output
(tests/parity/test_parity.py:281), the resample core's gradient 7e-7
(tests/core/test_filters_resample.py), the equalizer 1e-4 (against the
weighted band sum) and the transforms' outputs 1e-6. Host designs (the
DCT, the wave generator, WAV bytes) are equal bit for bit.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores
from scipy.signal import lfilter

from audiotools_tpu import AudioSignal as JSignal
from audiotools_tpu.core import util as ju
from audiotools_tpu.io import read_wav as j_read_wav
from audiotools_tpu.ops import fft as JF
from audiotools_tpu.ops import filters as JFL
from audiotools_tpu.ops import loudness as JL
from audiotools_tpu.ops import resample as JR
from audiotools_tpu.ops import stretch as JS
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch import io as pio
from audiotools_tpu_torch.core import util as pu
from audiotools_tpu_torch.ops import fft as PF
from audiotools_tpu_torch.ops import filters as PFL
from audiotools_tpu_torch.ops import hopper_kernels as HK
from audiotools_tpu_torch.ops import resample as PR
from tests.fixtures import speech_like

SR = 44100
WIRE_ERR = 2.0 ** -16 * (1 + 1e-6)  # int16 rounding: half a level of 2**-15


def _noise(seed, shape=(2, 1, 8192), scale=0.1):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _speech(seed=0, batch=2, duration=1.0):
    return np.stack([speech_like(seed + i, duration)[None] for i in range(batch)])


def _pair(x):
    return AudioSignal(x.copy(), SR, device="cpu"), JSignal(x.copy(), SR)


def _np(v):
    if isinstance(v, (AudioSignal, JSignal)):
        v = v.audio_data
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _err(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max()


# -- core/util ----------------------------------------------------------------


def test_hz_to_bin_matches_jax():
    hz = np.array([[0.0, 21.5, 440.0], [1000.0, 22049.0, 30000.0]], np.float32)
    got = pu.hz_to_bin(hz, 2048, SR)
    assert got.shape == hz.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ju.hz_to_bin(jnp.asarray(hz), 2048, SR)))


@pytest.mark.parametrize("note", ["C2", "A4", "F#3", "Bb5", "C6", "E!1"])
def test_note_names_match_jax(note):
    assert pu.note_to_midi(note) == ju.note_to_midi(note)
    assert pu.midi_to_hz(pu.note_to_midi(note)) == ju.midi_to_hz(ju.note_to_midi(note))


def test_seed_seeds_python_numpy_and_torch():
    pu.seed(5)
    first = (random.random(), np.random.rand(), torch.rand(1).item())
    pu.seed(5)
    assert (random.random(), np.random.rand(), torch.rand(1).item()) == first
    ju.seed(5)
    assert (random.random(), np.random.rand()) == first[:2]


def test_chdir_returns_on_error(tmp_path):
    here = pu.os.getcwd()
    with pytest.raises(RuntimeError):
        with pu.chdir(tmp_path):
            assert pu.os.getcwd() == str(tmp_path)
            raise RuntimeError
    assert pu.os.getcwd() == here


@pytest.mark.parametrize("n_splits", [None, 1, 2, 3])
def test_collate_splits_like_jax(n_splits):
    x = _noise(1, (5, 1, 100))
    items = [{"signal": AudioSignal(x[i], SR, device="cpu"), "idx": i, "w": np.float32(i / 2)}
             for i in range(5)]
    jitems = [{"signal": JSignal(x[i], SR), "idx": i, "w": np.float32(i / 2)} for i in range(5)]
    got, want = pu.collate(items, n_splits=n_splits), ju.collate(jitems, n_splits=n_splits)
    if n_splits is None:
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _err(g["signal"], w["signal"]) == 0
        np.testing.assert_array_equal(g["idx"], w["idx"])
        np.testing.assert_array_equal(g["w"], w["w"])


def test_dequantize_batch_restores_every_signal_and_clones():
    x = _noise(2, (2, 1, 64))
    sig = AudioSignal(x, SR, device="cpu").quantize_wire()
    noise = AudioSignal(x * 0.5, SR, device="cpu").quantize_wire()
    batch = {"signal": sig, "transform_args": {"BackgroundNoise": {"noise": noise}},
             "pair": (sig, [noise]), "idx": np.arange(2)}
    out = pu.dequantize_batch(batch)
    assert sig.audio_data.dtype == torch.int16  # the input is left as it was
    for got, want in ((out["signal"], x), (out["transform_args"]["BackgroundNoise"]["noise"],
                                           x * 0.5), (out["pair"][0], x), (out["pair"][1][0], x * 0.5)):
        assert got.audio_data.dtype == torch.float32
        assert _err(got, want) <= WIRE_ERR
    assert isinstance(out["pair"], tuple) and out["idx"] is batch["idx"]
    jout = ju.dequantize_batch({"signal": JSignal(x, SR).quantize_wire()})
    assert _err(out["signal"], jout["signal"]) == 0


# -- io -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_read_wav_dtype_matches_jax(tmp_path, dtype):
    path = tmp_path / "a.wav"
    pio.write_wav(path, _noise(3, (2, 500)), SR)
    got, sr = pio.read_wav(path, offset=0.001, duration=0.005, dtype=dtype)
    want, jsr = j_read_wav(path, offset=0.001, duration=0.005, dtype=dtype)
    assert sr == jsr and got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("suffix", [".wav", ".flac", ".mp3", ".ogg", ".m4a"])
def test_save_audio_round_trips_every_format(tmp_path, suffix):
    from audiotools_tpu import native as jnative
    from audiotools_tpu.io import codecs as jcodecs
    from audiotools_tpu.io import load_audio as j_load_audio
    from audiotools_tpu_torch import native as pnative

    needs = {".mp3": jcodecs.mp3_available,
             ".ogg": lambda: jcodecs.vorbis_available() and jcodecs.vorbis_encode_available(),
             ".m4a": lambda: jnative.av_available() and pnative.av_available()}
    if not needs.get(suffix, lambda: True)():
        pytest.skip(f"no system codec library for {suffix}")
    x = _noise(4, (2, 4410), scale=0.2)
    path = tmp_path / f"a{suffix}"
    pio.save_audio(path, x, SR)
    got, sr = pio.load_audio(path)
    want, jsr = j_load_audio(path)
    assert sr == jsr == SR and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if suffix in (".wav", ".flac"):  # lossless: the int16 quantization of the input
        np.testing.assert_array_equal(got, np.clip(np.rint(x * 32768), -32768, 32767) / 32768)
    pio.save_audio(tmp_path / "f.wav", x, SR, subtype="FLOAT")
    np.testing.assert_array_equal(pio.read_wav(tmp_path / "f.wav")[0], x)


# -- core/signal ------------------------------------------------------------------


def test_write_hash_and_path_match_jax(tmp_path):
    x = _noise(5, (2, 1, 1000), scale=0.3)
    p, j = _pair(x)
    p.write(tmp_path / "p.wav")
    j.write(tmp_path / "j.wav")
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    assert p.path_to_input_file == tmp_path / "p.wav"
    assert p.hash() == j.hash()
    with pytest.warns(UserWarning, match="clipped"):
        AudioSignal(x * 10, SR, device="cpu").write(tmp_path / "loud.wav")


@pytest.mark.parametrize("shape", ["sine", "square", "sawtooth", "triangle"])
def test_wave_matches_jax(shape):
    got = AudioSignal.wave(441.3, 0.05, SR, num_channels=2, shape=shape, device="cpu")
    want = JSignal.wave(441.3, 0.05, SR, num_channels=2, shape=shape)
    assert _err(got, want) == 0
    with pytest.raises(ValueError):
        AudioSignal.wave(440, 0.01, SR, shape="noise", device="cpu")


def test_numpy_detach_copies_and_casts():
    x = torch.from_numpy(_noise(6, (2, 1, 64))).requires_grad_(True)
    sig = AudioSignal(x * 2, SR)
    sig.stft(64, 16)
    assert isinstance(sig.numpy(), np.ndarray) and np.allclose(sig.numpy(), x.detach() * 2)
    sig._loudness = (x * 1).sum((1, 2))
    out = sig.copy().detach()
    assert not (out.audio_data.requires_grad or out.stft_data.requires_grad
                or out._loudness.requires_grad)
    deep = out.deepcopy()
    assert deep.audio_data is not out.audio_data and deep == out
    shallow = sig.copy()
    assert shallow.metadata is sig.metadata
    half = AudioSignal(torch.zeros(1, 1, 4, dtype=torch.float16), SR).float()
    assert half.audio_data.dtype == torch.float32
    assert sig.cpu().device.type == "cpu"


def test_quantize_wire_is_idempotent_and_inverted_by_dequantize():
    x = np.concatenate([_noise(7, (1, 1, 200), scale=0.5), np.full((1, 1, 3), 2.0, np.float32)], -1)
    sig = AudioSignal(x, SR, device="cpu")
    sig._loudness = torch.tensor([-20.0])
    once = sig.clone().quantize_wire()
    twice = once.clone().quantize_wire()
    assert once.audio_data.dtype == torch.int16
    assert torch.equal(once.audio_data, twice.audio_data)
    assert once._loudness is sig._loudness
    want = JSignal(x, SR).quantize_wire()
    np.testing.assert_array_equal(once.audio_data.numpy(), np.asarray(want.audio_data))
    back = once.dequantize_wire()
    assert back.audio_data.dtype == torch.float32
    assert _err(back, np.clip(x, -1, 32767 / 32768)) <= WIRE_ERR
    assert back.dequantize_wire() is back and back.audio_data.dtype == torch.float32
    with pytest.raises(ValueError):
        sig.clone().quantize_wire("int8")


@pytest.mark.parametrize("match_stride", [False, True])
def test_stft_padding_and_frame_count_match_jax(match_stride):
    p, j = _pair(_noise(8, (1, 1, 5000)))
    assert p.compute_stft_padding(512, 128, match_stride) == j.compute_stft_padding(
        512, 128, match_stride)
    for length in (5000, 44100, 1):
        assert PF.num_frames(length, 512, 128, match_stride) == JF.num_frames(
            length, 512, 128, match_stride)
    assert PF.num_frames(5000, 512, 128, match_stride) == p.stft(512, 128,
                                                               match_stride=match_stride).shape[-1]


@pytest.mark.parametrize("n_mfcc,n_mels,norm", [(40, 80, "ortho"), (13, 40, "ortho"),
                                                (20, 64, None)])
def test_dct_matches_jax(n_mfcc, n_mels, norm):
    got = AudioSignal.get_dct(n_mfcc, n_mels, norm)
    assert torch.equal(got, torch.from_numpy(np.asarray(JSignal.get_dct(n_mfcc, n_mels, norm))))


def test_mfcc_matches_jax():
    """Signal method and op, relative to the largest coefficient."""
    x = _speech(1)
    p, j = _pair(x)
    want = np.asarray(j.mfcc(40, 80))
    got = p.mfcc(40, 80).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    op = PF.mfcc(torch.from_numpy(x), SR, 13, 40, window_length=1024, hop_length=256).numpy()
    jop = np.asarray(JF.mfcc(jnp.asarray(x), SR, 13, 40, window_length=1024, hop_length=256))
    assert np.abs(op - jop).max() / np.abs(jop).max() < 1e-4


def test_in_place_and_reflected_operators_match_jax():
    x, y = _noise(9, (2, 1, 500)), _noise(10, (2, 1, 500))
    p, j = _pair(x)
    p -= AudioSignal(y, SR, device="cpu")
    j -= JSignal(y, SR)
    assert _err(p, j) == 0
    p *= 0.5
    j *= 0.5
    assert _err(p, j) == 0
    got, want = 2.0 * p, 2.0 * j
    assert isinstance(got, AudioSignal) and _err(got, want) == 0
    assert _err(p, j) == 0  # __rmul__ returns a new signal


def test_text_matches_jax():
    p, j = _pair(_noise(11, (2, 1, 441)))
    p.path_to_file = j.path_to_file = "a.wav"
    for got, want in zip(str(p).splitlines(), str(j).splitlines()):
        key = got.split(":")[0]
        assert key == want.split(":")[0]
        if key != "device":
            assert got == want
    assert p.markdown().splitlines()[:4] == j.markdown().splitlines()[:4]
    table = p.__rich__()
    assert [c.header for c in table.columns] == ["Key", "Value"] and table.row_count == 8


def test_equality_compares_every_tensor():
    x = _noise(12, (2, 1, 300))
    a, b = AudioSignal(x, SR, device="cpu"), AudioSignal(x.copy(), SR, device="cpu")
    assert a == b and not a != b
    b.audio_data = b.audio_data + 1e-3
    assert a != b
    a.stft(64, 16)
    c = AudioSignal(x.copy(), SR, device="cpu")
    assert a != c  # c holds no STFT
    c.stft(64, 16)
    assert a == c
    with pytest.raises(TypeError):
        hash(a)


@pytest.mark.parametrize("key,n", [(0, 1), (2, 1), (slice(0, 2), 2), ([2, 0], 2),
                                   (np.array([True, False, True]), 2),
                                   ((slice(None), 0, slice(10, 20)), None)])
def test_setitem_matches_jax(key, n):
    """A signal into the items ``key`` selects, or samples into a tuple key."""
    x, y = _noise(13, (3, 2, 100)), _noise(14, (3, 2, 100))
    p, j = _pair(x)
    if n is None:
        p[key] = torch.from_numpy(y[:, 0, 10:20])
        j[key] = y[:, 0, 10:20]
    else:
        pv, jv = _pair(y[:n])
        p[key], j[key] = pv, jv
    assert _err(p, j) == 0


def test_setitem_leaves_clones_and_carries_loudness():
    x = _noise(15, (2, 1, 100))
    p = AudioSignal(x, SR, device="cpu")
    p._loudness = torch.tensor([-20.0, -30.0])
    clone = p.clone()
    v = AudioSignal(np.ones((1, 1, 100), np.float32), SR, device="cpu")
    v._loudness = torch.tensor([-5.0])
    p[1] = v
    assert torch.equal(clone.audio_data, torch.from_numpy(x))  # the clone is not changed
    assert torch.equal(p.audio_data[1], torch.ones(1, 100))
    assert p._loudness.tolist() == [-20.0, -5.0]
    one = AudioSignal(x[:1], SR, device="cpu")
    one[np.array(True)] = v
    assert one.audio_data is v.audio_data


# -- ops/filters --------------------------------------------------------------------


def test_fft_conv1d_matches_jax_and_direct():
    x, k = _noise(16, (2, 1, 1024), 1.0), _noise(17, (3, 33), 1.0)
    got = PFL.fft_conv1d(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    assert got.shape == (2, 1, 3, 1024 - 32)
    direct = np.stack([[np.correlate(x[i, 0], k[j], "valid") for j in range(3)] for i in range(2)])
    assert np.abs(got[:, 0] - direct).max() < 1e-4
    assert _err(got, JFL.fft_conv1d(jnp.asarray(x), jnp.asarray(k))) < 1e-4
    assert _err(PFL.fft_conv1d(torch.from_numpy(x), k), got) == 0  # numpy kernels


@pytest.mark.parametrize("n_bands,block_size", [(1, "auto"), (4, "auto"), (6, None), (6, 4096),
                                                (6, "auto")])
def test_split_bands_match_jax_and_sum_to_the_input(n_bands, block_size):
    x = _noise(18, (2, 1, SR // 2))
    got = PFL.split_bands(torch.from_numpy(x), SR, n_bands, block_size=block_size)
    want = JFL.split_bands(jnp.asarray(x), SR, n_bands, block_size=block_size)
    assert got.shape == (2, 1, SR // 2, n_bands)
    assert _err(got, want) < 1e-4
    assert np.abs(got.sum(-1).numpy() - x).max() < 1e-6
    p, j = _pair(x)
    assert _err(p.mel_filterbank(n_bands), j.mel_filterbank(n_bands)) < 1e-4
    with pytest.raises(ValueError):
        PFL.split_bands(torch.from_numpy(x), SR, 0)


def _k_weighting(rate):
    return [(b, a, g) for (b, a), g in JL.design_filters(rate, "K-weighting")]


@pytest.mark.parametrize("b,a", [([0.2, 0.3, 0.1], [1.0, -0.5, 0.25])]
                         + [(b, a) for b, a, _ in _k_weighting(SR)] + [([2.0, 0.5, 0.1],
                                                                         [2.0, -1.6, 0.7])])
def test_biquad_matches_lfilter_and_jax(b, a):
    """The JAX test's filter, both K-weighting stages (the high-pass has a
    double pole near 1), and an ``a[0]`` that is not 1."""
    x = np.random.RandomState(4).randn(3, 4096).astype(np.float32)
    got = PFL.biquad(torch.from_numpy(x), np.array(b), np.array(a)).numpy()
    assert np.abs(got - lfilter(b, a, x, axis=-1)).max() < 1e-4
    if list(b) == [0.2, 0.3, 0.1]:
        want = jax.jit(JFL.biquad)(jnp.asarray(x), jnp.asarray(b), jnp.asarray(a))
        assert _err(got, want) < 1e-4


def test_biquad_cascade_matches_lfilter_and_jax():
    x = _speech(2, duration=0.5)
    stages = _k_weighting(SR)
    got = PFL.biquad_cascade(torch.from_numpy(x), stages).numpy()
    want = x.astype(np.float64)
    for b, a, g in stages:
        want = g * lfilter(b, a, want, axis=-1)
    assert np.abs(got - want).max() < 1e-4
    ab = [([0.2, 0.3, 0.1], [1.0, -0.5, 0.25], 0.5), ([1.0, 0.1, 0.0], [1.0, 0.2, 0.0], 2.0)]
    jcascade = jax.jit(lambda v: JFL.biquad_cascade(
        v, [(jnp.asarray(b), jnp.asarray(a), g) for b, a, g in ab]))
    assert _err(PFL.biquad_cascade(torch.from_numpy(x), ab), jcascade(jnp.asarray(x))) < 1e-4


@pytest.mark.parametrize("conv_method", [None, "pallas", "pallas_interpret", "fft"])
@pytest.mark.parametrize("n_bands", [6, 40])
def test_equalizer_conv_methods_match_jax(conv_method, n_bands):
    """Each route against the JAX package's on the same method (its Pallas
    kernel interpreted for both kernel routes); 40 bands make a FIR too long
    for kernel A, which every method then takes by FFT."""
    x = _noise(19, (2, 1, SR // 2))
    db = np.random.RandomState(20).uniform(-12, 0, (2, n_bands)).astype(np.float32)
    got = PFL.equalizer(torch.from_numpy(x), torch.from_numpy(db), SR, conv_method=conv_method)
    jmethod = {None: "pallas_interpret", "pallas": "pallas_interpret"}.get(conv_method, conv_method)
    want = JFL.equalizer(jnp.asarray(x), jnp.asarray(db), SR, conv_method=jmethod)
    assert _err(got, want) < 1e-4
    p, j = _pair(x)
    assert _err(p.equalizer(db, conv_method=conv_method), got) == 0


def test_equalizer_routes_and_refusals():
    x = torch.from_numpy(_noise(21, (2, 1, 4000)))
    db = torch.zeros(2, 6)
    before = dict(HK.LAUNCHES)
    for method in (None, "pallas", "pallas_interpret", "fft"):
        assert _err(PFL.equalizer(x, db, SR, conv_method=method), x) < 1e-5
    assert HK.LAUNCHES == before  # CPU tensors take the plain versions
    with pytest.raises(ValueError, match="conv_method"):
        PFL.equalizer(x, db, SR, conv_method="pallas_fast")


# -- ops/resample -------------------------------------------------------------------


@pytest.mark.parametrize("old,new", [(55, 49), (49, 55), (3, 2)])
def test_polyphase_conv_diff_and_its_gradient_match_jax(old, new):
    """Forward at the JAX package's precision, and autograd's gradient
    against its custom VJP at 7e-7 of the largest gradient."""
    kernels, width = PR.resample_kernels(old, new)
    T = 3000
    Tp = T + 2 * width + old
    out_len = T * new // old
    xp = _noise(22, (2, Tp), 1.0)
    w = _noise(23, (2, out_len), 1.0)
    f = PR.polyphase_conv_diff(old, new, 24, 0.945, Tp, out_len)
    jf = JR.polyphase_conv_diff(old, new, 24, 0.945, Tp, out_len)
    x = torch.from_numpy(xp).requires_grad_(True)
    y = f(x)
    (y * torch.from_numpy(w)).sum().backward()
    jy, jvjp = jax.vjp(jf, jnp.asarray(xp))
    (jg,) = jvjp(jnp.asarray(w))
    assert _err(y, jy) < 1e-5 * np.abs(np.asarray(jy)).max()
    jg = np.asarray(jg)
    assert np.abs(x.grad.numpy() - jg).max() < 7e-7 * np.abs(jg).max()
    with pytest.raises(ValueError):
        PR.polyphase_conv_diff(old, new, 24, 0.945, Tp, 10 ** 7)


# -- core/_dsp ----------------------------------------------------------------------


@pytest.mark.parametrize("window,hop,preprocess", [(0.1, 0.05, True), (0.1, 0.025, True),
                                                   (0.05, 0.05, False)])
def test_windows_collect_and_overlap_add_match_jax(window, hop, preprocess):
    x = _noise(24, (2, 2, 4410))
    p, j = _pair(x)
    got = p.clone().collect_windows(window, hop, preprocess)
    want = j.clone().collect_windows(window, hop, preprocess)
    assert _err(got, want) == 0
    yielded = list(p.clone().windows(window, hop, preprocess))
    assert len(yielded) == got.batch_size
    assert all(torch.equal(w.audio_data[0], g) for w, g in zip(yielded, got.audio_data))
    if preprocess:
        back = got.overlap_and_add(hop)
        assert _err(back, want.overlap_and_add(hop)) < 1e-7
        assert _err(back, x) < 1e-6


# -- core/_effects ------------------------------------------------------------------


@pytest.mark.parametrize("factor", [0.8, 1.25])
@pytest.mark.parametrize("formulation", ["angle", "phasor", "phasor_fused"])
def test_time_stretch_matches_jax_and_drops_the_stft(factor, formulation):
    """Formulation against the same formulation (they differ after a
    transient zero frame), at 3e-4 of the largest output."""
    x = _speech(3, duration=0.5)
    p, j = _pair(x)
    p.stft()
    out = p.time_stretch(factor, quick=False, pv_formulation=formulation)
    assert out is p and p.stft_data is None
    if formulation == "angle":
        want = j.time_stretch(factor).audio_data
    else:
        jform = "phasor_fused_interpret" if formulation == "phasor_fused" else formulation
        want = JS.time_stretch(jnp.asarray(x), factor, pv_formulation=jform)
    want = np.asarray(want)
    assert p.signal_length == int(round(x.shape[-1] / factor)) == want.shape[-1]
    assert _err(p, want) < 3e-4 * np.abs(want).max()


@pytest.mark.parametrize("kwargs", [dict(preset="8-bit"), dict(), dict(bits_per_sample=8),
                                    dict(encoding="ULAW", bits_per_sample=4)])
def test_apply_codec_wav_presets_match_jax(kwargs):
    x = _speech(4, duration=0.25)
    p, j = _pair(x)
    got, want = p.apply_codec(**kwargs), j.apply_codec(**kwargs)
    if kwargs.get("preset") == "8-bit" or kwargs.get("encoding") == "ULAW":
        # mu-law: log1p and exp round differently by an ulp in a few samples
        assert _err(got, want) < 1e-6
    else:
        assert _err(got, want) == 0


@pytest.mark.parametrize("preset", ["MP3", "Vorbis", "Ogg", "GSM-FR", "Amr-nb"])
def test_apply_codec_compressed_presets_match_jax(preset):
    """MP3, Vorbis and Ogg: the host codecs get the same bytes, so the two
    packages agree bit for bit. GSM-FR and Amr-nb: the resamples to and
    from 8 kHz are each held to the resample's pin (1e-5,
    tests/test_torch_ops.py), and the codec between them, fed one 8 kHz
    input, to the bit; whole, a rounding difference in the resample may
    flip one of the coder's argmins."""
    from audiotools_tpu.io import amrnb as jamrnb
    from audiotools_tpu.io import codecs as jcodecs
    from audiotools_tpu_torch.io import amrnb as pamrnb
    from audiotools_tpu_torch.io import codecs as pcodecs

    available = {"MP3": jcodecs.mp3_available, "GSM-FR": jcodecs.gsm_available,
                 "Amr-nb": lambda: True}.get(
        preset, lambda: jcodecs.vorbis_available() and jcodecs.vorbis_encode_available())
    if not available():
        pytest.skip(f"no system codec library for {preset}")
    x = _speech(25, duration=0.25)
    p, j = _pair(x)
    with pytest.raises(ValueError, match="Unknown preset"):
        p.apply_codec("nope")
    got = p.clone().apply_codec(preset)
    assert got.signal_length == x.shape[-1] and got.audio_data.dtype == torch.float32
    if preset in ("MP3", "Vorbis", "Ogg"):
        assert _err(got, j.apply_codec(preset)) == 0
        return
    roundtrip = {"GSM-FR": (pcodecs.gsm_roundtrip, jcodecs.gsm_roundtrip),
                 "Amr-nb": (pamrnb.amrnb_roundtrip_batch, jamrnb.amrnb_roundtrip_batch)}[preset]
    down, jdown = p.clone().resample(8000), j.clone().resample(8000)
    assert _err(down, jdown) < 1e-5
    host = _np(down)
    if preset == "GSM-FR":
        coded = np.stack([roundtrip[0](item) for item in host])
        jcoded = np.stack([roundtrip[1](item) for item in host])
    else:
        coded, jcoded = roundtrip[0](host), roundtrip[1](host)
    np.testing.assert_array_equal(coded, jcoded)
    up = AudioSignal(coded.astype(np.float32), 8000, device="cpu").resample(SR)
    up.zero_pad(0, max(0, x.shape[-1] - up.signal_length)).truncate_samples(x.shape[-1])
    jup = JSignal(coded.astype(np.float32), 8000).resample(SR)
    jup.zero_pad(0, max(0, x.shape[-1] - jup.signal_length)).truncate_samples(x.shape[-1])
    assert _err(up, jup) < 1e-5
    assert _err(got, up) == 0  # the port's preset is these stages


def test_matmul_convolves_like_jax():
    x, ir = _speech(5, duration=0.25), _noise(26, (2, 1, 500))
    p, j = _pair(x)
    pir, jir = _pair(ir)
    got = p @ pir
    want = j @ jir
    assert got is p and _err(got, want) < 1e-6
