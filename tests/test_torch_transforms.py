"""The port's transform zoo against the JAX package's on the CPU.

Every leaf transform draws the same parameters from the same seeds in both
packages (``np.array_equal``; the loaded and metered signals to 1e-6, as
tests/test_torch_slice.py holds them) and then gives the same output, with
a mask that mixes applied and untouched items. The framework (``Choose``'s
one-hot masks, ``Repeat``, ``RepeatUpTo``, ``Compose.filter``,
``apply_mask``, ``batch_instantiate``, ``Identity``, ``SpectralTransform``)
is held to the JAX package's the same way, and the whole zoo chain (the
card tests' ``make_zoo_dataset``) runs through both datasets and is
compared transform by transform on the same input.

Tolerance: 1e-6 absolute on the audio, the JAX package's pin for applying
a transform (tests/data/test_transforms.py:68,146). A transform that meters
loudness while it runs (mixing at an SNR, normalizing, the spectral gate's
noise) is held to 1e-4, the JAX package's pin between two evaluations of
one transform (tests/data/test_transforms.py:83-88, batch against single
item; also its regression snapshots' pin): the two packages' meters round
differently, and a gain moves with the level they read.
"""
import jax
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu import AudioSignal as JSignal
from audiotools_tpu.core import util as ju
from audiotools_tpu.data import transforms as jt
from audiotools_tpu.data.datasets import AudioDataset as JDataset
from audiotools_tpu.data.datasets import AudioLoader as JLoader
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch.core import util as pu
from audiotools_tpu_torch.core.signal import STFTParams
from audiotools_tpu_torch.data import transforms as pt
from audiotools_tpu_torch.data.datasets import AudioDataset as PDataset
from audiotools_tpu_torch.data.datasets import AudioLoader as PLoader
from tests.fixtures import speech_like

SR = 44100
ATOL = 1e-6
METERED = {"BackgroundNoise", "CrossTalk", "VolumeNorm", "SpectralDenoising"}
SOURCES = {"BackgroundNoise": "nz.csv", "CrossTalk": "spk.csv", "RoomImpulseResponse": "ir.csv"}
FRAMEWORK = {"BaseTransform", "SpectralTransform", "Compose", "Choose", "Repeat", "RepeatUpTo",
             "Identity"}
LEAVES = sorted(x for x in dir(jt) if isinstance(getattr(jt, x), type)
                and issubclass(getattr(jt, x), jt.BaseTransform) and x not in FRAMEWORK)


def _make(module, name, audio_dir, **kwargs):
    if name in SOURCES:
        kwargs["sources"] = [str(audio_dir / SOURCES[name])]
    return getattr(module, name)(**kwargs)


def _signals(seed=0, batch=2, lead=0):
    """The item signal instantiate sees, and the batch the transforms get,
    for each package; ``lead`` samples of digital silence start each clip."""
    x = np.stack([speech_like(seed + i, 1.0)[None] for i in range(batch)])
    x[..., :lead] = 0.0
    loud = float(AudioSignal(x[:1].copy(), SR, device="cpu").loudness()[0])
    item_p, item_j = AudioSignal(x[:1].copy(), SR, device="cpu"), JSignal(x[:1].copy(), SR)
    for item in (item_p, item_j):
        item.metadata["loudness"] = loud
    return item_p, item_j, AudioSignal(x.copy(), SR, device="cpu"), JSignal(x.copy(), SR)


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _same_draws(pkw, jkw):
    """Every drawn value equal; signals (loaded or metered) within 1e-6."""
    jkw = jax.tree_util.tree_map(np.asarray, jkw)
    pflat, jflat = pu.flatten(pkw), pu.flatten(jkw)
    assert sorted(pflat) == sorted(jflat)
    for key, want in jflat.items():
        got = pflat[key]
        if hasattr(want, "audio_data"):
            assert np.abs(got.audio_data.numpy() - np.asarray(want.audio_data)).max() < 1e-6, key
        elif isinstance(want, list):
            assert np.array_equal(np.asarray([bool(v) for v in got]),
                                  np.asarray([bool(np.asarray(v)) for v in want])), key
        elif key[-1] == "mask":
            assert np.array_equal(_host(got), np.asarray(want) & np.ones_like(_host(got))), key
        else:
            assert np.array_equal(_host(got), np.asarray(want)), key


def _mixed_states(transform, item, name, batch=2):
    """The first run of seeds whose masks for ``name`` mix true and false."""
    for start in range(0, 200, batch):
        states = list(range(start, start + batch))
        mask = np.asarray(transform.batch_instantiate(states, item)[name]["mask"])
        if 0 < mask.sum() < batch:
            return states
    raise AssertionError("no mixed mask in 200 seeds")


def _err(p, j):
    return np.abs(p.audio_data.numpy() - np.asarray(j.audio_data)).max()


@pytest.mark.parametrize("name", LEAVES)
def test_leaf_matches_jax_under_a_mixed_mask(name, audio_dir):
    """Same seeds, same parameters, same output; the masked-out item is
    returned untouched (for a spectral transform: through the STFT and its
    inverse)."""
    ptf, jtf = _make(pt, name, audio_dir, prob=0.5), _make(jt, name, audio_dir, prob=0.5)
    item_p, item_j, batch_p, batch_j = _signals()
    states = _mixed_states(ptf, item_p, name)
    pkw, jkw = ptf.batch_instantiate(states, item_p), jtf.batch_instantiate(states, item_j)
    _same_draws(pkw, jkw)
    got, want = ptf(batch_p.clone(), **pkw), jtf(batch_j.clone(), **jkw)
    assert got.audio_data.shape == batch_p.audio_data.shape
    assert _err(got, want) < (1e-4 if name in METERED else ATOL)
    off = int(np.flatnonzero(~pkw[name]["mask"])[0])
    untouched = batch_p.clone()
    if isinstance(ptf, pt.SpectralTransform):
        untouched.stft()
        untouched.istft()
    assert torch.equal(got.audio_data[off], untouched.audio_data[off])


# 20,000 samples of digital silence at the start of each 1 s clip: frames
# whose STFT cells are exactly zero, and whose phase the noise fills read
SILENT_LEAD = 20000


def _applied(name, audio_dir, lead, **kwargs):
    """One transform from the same seeds through both packages, under a
    mixed mask, on clips led by ``lead`` samples of silence."""
    ptf, jtf = (_make(m, name, audio_dir, prob=0.5, **kwargs) for m in (pt, jt))
    item_p, item_j, batch_p, batch_j = _signals(lead=lead)
    states = _mixed_states(ptf, item_p, name)
    pkw, jkw = ptf.batch_instantiate(states, item_p), jtf.batch_instantiate(states, item_j)
    _same_draws(pkw, jkw)
    return ptf(batch_p.clone(), **pkw), jtf(batch_j.clone(), **jkw), batch_p, pkw


@pytest.mark.parametrize("lead", [0, SILENT_LEAD])
def test_room_impulse_response_with_original_phase_matches_jax(lead, audio_dir):
    """F4: ``RoomImpulseResponse(use_original_phase=True)`` from one seed
    through both packages, with and without a silent lead, over every
    sample at ``apply_ir``'s pin (1e-5: the dry phase of a quiet cell is
    ill-conditioned and the wet magnitude scales its rounding)."""
    got, want, batch_p, pkw = _applied("RoomImpulseResponse", audio_dir, lead,
                                       use_original_phase=True)
    assert got.audio_data.shape == batch_p.audio_data.shape
    assert _err(got, want) < 1e-5
    plain = _make(pt, "RoomImpulseResponse", audio_dir, prob=0.5)(batch_p.clone(), **pkw)
    on = int(np.flatnonzero(pkw["RoomImpulseResponse"]["mask"])[0])
    assert float((got.audio_data[on] - plain.audio_data[on]).abs().max()) > 1e-3


@pytest.mark.parametrize("name", ["TimeNoise", "FrequencyNoise"])
def test_noise_fill_over_digital_silence_matches_jax(name, audio_dir):
    """F5: over digital silence every exactly-zero cell reads phase 0 and is
    filled, in both packages, whatever sign the FFT gave its zeros; at the
    transforms' pin, over every sample."""
    got, want, batch_p, pkw = _applied(name, audio_dir, SILENT_LEAD)
    assert _err(got, want) < ATOL
    on = int(np.flatnonzero(pkw[name]["mask"])[0])
    silent = batch_p.clone().stft()[on] == 0
    assert int(silent.sum()) > 1000  # the lead's cells, filled with noise
    assert float(got.audio_data[on, :, : SILENT_LEAD // 2].abs().max()) > 1e-2


def test_the_port_has_every_transform_class():
    names = {x for x in dir(jt) if isinstance(getattr(jt, x), type)
             and issubclass(getattr(jt, x), jt.BaseTransform)}
    assert len(names) == 32 and len(LEAVES) == 25
    for x in names:
        assert issubclass(getattr(pt, x), pt.BaseTransform), x


def test_choose_draws_the_same_one_hot_masks(audio_dir):
    """Children's masks are rewritten to one-hot after their own draws, and
    a child of probability 1 still honours its rewritten mask."""
    def make(m):
        return m.Choose(m.VolumeChange(("const", -20.0)), m.Silence(prob=1.0),
                        m.LowPass(prob=0.5), weights=[0.5, 0.3, 0.2])

    ptf, jtf = make(pt), make(jt)
    assert all(t._force_masked for t in ptf.transforms)
    item_p, item_j, batch_p, batch_j = _signals(1, batch=4)
    picked = set()
    for seed in range(12):
        pkw, jkw = ptf.instantiate(seed, item_p), jtf.instantiate(seed, item_j)
        _same_draws(pkw, jkw)
        masks = [bool(pkw["Choose"][t.name]["mask"]) for t in ptf.transforms]
        assert sum(masks) <= 1
        picked.update(i for i, m in enumerate(masks) if m)
    assert picked == {0, 1, 2}
    states = list(range(8, 12))
    pkw, jkw = ptf.batch_instantiate(states, item_p), jtf.batch_instantiate(states, item_j)
    _same_draws(pkw, jkw)
    assert _err(ptf(batch_p.clone(), **pkw), jtf(batch_j.clone(), **jkw)) < ATOL


def test_repeat_and_repeat_up_to_match_jax():
    item_p, item_j, batch_p, batch_j = _signals(2)
    rp = pt.Repeat(pt.VolumeChange(("const", -3.0)), n_repeat=3)
    rj = jt.Repeat(jt.VolumeChange(("const", -3.0)), n_repeat=3)
    assert [t.name for t in rp] == [t.name for t in rj] == [f"{i}.VolumeChange" for i in range(3)]
    out = rp(batch_p.clone(), **rp.instantiate(0, item_p))
    ratio = out.audio_data.abs().max() / batch_p.audio_data.abs().max()
    assert abs(20 * np.log10(float(ratio)) + 9.0) < 0.1
    assert _err(out, rj(batch_j.clone(), **rj.instantiate(0, item_j))) < ATOL
    up_p = pt.RepeatUpTo(pt.VolumeChange(), max_repeat=4)
    up_j = jt.RepeatUpTo(jt.VolumeChange(), max_repeat=4)
    assert len(up_p) == 3 and [t.n_repeat for t in up_p] == [1, 2, 3]
    states = [3, 4]
    pkw, jkw = up_p.batch_instantiate(states, item_p), up_j.batch_instantiate(states, item_j)
    _same_draws(pkw, jkw)
    assert _err(up_p(batch_p.clone(), **pkw), up_j(batch_j.clone(), **jkw)) < ATOL


def test_compose_filter_and_sequence_methods():
    def make(m):
        return m.Compose(m.Compose(m.VolumeChange(("const", -10.0)), name="preprocess"),
                         m.Compose(m.RescaleAudio(val=0.1), name="postprocess"))

    ptf, jtf = make(pt), make(jt)
    item_p, item_j, batch_p, batch_j = _signals(3)
    pkw, jkw = ptf.instantiate(0, item_p), jtf.instantiate(0, item_j)
    _same_draws(pkw, jkw)
    with ptf.filter("postprocess"), jtf.filter("postprocess"):
        got, want = ptf(batch_p.clone(), **pkw), jtf(batch_j.clone(), **jkw)
    assert torch.equal(got.audio_data, batch_p.clone().ensure_max_of_audio(0.1).audio_data)
    assert _err(got, want) < ATOL
    assert ptf.transforms_to_apply == ["0.preprocess", "1.postprocess"]
    with pytest.raises(RuntimeError), ptf.filter("preprocess"):
        raise RuntimeError
    assert ptf.transforms_to_apply == ["0.preprocess", "1.postprocess"]
    assert _err(ptf(batch_p.clone(), **pkw), jtf(batch_j.clone(), **jkw)) < ATOL
    assert len(ptf) == 2 and ptf[1] is ptf.transforms[1]
    assert [t.name for t in ptf] == [t.name for t in jtf]


def test_apply_mask_and_batch_instantiate_match_jax():
    x = np.arange(24, dtype=np.float32).reshape(4, 1, 6)
    mask = np.array([True, False, True, False])
    psig = AudioSignal(x, SR, device="cpu")
    psig.loudness()
    batch_p = {"a": torch.arange(4.0), "nested": {"b": np.ones((4, 2)), "sig": psig}, "s": "k"}
    batch_j = {"a": jax.numpy.arange(4.0), "nested": {"b": np.ones((4, 2)), "sig": JSignal(x, SR)},
               "s": "k"}
    got, want = pt.BaseTransform.apply_mask(batch_p, mask), jt.BaseTransform.apply_mask(batch_j, mask)
    assert np.array_equal(got["a"].numpy(), np.asarray(want["a"]))
    assert np.array_equal(got["nested"]["b"], np.asarray(want["nested"]["b"]))
    assert np.array_equal(got["nested"]["sig"].audio_data.numpy(),
                          np.asarray(want["nested"]["sig"].audio_data))
    assert got["nested"]["sig"]._loudness.shape == (2,) and got["s"] == "k"
    assert pt.BaseTransform.apply_mask(batch_p, torch.from_numpy(mask))["a"].shape == (2,)
    assert pt.BaseTransform.apply_mask(batch_p, np.True_) is batch_p

    tfm_p, tfm_j = pt.VolumeChange(prob=0.5), jt.VolumeChange(prob=0.5)
    item_p, item_j, _, _ = _signals(4)
    pkw, jkw = tfm_p.batch_instantiate([0, 1, 2, 3], item_p), tfm_j.batch_instantiate([0, 1, 2, 3], item_j)
    _same_draws(pkw, jkw)
    assert pkw["VolumeChange"]["db"].shape == (4,) and pkw["VolumeChange"]["mask"].dtype == bool
    picked = pt.BaseTransform.apply_mask(pkw, pkw["VolumeChange"]["mask"])
    assert picked["VolumeChange"]["db"].shape == (int(pkw["VolumeChange"]["mask"].sum()),)


def test_identity_and_spectral_transform_match_jax():
    item_p, item_j, batch_p, batch_j = _signals(5)
    for name in ("Identity", "SpectralTransform"):
        ptf, jtf = getattr(pt, name)(prob=0.5), getattr(jt, name)(prob=0.5)
        states = _mixed_states(ptf, item_p, name)
        pkw, jkw = ptf.batch_instantiate(states, item_p), jtf.batch_instantiate(states, item_j)
        _same_draws(pkw, jkw)
        got = ptf(batch_p.clone(), **pkw)
        assert _err(got, jtf(batch_j.clone(), **jkw)) < ATOL
    assert torch.equal(pt.Identity()(batch_p.clone(), **pt.Identity().instantiate(0)).audio_data,
                       batch_p.audio_data)


def zoo(m, root):
    """The zoo chain of the card tests over the fixture sources."""
    return m.Compose(
        m.RoomImpulseResponse(sources=[str(root / "ir.csv")]),
        m.BackgroundNoise(sources=[str(root / "nz.csv")]),
        m.CrossTalk(sources=[str(root / "spk.csv")]),
        m.NoiseFloor(), m.Choose(m.LowPass(), m.HighPass()), m.Equalizer(),
        m.ClippingDistortion(prob=0.5), m.Choose(m.Quantization(), m.MuLawQuantization(), prob=0.5),
        m.Smoothing(prob=0.5), m.RepeatUpTo(m.VolumeChange(), max_repeat=3),
        m.SpectralDenoising(prob=0.5), m.Choose(m.ShiftPhase(), m.InvertPhase(), m.CorruptPhase()),
        m.FrequencyMask(prob=0.5), m.TimeMask(prob=0.5), m.MaskLowMagnitudes(prob=0.5),
        m.FrequencyNoise(prob=0.5), m.TimeNoise(prob=0.5), m.Silence(), m.GlobalVolumeNorm(),
        m.VolumeNorm(), m.RescaleAudio(),
    )


def _to_port(j):
    """The JAX package's signal as the port's, with its STFT parameters and
    cached loudness."""
    out = AudioSignal(np.array(j.audio_data), j.sample_rate, device="cpu",
                      stft_params=STFTParams(*j.stft_params))
    if j._loudness is not None:
        out._loudness = torch.from_numpy(np.array(j._loudness))
    return out


def test_zoo_chain_matches_jax_transform_by_transform(audio_dir):
    """The slice as a whole: both datasets draw the same batch and the same
    parameters for the zoo chain; then each transform of the chain, given
    the JAX package's input to it, gives the JAX package's output."""
    jds = JDataset(JLoader(sources=[str(audio_dir / "spk.csv")]), sample_rate=SR, n_examples=4,
                   duration=1.0, transform=zoo(jt, audio_dir))
    pds = PDataset(PLoader(sources=[str(audio_dir / "spk.csv")]), sample_rate=SR, n_examples=4,
                   duration=1.0, transform=zoo(pt, audio_dir))
    jbatch = ju.collate([jds[i] for i in (2, 3)])
    pbatch = pu.collate([pds[i] for i in (2, 3)])
    _same_draws(pbatch["transform_args"], jbatch["transform_args"])
    assert np.array_equal(pbatch["signal"].audio_data.numpy(), np.asarray(jbatch["signal"].audio_data))
    jargs, pargs = jbatch["transform_args"]["Compose"], pbatch["transform_args"]["Compose"]
    masks = [np.asarray(pargs[t.name]["mask"]) for t in pds.transform]
    assert any(0 < m.sum() < 2 for m in masks)  # some transform applies to one item only
    signal = jbatch["signal"]
    for ptf, jtf in zip(pds.transform, jds.transform):
        got = ptf(_to_port(signal), **pargs)
        signal = jtf(signal, **jargs)
        pin = 1e-4 if ptf.name.split(".")[1] in METERED else ATOL
        assert _err(got, signal) < pin, ptf.name
        assert got.stft_params == tuple(signal.stft_params), ptf.name
    assert np.isfinite(np.asarray(signal.audio_data)).all()


def test_instantiate_builds_every_signal_on_the_host(audio_dir, monkeypatch):
    """Every signal and noise plane that instantiate draws is built and
    metered on the host: with the default device patched to ``meta`` (which
    holds no data) any placement there would fail or show."""
    monkeypatch.setattr(pu, "default_device", lambda: torch.device("meta"))
    item = AudioSignal(speech_like(6, 1.0)[None, None], SR, device="cpu")
    kwargs = zoo(pt, audio_dir).instantiate(0, item)
    leaves = list(pu.flatten(kwargs).values())
    signals = [v for v in leaves if isinstance(v, AudioSignal)]
    assert len(signals) == 6  # ir, bg, crosstalk, noise floor, smoothing window, denoising noise
    for v in leaves:
        if isinstance(v, AudioSignal):
            assert v.device.type == "cpu" and (v._loudness is None or v._loudness.device.type == "cpu")
        assert not isinstance(v, torch.Tensor) or v.device.type == "cpu"
    staged = pu.prepare_batch(kwargs, "cpu")
    assert isinstance(staged["Compose"]["16.TimeNoise"]["mag_noise"], torch.Tensor)
    assert isinstance(staged["Compose"]["16.TimeNoise"]["mask"], np.ndarray)


def test_spectral_denoising_leaves_its_arguments_as_drawn():
    """The drawn noise is normalized and EQ-ed on a clone, so one set of
    arguments gives one output however often it is applied (the JAX
    package changes the drawn noise in place, and EQs it again on a second
    application)."""
    item_p, _, batch_p, _ = _signals(7)
    tfm = pt.SpectralDenoising()
    kwargs = tfm.instantiate(0, item_p)
    drawn = kwargs["SpectralDenoising"]["nz"].audio_data.clone()
    first = tfm(batch_p.clone(), **kwargs)
    second = tfm(batch_p.clone(), **kwargs)
    assert torch.equal(kwargs["SpectralDenoising"]["nz"].audio_data, drawn)
    assert torch.equal(first.audio_data, second.audio_data)


def test_silence_keeps_loudness_and_stft_params():
    item_p, _, batch_p, _ = _signals(8)
    batch_p.stft_params = STFTParams(512, 128)
    level = batch_p.loudness()
    out = pt.Silence(prob=1.0)(batch_p, **pt.Silence(prob=1.0).instantiate(0))
    assert float(out.audio_data.abs().max()) == 0.0
    assert out._loudness is level and out.stft_params == STFTParams(512, 128, "hann", False, "reflect")
