"""The port's quality metrics against the JAX package on the CPU: STOI
(host and device), PESQ (the native host oracle and the batched device
program) and NSIM (ViSQOL's in-package backend), and the backend switches
of ``metrics.quality``.

Tolerances are the JAX package's own pins or tighter: device STOI 5e-4 and
host STOI 1.2e-7 (``tests/metrics/test_metrics.py``), device PESQ 2e-3 MOS
(``tests/metrics/test_pesq_device.py``), the host PESQ oracle 1e-9 (the same
float64 numpy on the same arrays), NSIM 1e-4. Each JAX program runs at one
shape, from module-scoped fixtures.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from audiotools_tpu import AudioSignal as JSignal
from audiotools_tpu.metrics import _pesq as JH
from audiotools_tpu.metrics import quality as JQ
from audiotools_tpu.ops import nsim as JN
from audiotools_tpu.ops import pesq as JP
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch.metrics import _pesq as PH
from audiotools_tpu_torch.metrics import quality as PQ
from audiotools_tpu_torch.ops import nsim as PN
from audiotools_tpu_torch.ops import pesq as PP
from audiotools_tpu_torch.ops import stoi as PS
from tests.fixtures import speech_like

STOI_DEVICE_ATOL = 5e-4
STOI_HOST_ATOL = 1.2e-7
PESQ_HOST_ATOL = 1e-9
PESQ_DEVICE_ATOL = 2e-3
NSIM_ATOL = 1e-4


def _noisy(x, snr_db, seed):
    n = np.random.RandomState(seed).randn(len(x)).astype(np.float32)
    return x + n * (10 ** (-snr_db / 20) * np.abs(x).std() / n.std())


@pytest.fixture(scope="module")
def stoi_pairs():
    """``tests/metrics/test_metrics.py``'s STOI items at 44.1 kHz: three SNRs
    and a gated item quiet enough to trigger silent-frame removal."""
    items = [(_noisy(speech_like(seed, 2.0), snr, 100 + seed), speech_like(seed, 2.0))
             for seed, snr in ((0, 25.0), (1, 10.0), (2, 0.0))]
    gated = speech_like(3, 2.0).copy()
    gated[: len(gated) // 3] = 0.0
    gated[-len(gated) // 4:] = 0.0
    items.append((gated, gated))
    est = np.stack([e for e, _ in items])[:, None, :]
    ref = np.stack([r for _, r in items])[:, None, :]
    return est, ref


@pytest.fixture(scope="module")
def jax_stoi(stoi_pairs):
    est, ref = stoi_pairs
    return {(kind, ext): np.asarray(fn(JSignal(est, 44100), JSignal(ref, 44100), extended=ext))
            for kind, fn in (("host", JQ.stoi), ("device", JQ.stoi_device))
            for ext in (False, True)}


@pytest.mark.parametrize("extended", [False, True])
def test_stoi_device_matches_jax_and_host(stoi_pairs, jax_stoi, extended):
    est, ref = stoi_pairs
    got = PQ.stoi_device(AudioSignal(est, 44100, device="cpu"), AudioSignal(ref, 44100, device="cpu"),
                         extended=extended)
    assert got.shape == (4,) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), jax_stoi["device", extended], atol=STOI_DEVICE_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), jax_stoi["host", extended], atol=STOI_DEVICE_ATOL, rtol=0)


@pytest.mark.parametrize("extended", [False, True])
def test_stoi_host_matches_jax(stoi_pairs, jax_stoi, extended):
    est, ref = stoi_pairs
    got = PQ.stoi(AudioSignal(est, 44100, device="cpu"), AudioSignal(ref, 44100, device="cpu"),
                  extended=extended)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), jax_stoi["host", extended], atol=STOI_HOST_ATOL, rtol=0)


def test_stoi_retained_frames_equal_the_host_mask(stoi_pairs):
    """The device program's retained-frame count per item is the host
    silence mask's, the gated item's included."""
    est, ref = stoi_pairs
    x = torch.from_numpy(AudioSignal(ref, 44100, device="cpu").resample(PS.FS).numpy()[:, 0])
    y = torch.from_numpy(AudioSignal(est, 44100, device="cpu").resample(PS.FS).numpy()[:, 0])
    _, n_valid = PS._stoi_parts(x, y, False)
    for i in range(len(x)):
        frames = PQ._frames(x[i].double().numpy())
        energies = 20 * np.log10(np.linalg.norm(frames, axis=1) + 1e-12)
        assert int(n_valid[i]) == int((energies > energies.max() - PS.DYN_RANGE).sum())
    assert int(n_valid[3]) < int(n_valid[0])  # the gated item drops frames


def test_stoi_too_short_and_trimmed():
    short = torch.zeros(1, 2000)
    assert torch.isnan(PS.stoi_batch(short, short)).all()
    rng = np.random.RandomState(7)
    ref = rng.randn(2, 40000).astype(np.float32)
    est = ref[:, :38000] + 0.01 * rng.randn(2, 38000).astype(np.float32)
    mismatched = PS.stoi_batch(torch.from_numpy(ref), torch.from_numpy(est))
    trimmed = PS.stoi_batch(torch.from_numpy(ref[:, :38000]), torch.from_numpy(est))
    np.testing.assert_allclose(mismatched.numpy(), trimmed.numpy(), atol=1e-6, rtol=0)


# -- PESQ --------------------------------------------------------------------------


def _speech(seed, dur, fs):
    """``tests/metrics/test_pesq_device.py``'s harmonic test utterance."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(dur * fs)) / fs
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t + rng.rand() * 6)
    ph = 2 * np.pi * np.cumsum(f0) / fs
    x = sum(np.sin(k * ph) / k for k in range(1, 10))
    env = np.clip(np.sin(2 * np.pi * 1.8 * t + rng.rand() * 6), 0, 1) ** 0.5
    x = x * env
    return (x / (np.abs(x).max() + 1e-9) * 0.3).astype(np.float32)


def _shift(x, n):
    """``x`` delayed by ``n`` samples (advanced for negative ``n``), same length."""
    if n >= 0:
        return np.concatenate([np.zeros(n, np.float32), x[: len(x) - n]])
    return np.concatenate([x[-n:], np.zeros(-n, np.float32)])


@pytest.fixture(scope="module", params=["wb", "nb"])
def pesq_case(request):
    """A ladder (identical, 30/20/10/0 dB), a silent degraded item and
    delayed pairs (+12 ms, -7 ms, +1 hop), with the JAX scores and delays."""
    mode = request.param
    fs = JH._MODES[mode].fs
    hop = JH._MODES[mode].hop
    x = _speech(0, 2.0, fs)
    degs = ([x.copy()] + [_noisy(x, snr, 100) for snr in (30, 20, 10, 0)] + [np.zeros_like(x)]
            + [_shift(_noisy(x, 15, 101), n) for n in (int(0.012 * fs), -int(0.007 * fs), hop)])
    refs, degs = np.stack([x] * len(degs)), np.stack(degs)
    T = refs.shape[-1]

    def delays(r, d):
        tab = JP._mode_tables(mode, int(2 ** np.ceil(np.log2(T))))

        def one(a, b):
            a, b = JP._level_and_receive(a, tab), JP._level_and_receive(b, tab)
            win = max(int(0.004 * fs), 1)
            return JP._fine_delay(a, b, JP._coarse_delay(a, b, win) * win, fs)

        return jax.vmap(one)(r, d)

    return dict(mode=mode, fs=fs, refs=refs, degs=degs,
                jax=np.asarray(JP.pesq_batch(refs, degs, mode=mode)),
                jax_delay=np.asarray(jax.jit(delays)(refs, degs)))


def test_pesq_native_matches_jax_host(pesq_case):
    """The port's copy of the float64 host oracle on the same arrays."""
    fs, mode = pesq_case["fs"], pesq_case["mode"]
    for r, d in zip(pesq_case["refs"], pesq_case["degs"]):
        got = PH.pesq_native(r.astype(np.float64), d.astype(np.float64), fs, mode)
        want = JH.pesq_native(r.astype(np.float64), d.astype(np.float64), fs, mode)
        assert abs(got - want) <= PESQ_HOST_ATOL


def test_pesq_batch_matches_jax_with_equal_delays(pesq_case):
    refs, degs, mode = pesq_case["refs"], pesq_case["degs"], pesq_case["mode"]
    mos, delay = PP._pesq_parts(*PP._checked_pair(torch.from_numpy(refs), torch.from_numpy(degs),
                                                  mode), mode)
    assert np.array_equal(delay.numpy(), pesq_case["jax_delay"])
    assert list(delay[-3:].numpy()) == [int(0.012 * pesq_case["fs"]), -int(0.007 * pesq_case["fs"]),
                                        JH._MODES[mode].hop]
    np.testing.assert_allclose(mos.numpy(), pesq_case["jax"], atol=PESQ_DEVICE_ATOL, rtol=0)
    assert torch.equal(PP.pesq_batch(torch.from_numpy(refs), torch.from_numpy(degs), mode=mode), mos)


def test_pesq_batch_matches_the_host_oracle(pesq_case):
    """At zero and positive delays the device program reproduces the host
    oracle's trim; the ladder falls strictly with the noise."""
    refs, degs, mode, fs = (pesq_case[k] for k in ("refs", "degs", "mode", "fs"))
    mos = PP.pesq_batch(torch.from_numpy(refs), torch.from_numpy(degs), mode=mode).numpy()
    host = np.array([PH.pesq_native(r.astype(np.float64), d.astype(np.float64), fs, mode)
                     for r, d in zip(refs, degs)])
    exact = [0, 1, 2, 3, 4, 5, 6, 8]  # item 7 is advanced: the framing phase may differ
    np.testing.assert_allclose(mos[exact], host[exact], atol=PESQ_DEVICE_ATOL, rtol=0)
    assert np.all(np.diff(mos[:5]) < 0) and mos[5] < 1.5


def test_pesq_errors():
    with pytest.raises(ValueError, match="too short"):
        PP.pesq_batch(torch.zeros(1, 512), torch.zeros(1, 512))
    with pytest.raises(ValueError, match="mode"):
        PP.pesq_batch(torch.zeros(1, 4096), torch.zeros(1, 4096), mode="fb")


@pytest.mark.parametrize("n", [5, 397, 1875])
def test_smooth_gain_matches_the_recurrence_and_jax(n):
    """The truncated float64 FIR against the host's sequential recurrence and
    the JAX package's associative scan, up to 1,875 frames (a 30 s wideband
    item), where the closed form would overflow fp32."""
    g = np.random.RandomState(n).uniform(3e-4, 5.0, size=(2, n)).astype(np.float32)
    want = np.empty((2, n))
    for b in range(2):
        acc = float(g[b, 0])
        for i in range(n):
            acc = 0.8 * acc + 0.2 * float(g[b, i])
            want[b, i] = acc
    got = PP._smooth_gain(torch.from_numpy(g)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    jax_got = np.stack([np.asarray(JP._smooth_gain(g[b])) for b in range(2)])
    np.testing.assert_allclose(got, jax_got, rtol=2e-6, atol=0)


# -- NSIM --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["speech", "audio"])
def nsim_case(request):
    mode = request.param
    fs = PN.MODES[mode]["fs"]
    x = speech_like(5, 1.5, fs)
    degs = np.stack([x, _noisy(x, 20.0, 7), _noisy(x, 0.0, 8), _shift(x, int(0.05 * fs))])
    refs = np.stack([x] * 4)
    return dict(mode=mode, refs=refs, degs=degs,
                jax=np.asarray(JN.nsim_batch(refs, degs, mode=mode)))


def test_nsim_batch_matches_jax(nsim_case):
    got = PN.nsim_batch(torch.from_numpy(nsim_case["refs"]), torch.from_numpy(nsim_case["degs"]),
                        mode=nsim_case["mode"])
    np.testing.assert_allclose(got.numpy(), nsim_case["jax"], atol=NSIM_ATOL, rtol=0)
    assert float(got[0]) == pytest.approx(1.0, abs=1e-6) and float(got[2]) < float(got[1])


def test_nsim_to_moslqo_matches_jax():
    x = np.concatenate([np.linspace(-0.1, 1.1, 97), JN._MOS_ANCHORS_NSIM]).astype(np.float32)
    got = PN.nsim_to_moslqo(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JN.nsim_to_moslqo(x)), atol=1e-6, rtol=0)


def test_nsim_errors():
    with pytest.raises(ValueError, match="mode"):
        PN.nsim_batch(torch.zeros(1, 4096), torch.zeros(1, 4096), mode="music")
    with pytest.raises(ValueError, match="too short"):
        PN.nsim_batch(torch.zeros(1, 100), torch.zeros(1, 100), mode="speech")


# -- the AudioSignal wrappers and their backends ---------------------------------


@pytest.fixture(scope="module")
def wrapper_pair():
    clean = _speech(5, 1.5, 44100)
    est = np.stack([clean, _noisy(clean, 8.0, 3)])[:, None, :]
    ref = np.stack([clean, clean])[:, None, :]
    return est, ref


def _signals(pair, module):
    if module is PQ:
        return tuple(AudioSignal(a, 44100, device="cpu") for a in pair)
    return tuple(JSignal(a, 44100) for a in pair)


@pytest.mark.parametrize("mode", ["wb", "nb"])
def test_pesq_wrappers_match_jax(wrapper_pair, mode):
    est, ref = _signals(wrapper_pair, PQ)
    jest, jref = _signals(wrapper_pair, JQ)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        dev = PQ.pesq_device(est, ref, mode=mode)
        host = PQ.pesq(est, ref, mode=mode, backend="native")
        np.testing.assert_allclose(dev.numpy(), np.asarray(JQ.pesq_device(jest, jref, mode=mode)),
                                   atol=PESQ_DEVICE_ATOL, rtol=0)
        np.testing.assert_allclose(host.numpy(), np.asarray(JQ.pesq(jest, jref, mode=mode,
                                                                    backend="native")),
                                   atol=1e-6, rtol=0)  # JAX returns float32
    np.testing.assert_allclose(dev.numpy(), host.numpy(), atol=PESQ_DEVICE_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["audio", "speech"])
def test_visqol_nsim_wrapper_matches_jax(wrapper_pair, mode):
    """NSIM within 1e-4 maps to MOS within 1e-4 times the map's steepest
    slope ((4.1 - 3.3) / (0.984 - 0.94) = 18.2)."""
    est, ref = _signals(wrapper_pair, PQ)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = PQ.visqol(est, ref, mode=mode, backend="nsim")
        want = np.asarray(JQ.visqol(*_signals(wrapper_pair, JQ), mode=mode, backend="nsim"))
    np.testing.assert_allclose(got.numpy(), want, atol=NSIM_ATOL * 18.2, rtol=0)
    assert np.all((got.numpy() >= 1.0) & (got.numpy() <= 5.0))


def test_backend_switches_and_warnings(wrapper_pair, monkeypatch):
    """Without the certified libraries, ``itu``/``google`` raise, ``auto``
    falls back to the in-package backends, and each uncertified backend warns
    once per process."""
    monkeypatch.setattr(PQ, "_warned_uncertified", set())
    est, ref = _signals(wrapper_pair, PQ)
    try:
        import pesq  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="itu"):
            PQ.pesq(est, ref, backend="itu")
        with pytest.warns(UserWarning, match="P.862-architecture"):
            auto = PQ.pesq(est, ref)
        np.testing.assert_array_equal(auto.numpy(), PQ.pesq(est, ref, backend="native").numpy())
    try:
        import visqol  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="google"):
            PQ.visqol(est, ref, backend="google")
        with pytest.warns(UserWarning, match="NSIM backend"):
            auto = PQ.visqol(est, ref)
        assert auto.shape == (2,)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a second warning would raise here
        PQ.pesq_device(est, ref)
        PQ.visqol(est, ref, backend="nsim")
    with pytest.raises(ValueError, match="backend"):
        PQ.pesq(est, ref, backend="other")
    with pytest.raises(ValueError, match="mode"):
        PQ.pesq(est, ref, mode="fb", backend="native")
    with pytest.raises(ValueError, match="mode"):
        PQ.pesq_device(est, ref, mode="fb")
    with pytest.raises(ValueError, match="backend"):
        PQ.visqol(est, ref, backend="other")
    with pytest.raises(ValueError, match="Unrecognized mode"):
        PQ.visqol(est, ref, mode="music", backend="nsim")
