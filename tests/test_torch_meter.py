"""The FIR loudness meter of the port on the CPU: kernel C's plain version
against the JAX package's Pallas kernel in interpret mode, the FFT
convolutions, ``apply_k_weighting``'s routing, ``set_fast_meter``, the
``Meter`` class and the signal methods that meter, each against the JAX
package on the same seeded numpy inputs.

Tolerances: kernel C 1e-4 absolute (the JAX package's pin,
tests/core/test_pallas_kernels.py) and 1e-5 of the largest output; meter
readings 1e-3 dB (tests/core/test_loudness.py, kernel against the FFT
evaluation of one FIR).

Every test that flips the process-wide meter restores it in ``finally``:
the tests of a file share a worker.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu import AudioSignal as JAudioSignal
from audiotools_tpu.core.loudness import Meter as JMeter
from audiotools_tpu.ops import filters as JFL
from audiotools_tpu.ops import loudness as JL
from audiotools_tpu.ops import pallas_kernels as JPK
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch import _build
from audiotools_tpu_torch.core.loudness import Meter
from audiotools_tpu_torch.ops import filters as PFL
from audiotools_tpu_torch.ops import hopper_kernels as HK
from audiotools_tpu_torch.ops import loudness as PL

SR = 44100


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _speechy(seed, nb, nch, n, scale=0.05):
    rng = np.random.RandomState(seed)
    x = rng.randn(nb, nch, n) * scale
    gaps = rng.rand(nb, 1, n // 4410 + 1) > 0.4  # silent stretches: both gates act
    return (x * np.repeat(gaps, 4410, axis=-1)[..., :n]).astype(np.float32)


class _fast_meter:
    """``set_fast_meter(True, zeros)`` in both packages for one block."""

    def __init__(self, zeros=512):
        self.zeros = zeros

    def __enter__(self):
        PL.set_fast_meter(True, self.zeros)
        JL.set_fast_meter(True, self.zeros)

    def __exit__(self, *exc):
        PL.set_fast_meter(False)
        JL.set_fast_meter(False)


# -- kernel C: the causal FIR with one shared kernel -------------------------


@pytest.mark.parametrize("taps", [33, 371, 1023])
@pytest.mark.parametrize("T", [5000, 8192])
def test_shared_fir_plain_matches_jax_interpret(taps, T):
    """The sizes of the JAX package's own interpret-mode test."""
    x = np.random.RandomState(0).randn(2, 1, T).astype(np.float32)
    h = np.random.RandomState(1).randn(taps).astype(np.float32) * 0.05
    want = np.asarray(JPK.fir_conv_causal(jnp.asarray(x), h, interpret=True))
    got = HK.fir_causal(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() < 1e-4
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("taps", [4095, 8192])
def test_shared_fir_plain_matches_fft_convolution_at_long_kernels(taps):
    rng = np.random.RandomState(taps)
    x = rng.randn(3, 20000).astype(np.float32)
    h = (rng.randn(taps) * 0.05).astype(np.float32)
    got = HK.fir_causal(torch.from_numpy(x), torch.from_numpy(h))
    want = PFL.causal_fft_conv1d(torch.from_numpy(x), torch.from_numpy(h))
    assert _rel(got.numpy(), want.numpy()) < 1e-5
    ref = np.stack([np.convolve(r.astype(np.float64), h.astype(np.float64))[:20000] for r in x])
    assert _rel(got.numpy(), ref) < 1e-5


def test_shared_fir_plain_is_the_per_item_fir_with_one_kernel():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(4, 3000).astype(np.float32))
    h = torch.from_numpy((rng.randn(97) * 0.1).astype(np.float32))
    assert torch.equal(HK.fir_causal(x, h), HK.fir_causal_batch(x, h.expand(4, 97).contiguous()))


def test_shared_fir_checks_its_inputs():
    with pytest.raises(ValueError, match=r"\(L,\)"):
        HK.fir_causal(torch.zeros(2, 100), torch.zeros(2, 5))
    with pytest.raises(TypeError, match="float32"):
        HK.fir_causal(torch.zeros(2, 100, dtype=torch.float64), torch.zeros(5))
    assert HK.MAX_TAPS == JPK.MAX_TAPS == 8192
    assert HK.MAX_TAPS_BATCH == 2048


def test_shared_fir_off_the_cpu_reaches_the_kernel_or_raises(monkeypatch):
    """A tensor off the CPU ("meta" stands in for a CUDA tensor here) never
    runs the plain version: a missing library raises, and with a library
    the wrapper still requires CUDA tensors."""
    monkeypatch.setattr(HK, "fir_causal_plain", lambda *a: pytest.fail("plain version ran"))
    x, h = torch.zeros(2, 64, device="meta"), torch.zeros(5, device="meta")

    def missing(name):
        raise RuntimeError(f"cannot load the {name} kernel library")

    monkeypatch.setattr(_build, "library", missing)
    with pytest.raises(RuntimeError, match="fir_causal_batch kernel library"):
        HK.fir_causal(x, h)

    class _Lib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(_build, "library", lambda name: _Lib())
    with pytest.raises(RuntimeError, match="expected CUDA tensors"):
        HK.fir_causal(x, h)
    with pytest.raises(ValueError, match="at most 8192 taps"):
        HK.fir_causal(x, torch.zeros(HK.MAX_TAPS + 1, device="meta"))


# -- the FFT convolutions ----------------------------------------------------


@pytest.mark.parametrize("block", [None, 8192, 2048])
@pytest.mark.parametrize("shape,taps", [((2, 1, 20000), 1023), ((3, 7000), 33), ((1, 2, 9001), 4095)])
def test_causal_fft_conv1d_matches_jax(shape, taps, block):
    rng = np.random.RandomState(taps)
    x = rng.randn(*shape).astype(np.float32)
    h = (rng.randn(taps) * 0.05).astype(np.float32)
    want = np.asarray(JFL.causal_fft_conv1d(jnp.asarray(x), jnp.asarray(h), block_size=block))
    got = PFL.causal_fft_conv1d(torch.from_numpy(x), torch.from_numpy(h), block_size=block).numpy()
    assert got.shape == want.shape == shape
    assert np.abs(got - want).max() < 1e-4
    assert _rel(got, want) < 1e-5


# -- the weighting filters and their routing ---------------------------------


@pytest.mark.parametrize("use_fir,conv_method,zeros", [
    (False, "fft", 512), (True, "fft", 512), (True, "fft_os", 512), (True, "pallas", 512),
    (True, "pallas", 2048), (True, "fft_os", 2048),
])
def test_apply_k_weighting_matches_jax(use_fir, conv_method, zeros):
    x = _speechy(3, 2, 1, SR, 0.3)
    want = np.asarray(JL.apply_k_weighting(jnp.asarray(x), SR, use_fir=use_fir, zeros=zeros,
                                           conv_method=conv_method))
    got = PL.apply_k_weighting(torch.from_numpy(x), SR, use_fir=use_fir, zeros=zeros,
                               conv_method=conv_method).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() < 1e-4


def test_apply_k_weighting_routes_as_the_jax_package(monkeypatch):
    calls = []
    real_fir, real_fft, real_iir = HK.fir_causal, PL.causal_fft_conv1d, PL.iir_cascade_blocked
    monkeypatch.setattr(HK, "fir_causal", lambda x, h: calls.append(("C", h.shape[0])) or real_fir(x, h))
    monkeypatch.setattr(PL, "causal_fft_conv1d", lambda x, h, block_size=None: calls.append(
        ("fft", h.shape[0], block_size)) or real_fft(x, h, block_size))
    monkeypatch.setattr(PL, "iir_cascade_blocked", lambda x, s: calls.append(("iir",)) or real_iir(x, s))
    x = torch.zeros(1, 1, 4410)
    PL.apply_k_weighting(x, SR)
    PL.apply_k_weighting(x, SR, use_fir=True)
    PL.apply_k_weighting(x, SR, use_fir=True, conv_method="fft_os")
    PL.apply_k_weighting(x, SR, use_fir=True, conv_method="pallas")
    PL.apply_k_weighting(x, SR, use_fir=True, conv_method="pallas", zeros=2048)
    PL.apply_k_weighting(x, SR, use_fir=True, conv_method="pallas", zeros=4097)  # 8193 taps
    assert calls == [("iir",), ("fft", 1023, None), ("fft", 1023, 8192), ("C", 1023), ("C", 4095),
                     ("fft", 8193, None)]


def test_tpu_interpreter_mode_and_unknown_methods_raise():
    """The JAX package's interpreter-mode name runs kernel C's plain version
    (which is what ``"pallas"`` runs for a CPU tensor, so the two agree bit
    for bit here); a name neither package knows raises."""
    x = torch.from_numpy(_speechy(4, 1, 1, 4410, 0.3))
    assert torch.equal(PL.apply_k_weighting(x, SR, use_fir=True, conv_method="pallas_interpret"),
                       PL.apply_k_weighting(x, SR, use_fir=True, conv_method="pallas"))
    with pytest.raises(ValueError, match="conv_method must be one of"):
        PL.loudness(x, SR, use_fir=True, conv_method="toeplitz")


def test_pallas_interpret_runs_kernel_cs_plain_version(monkeypatch):
    """``conv_method="pallas_interpret"`` takes C's plain version under C's
    tap limit, on any device, and never the kernel's wrapper; above the
    limit it convolves by FFT, as ``"pallas"`` does."""
    calls = []
    real_plain, real_fft = HK.fir_causal_plain, PL.causal_fft_conv1d
    monkeypatch.setattr(HK, "fir_causal", lambda x, h: pytest.fail("kernel C's wrapper called"))
    monkeypatch.setattr(HK, "fir_causal_plain",
                        lambda x, h: calls.append(("plain", h.shape[0])) or real_plain(x, h))
    monkeypatch.setattr(PL, "causal_fft_conv1d", lambda x, h, block_size=None: calls.append(
        ("fft", h.shape[0], block_size)) or real_fft(x, h, block_size))
    x = torch.zeros(1, 1, 4410)
    for zeros in (512, 2048, 4097):
        PL.apply_k_weighting(x, SR, use_fir=True, conv_method="pallas_interpret", zeros=zeros)
    assert calls == [("plain", 1023), ("plain", 4095), ("fft", 8193, None)]


@pytest.mark.parametrize("zeros", [512, 2048])
def test_apply_k_weighting_interpret_matches_jax_interpret(zeros):
    """Both packages' interpreter modes: C's plain version against the
    Pallas kernel interpreted, at ``test_apply_k_weighting_matches_jax``'s
    pin."""
    x = _speechy(3, 2, 1, SR // 2, 0.3)
    want = np.asarray(JL.apply_k_weighting(jnp.asarray(x), SR, use_fir=True, zeros=zeros,
                                           conv_method="pallas_interpret"))
    got = PL.apply_k_weighting(torch.from_numpy(x), SR, use_fir=True, zeros=zeros,
                               conv_method="pallas_interpret").numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() < 1e-4


def test_fir_loudness_interpret_matches_jax_interpret():
    """The meter's entry points with the interpreter-mode name against the
    JAX package's (``loudness``, ``integrated_loudness``, the signal's
    ``loudness``), at the meter readings' 1e-3 dB."""
    x = (np.random.RandomState(11).randn(2, 1, SR) * 0.1).astype(np.float32)
    kw = {"use_fir": True, "conv_method": "pallas_interpret"}
    want = np.asarray(JL.loudness(jnp.asarray(x), SR, **kw))
    assert np.abs(PL.loudness(torch.from_numpy(x), SR, **kw).numpy() - want).max() < 1e-3
    got = AudioSignal(torch.from_numpy(x), SR, device="cpu").loudness(**kw).numpy()
    assert np.abs(got - want).max() < 1e-3
    xt = x.transpose(0, 2, 1).copy()  # (nb, nt, nch)
    want = np.asarray(JL.integrated_loudness(jnp.asarray(xt), SR, **kw))
    got = PL.integrated_loudness(torch.from_numpy(xt), SR, **kw).numpy()
    assert np.abs(got - want).max() < 1e-3


# -- the meter readings ------------------------------------------------------


@pytest.mark.parametrize("conv_method", ["fft", "fft_os", "pallas"])
@pytest.mark.parametrize("zeros", [512, 2048])
def test_fir_loudness_matches_jax(conv_method, zeros):
    x = _speechy(4, 3, 1, 2 * SR)
    x[2] *= 1e-5  # below the absolute gate: the -70 LUFS floor
    got = PL.loudness(torch.from_numpy(x), SR, use_fir=True, zeros=zeros,
                      conv_method=conv_method).numpy()
    for jax_method in {conv_method, "fft"}:
        want = np.asarray(JL.loudness(jnp.asarray(x), SR, use_fir=True, zeros=zeros,
                                      conv_method=jax_method))
        assert np.abs(got - want).max() < 1e-3
    # the FIR stays inside BS.1770's 0.1 dB of the exact cascade here
    assert np.abs(got - PL.loudness(torch.from_numpy(x), SR).numpy()).max() < 0.1


def test_fir_loudness_matches_jax_kernel_interpret():
    """The JAX package's end-to-end interpret test of its fast meter, at its
    size, against the port's kernel-C route."""
    x = (np.random.RandomState(11).randn(2, 1, SR) * 0.1).astype(np.float32)
    want = np.asarray(JL.loudness(jnp.asarray(x), SR, use_fir=True, conv_method="pallas_interpret"))
    got = PL.loudness(torch.from_numpy(x), SR, use_fir=True, conv_method="pallas").numpy()
    assert np.abs(got - want).max() < 1e-3


def test_integrated_loudness_takes_the_meter_options():
    x = _speechy(5, 2, 2, SR).transpose(0, 2, 1).copy()  # (nb, nt, nch)
    for kw in ({}, {"use_fir": True}, {"use_fir": True, "zeros": 2048, "conv_method": "pallas"}):
        want = np.asarray(JL.integrated_loudness(jnp.asarray(x), SR, **kw))
        got = PL.integrated_loudness(torch.from_numpy(x), SR, **kw).numpy()
        assert np.abs(got - want).max() < 1e-3, kw


def test_set_fast_meter_round_trip():
    x = torch.from_numpy(_speechy(6, 2, 1, SR))
    exact = PL.loudness(x, SR)
    assert PL._METER_DEFAULTS == {"use_fir": False, "conv_method": "fft", "zeros": 512}
    try:
        PL.set_fast_meter(True)
        assert PL._METER_DEFAULTS == {"use_fir": True, "conv_method": "pallas", "zeros": 512}
        assert torch.equal(PL.loudness(x, SR), PL.loudness(x, SR, use_fir=True, conv_method="pallas"))
        # explicit options still win over the default
        assert torch.equal(PL.loudness(x, SR, use_fir=False), exact)
        PL.set_fast_meter(True, zeros=2048)
        assert torch.equal(PL.loudness(x, SR),
                           PL.loudness(x, SR, use_fir=True, zeros=2048, conv_method="pallas"))
    finally:
        PL.set_fast_meter(False)
    assert PL._METER_DEFAULTS == {"use_fir": False, "conv_method": "fft", "zeros": 512}
    assert torch.equal(PL.loudness(x, SR), exact)


@pytest.mark.parametrize("zeros", [512, 2048])
def test_fast_meter_default_matches_jax(zeros):
    x = _speechy(7, 3, 2, SR)
    with _fast_meter(zeros):
        want = np.asarray(JL.loudness(jnp.asarray(x), SR))
        got = PL.loudness(torch.from_numpy(x), SR).numpy()
    assert np.abs(got - want).max() < 1e-3


# -- Meter and the signal methods -------------------------------------------


@pytest.mark.parametrize("use_fir,zeros", [(False, 512), (True, 512), (True, 2048)])
def test_meter_matches_jax(use_fir, zeros):
    x = _speechy(8, 2, 2, SR).transpose(0, 2, 1).copy()  # (nb, nt, nch)
    jm = JMeter(SR, zeros=zeros, use_fir=use_fir)
    pm = Meter(SR, zeros=zeros, use_fir=use_fir)
    for (pb, pa, pg), (jb, ja, jg) in zip(pm.filters, jm.filters):
        assert np.array_equal(pb, jb) and np.array_equal(pa, ja) and pg == jg
    want = np.asarray(jm.apply_filter(jnp.asarray(x)))
    got = pm.apply_filter(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() < 1e-4
    assert pm.apply_filter_gpu == pm.apply_filter_cpu == pm.apply_filter
    want = np.asarray(jm.integrated_loudness(jnp.asarray(x)))
    assert np.abs(pm.integrated_loudness(torch.from_numpy(x)).numpy() - want).max() < 1e-3
    assert np.abs(pm(torch.from_numpy(x)).numpy() - want).max() < 1e-3
    assert np.abs(pm.forward(torch.from_numpy(x)).numpy()
                  - np.asarray(jm.forward(jnp.asarray(x)))).max() < 1e-3
    # one item reads as a scalar, as in the JAX package
    one = pm.integrated_loudness(torch.from_numpy(x[:1]))
    assert one.shape == () and abs(float(one) - float(want[0])) < 1e-3


def test_samples_is_audio_data_like_jax():
    """``samples`` reads and sets ``audio_data``; setting it drops the
    cached loudness in both packages."""
    x = _speechy(12, 2, 1, SR)
    sig, jsig = AudioSignal(torch.from_numpy(x), SR), JAudioSignal(jnp.asarray(x), SR)
    assert sig.samples is sig.audio_data
    for s in (sig, jsig):
        s.loudness()
        s.samples = s.samples * 0.5
        assert s._loudness is None
    assert np.array_equal(sig.samples.numpy(), np.asarray(jsig.samples))
    assert np.abs(sig.loudness().numpy() - np.asarray(jsig.loudness())).max() < 1e-3


def test_signal_loudness_passes_the_meter_options():
    x = _speechy(9, 2, 1, SR)
    kw = {"use_fir": True, "zeros": 2048, "conv_method": "fft_os"}
    want = np.asarray(JAudioSignal(jnp.asarray(x), SR).loudness(**kw))
    got = AudioSignal(torch.from_numpy(x), SR).loudness(**kw).numpy()
    assert np.abs(got - want).max() < 1e-3


def test_normalize_and_mix_follow_the_fast_meter():
    """``normalize`` and ``mix`` (its one stacked meter call) pass no meter
    options in either package, so both follow ``set_fast_meter``."""
    x = _speechy(10, 2, 1, SR, 0.2)
    n = _speechy(11, 2, 1, SR, 0.1)
    snr = np.array([5.0, 12.0], np.float32)
    results = {}
    for fast in (False, True):
        try:
            PL.set_fast_meter(fast)
            JL.set_fast_meter(fast)
            want = JAudioSignal(jnp.asarray(x), SR).normalize(-20.0)
            got = AudioSignal(torch.from_numpy(x), SR).normalize(-20.0)
            assert np.abs(got.audio_data.numpy() - np.asarray(want.audio_data)).max() < 1e-5
            want = JAudioSignal(jnp.asarray(x), SR).mix(JAudioSignal(jnp.asarray(n), SR),
                                                        snr=jnp.asarray(snr))
            got = AudioSignal(torch.from_numpy(x), SR).mix(AudioSignal(torch.from_numpy(n), SR),
                                                           snr=torch.from_numpy(snr))
            assert np.abs(got.audio_data.numpy() - np.asarray(want.audio_data)).max() < 1e-5
            results[fast] = got.audio_data
        finally:
            PL.set_fast_meter(False)
            JL.set_fast_meter(False)
    # the two meters read differently, so the default did change the mix
    assert not torch.equal(results[False], results[True])
