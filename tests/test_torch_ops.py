"""The port's ops against the JAX package's on the CPU, same numpy inputs.

Tolerances are the JAX package's own pins for these functions or tighter:
iSTFT 1e-4 absolute (tests/parity/test_parity.py, ISTFT vs torch.istft),
loudness 5e-3 dB (test_parity.py, host vs device meter).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores
from scipy.signal import lfilter

from audiotools_tpu.ops import fft as JF
from audiotools_tpu.ops import filters as JFL
from audiotools_tpu.ops import loudness as JL
from audiotools_tpu.ops import resample as JR
from audiotools_tpu_torch import _build
from audiotools_tpu_torch.ops import fft as PF
from audiotools_tpu_torch.ops import filters as PFL
from audiotools_tpu_torch.ops import hopper_kernels as HK
from audiotools_tpu_torch.ops import loudness as PL
from audiotools_tpu_torch.ops import resample as PR


def _noise(shape, seed, scale=0.1):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("match_stride", [False, True])
@pytest.mark.parametrize("win,hop", [(2048, 512), (512, 128)])
def test_stft_matches_jax(win, hop, match_stride):
    x = _noise((2, 1, 22050), 0, 0.5)
    want = np.asarray(JF.stft(jnp.asarray(x), win, hop, match_stride=match_stride,
                              method="matmul"))
    got = PF.stft(torch.from_numpy(x), win, hop, match_stride=match_stride,
                  method="matmul").numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    # the JAX package's stated accuracy of its matmul DFT
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("match_stride", [False, True])
@pytest.mark.parametrize("win,hop", [(2048, 512), (512, 128)])
def test_istft_round_trip_and_jax(win, hop, match_stride):
    T = 22050
    x = _noise((2, 1, T), 10, 0.5)
    spec = PF.stft(torch.from_numpy(x), win, hop, match_stride=match_stride)
    back = PF.istft(spec, win, hop, match_stride=match_stride, original_length=T).numpy()
    assert back.shape == x.shape
    # match_stride drops the two edge frames on each side and the inverse
    # zero-fills them, so only the interior round-trips
    edge = 2 * hop + win if match_stride else 0
    assert np.abs(back - x)[..., edge : T - edge].max() < 1e-4
    # an inconsistent (modified) spectrum, where the OLA normalization matters
    mod = spec.numpy() * np.random.RandomState(12).uniform(0, 1.5, spec.shape[-2:]).astype(np.float32)
    want = np.asarray(JF.istft(jnp.asarray(mod), win, hop, match_stride=match_stride,
                               length=T, method="matmul"))
    got = PF.istft(torch.from_numpy(mod), win, hop, match_stride=match_stride, length=T,
                   method="matmul").numpy()
    assert np.abs(got - want).max() < 1e-4


def test_overlap_add_with_hop_not_dividing_frame():
    frames = torch.from_numpy(_noise((2, 7, 10), 3, 1.0))
    got = PF._overlap_add(frames, 3, 28).numpy()
    want = np.zeros((2, 28), np.float32)
    for i in range(7):
        want[:, 3 * i : 3 * i + 10] += frames.numpy()[:, i]
    assert np.abs(got - want).max() < 1e-6


def test_bf16_synthesis_stays_within_its_perturbation_bound():
    """``matmul_bf16`` rounds the spectrum and the iDFT matrices to bf16
    (relative rounding <= 2**-8 each) and sums in fp32. Its waveform stays
    within 1e-2 of the fp32 synthesis relative to the peak (the JAX package
    documents ~3e-3), and its loudness within 0.05 dB; and it really rounds
    (the two differ by more than fp32 noise)."""
    x = _noise((2, 1, 44100), 4, 0.3)
    spec = PF.stft(torch.from_numpy(x), 2048, 512)
    y32 = PF.istft(spec, 2048, 512, length=44100, method="matmul")
    y16 = PF.istft(spec, 2048, 512, length=44100, method="matmul_bf16")
    err = float((y16 - y32).abs().max() / y32.abs().max())
    assert 1e-5 < err < 1e-2
    assert float((PL.loudness(y16, 44100) - PL.loudness(y32, 44100)).abs().max()) < 0.05


def test_unported_methods_raise():
    """What the JAX package refuses, the port refuses, and nothing else
    here: a method name that neither package knows, and the fused
    synthesis's name given to the analysis (the JAX ``stft`` has no fused
    method). The interpreter-mode names and the analysis ``matmul_bf16``
    compute (``tests/test_torch_bf16_analysis.py``,
    ``test_torch_synthesis.py``, ``test_torch_meter.py``)."""
    x = np.zeros((1, 4096), np.float32)
    spec = np.zeros((1, 257, 9), np.complex64)
    calls = [
        ("Unknown stft method", "stft", (x, 512, 128), dict(method="matmul_bf16_fused")),
        ("Unknown stft method", "stft", (x, 512, 128), dict(method="matmul_bf16_interpret")),
        ("Unknown istft method", "istft", (spec, 512, 128), dict(length=4096,
                                                                 method="matmul_fused")),
        ("Unknown stft method", "mel_spectrogram", (x, 16000, 40), dict(method="dft")),
    ]
    for match, name, args, kwargs in calls:
        with pytest.raises(ValueError, match=match):
            getattr(JF, name)(*(jnp.asarray(a) for a in args[:1]), *args[1:], **kwargs)
        with pytest.raises(ValueError, match=match):
            getattr(PF, name)(torch.from_numpy(args[0]), *args[1:], **kwargs)


@pytest.mark.parametrize("n_mels,sr", [(80, 44100), (40, 16000)])
def test_mel_spectrogram_matches_jax(n_mels, sr):
    x = _noise((2, 1, sr), 5, 0.3)
    want = np.asarray(JF.mel_spectrogram(jnp.asarray(x), sr, n_mels, method="matmul"))
    got = PF.mel_spectrogram(torch.from_numpy(x), sr, n_mels, method="matmul").numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("old,new", [(44100, 39200), (39200, 44100), (44100, 16000), (16000, 44100)])
def test_resample_matches_jax(old, new):
    x = _noise((2, 1, old // 2), 6, 0.3)
    want = np.asarray(JR.resample(jnp.asarray(x), old, new))
    got = PR.resample(torch.from_numpy(x), old, new).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5
    # the host path (numpy in, numpy out) is the JAX package's host path
    assert np.array_equal(PR.resample(x, old, new), JR.resample(x, old, new))


@pytest.mark.parametrize("rate,block", [(44100, 512), (48000, 128)])
def test_iir_cascade_blocked_matches_jax(rate, block):
    x = _noise((3, 2 * rate), 7, 0.3)
    stages = [(b, a, g) for (b, a), g in JL.design_filters(rate)]
    want = np.asarray(JFL.iir_cascade_blocked(jnp.asarray(x), stages, block))
    got = PFL.iir_cascade_blocked(torch.from_numpy(x), stages, block).numpy()
    # both sum in fp32 in other orders and the block states carry the
    # rounding forward; the JAX package pins its own output at 1e-4 against
    # the float64 sequential filter (tests/parity/test_parity.py)
    assert np.abs(got - want).max() < 1e-4
    ref = x.astype(np.float64)
    for b, a, g in stages:
        ref = g * lfilter(b, a, ref, axis=-1)
    assert np.abs(got - ref).max() < 1e-4


def _addmm_loop(u, a_l_t):
    """The block-state loop as ``iir_cascade_blocked`` ran it before kernel
    F: block-major planes, one ``addmm`` a block, in place."""
    u = u.transpose(0, 1).contiguous()
    s_pre = torch.zeros_like(u)
    s_k, u_k = s_pre.unbind(0), u.unbind(0)
    for k in range(u.shape[0] - 1):
        torch.addmm(u_k[k], s_k[k], a_l_t, out=s_k[k + 1])
    return s_pre.transpose(0, 1)


def _cascade_with_the_loop(x, stages, block=512):
    """``iir_cascade_blocked`` as it was before kernel F, epilogue and all."""
    key = tuple((tuple(map(float, b)), tuple(map(float, a)), float(g)) for b, a, g in stages)
    phi_x_t, phi_s_t, psi_x_t, a_l_t = PFL._iir_operators_on(key, block, x.device, x.dtype)
    T = x.shape[-1]
    xf = torch.nn.functional.pad(x.reshape(-1, T), (0, -T % block))
    xb = xf.reshape(xf.shape[0], -1, block)
    s_pre = _addmm_loop(xb @ psi_x_t, a_l_t)
    y = xb @ phi_x_t + s_pre @ phi_s_t
    return y.reshape(xf.shape[0], -1)[:, :T].reshape(x.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_scan_plain_is_the_addmm_loop_bit_for_bit(dtype):
    """Kernel F's plain version, and the cascade on CPU tensors, give the
    bits the loop gave: the CPU's numbers do not move."""
    rng = np.random.RandomState(19)
    stages = [(b, a, g) for (b, a), g in JL.design_filters(44100)]
    key = tuple((tuple(map(float, b)), tuple(map(float, a)), float(g)) for b, a, g in stages)
    a_l_t = PFL._iir_operators_on(key, 512, torch.device("cpu"), dtype)[3]
    u = torch.from_numpy(rng.randn(5, 37, 4)).to(dtype)
    got = HK.iir_block_scan(u, a_l_t)
    assert got.shape == u.shape and got.dtype == dtype
    assert torch.equal(got, _addmm_loop(u, a_l_t))
    assert torch.equal(got[:, 0], torch.zeros(5, 4, dtype=dtype))
    x = torch.from_numpy(rng.randn(2, 3, 44100 + 77) * 0.3).to(dtype)
    assert torch.equal(PFL.iir_cascade_blocked(x, stages), _cascade_with_the_loop(x, stages))
    assert torch.equal(PFL.biquad_cascade(x.float(), stages),
                       _cascade_with_the_loop(x.float().double(), stages).float())


def _fake_library(monkeypatch):
    """A kernel library whose every entry point returns 0, so that a
    wrapper's own checks and ``_launch``'s device check are reached."""
    class _Lib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(_build, "library", lambda name: _Lib())


def test_blocked_iir_off_the_cpu_reaches_the_scan_kernel_or_raises(monkeypatch):
    """A tensor off the CPU ("meta" stands in for a CUDA tensor here) takes
    kernel F once a cascade, and never the plain loop: a missing library
    raises, and with a library the wrapper still requires CUDA tensors."""
    monkeypatch.setattr(HK, "iir_block_scan_plain", lambda *a: pytest.fail("plain version ran"))
    calls = []
    real = HK.iir_block_scan
    monkeypatch.setattr(HK, "iir_block_scan", lambda u, a: calls.append(u.shape) or real(u, a))
    stages = [(b, a, g) for (b, a), g in JL.design_filters(44100)]
    x = torch.zeros(2, 3, 5000, device="meta")

    def missing(name):
        raise RuntimeError(f"cannot load the {name} kernel library")

    monkeypatch.setattr(_build, "library", missing)
    with pytest.raises(RuntimeError, match="iir_block_scan kernel library"):
        PFL.iir_cascade_blocked(x, stages)
    assert calls == [(6, 10, 4)]
    _fake_library(monkeypatch)
    with pytest.raises(RuntimeError, match="expected CUDA tensors"):
        PFL.biquad(x, [1.0, -1.8, 0.81], [1.0, -1.5, 0.6])
    assert calls == [(6, 10, 4), (6, 10, 2)]


def test_block_scan_checks_its_inputs(monkeypatch):
    u, a = torch.zeros(2, 5, 4), torch.zeros(4, 4)
    for bad_u, bad_a in ((u[0], a), (u, a[:3]), (u, torch.zeros(2, 2))):
        with pytest.raises(ValueError, match=r"\(rows, n_blk, ns\)"):
            HK.iir_block_scan(bad_u, bad_a)
    for bad_u, bad_a in ((u.half(), a.half()), (u, a.double()), (u.int(), a.int())):
        with pytest.raises(TypeError, match="float32 or float64"):
            HK.iir_block_scan(bad_u, bad_a)
    # off the CPU: the kernel's own limits, before any launch
    _fake_library(monkeypatch)
    meta = {"device": "meta"}
    u, a = torch.zeros(2, 5, 4, **meta), torch.zeros(4, 4, **meta)
    with pytest.raises(ValueError, match="at most 16 states"):
        HK.iir_block_scan(torch.zeros(2, 5, 17, **meta), torch.zeros(17, 17, **meta))
    assert HK.MAX_SCAN_STATES == 16
    before = dict(HK.LAUNCHES)
    for empty in (torch.zeros(2, 0, 4, **meta), torch.zeros(0, 5, 4, **meta)):
        out = HK.iir_block_scan(empty, a)  # nothing to launch: an empty result
        assert out.shape == empty.shape and out.device == empty.device
    assert HK.LAUNCHES == before
    with pytest.raises(RuntimeError, match="contiguous"):
        HK.iir_block_scan(torch.zeros(5, 2, 4, **meta).transpose(0, 1), a)
    with pytest.raises(RuntimeError, match="contiguous"):
        HK.iir_block_scan(u, a.T)
    with pytest.raises(RuntimeError, match="no backward"):
        HK.iir_block_scan(u.requires_grad_(), a)
    with pytest.raises(RuntimeError, match="expected CUDA tensors"):
        HK.iir_block_scan(u.detach(), a)


def _speechy(seed, nb, nch, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(nb, nch, n) * 0.05
    gaps = rng.rand(nb, 1, n // 4410 + 1) > 0.4  # silent stretches: both gates act
    return (x * np.repeat(gaps, 4410, axis=-1)[..., :n]).astype(np.float32)


@pytest.mark.parametrize("seed,nch,rate", [(14, 1, 44100), (15, 2, 48000), (16, 1, 16000)])
def test_loudness_matches_jax(seed, nch, rate):
    x = _speechy(seed, 3, nch, 3 * rate)
    x[2] *= 1e-5  # below the absolute gate: the -70 LUFS floor
    want = np.asarray(JL.loudness(jnp.asarray(x), rate))
    got = PL.loudness(torch.from_numpy(x), rate).numpy()
    assert np.abs(got - want).max() < 5e-3
    assert np.abs(PL.host_loudness(x, rate) - JL.host_loudness(x, rate)).max() < 5e-3


def test_short_audio_is_padded_before_metering():
    x = _noise((2, 1, 8000), 17, 0.3)  # under the 0.5 s minimum
    want = np.asarray(JL.loudness(jnp.asarray(x), 44100))
    assert np.abs(PL.loudness(torch.from_numpy(x), 44100).numpy() - want).max() < 5e-3


def test_integrated_loudness_layout_matches_jax():
    x = _speechy(18, 2, 2, 48000)
    want = np.asarray(JL.integrated_loudness(jnp.asarray(x.transpose(0, 2, 1)), 48000))
    got = PL.integrated_loudness(torch.from_numpy(x.transpose(0, 2, 1).copy()), 48000)
    assert np.abs(got.numpy() - want).max() < 5e-3


def test_long_equalizer_kernel_takes_the_fft_path():
    """20 bands at 44.1 kHz need 2667 taps, beyond kernel A: the FFT path."""
    x = _noise((2, 1, 22050), 8, 0.3)
    db = -np.random.RandomState(9).rand(2, 20).astype(np.float32)
    assert 2 * PFL._split_band_kernels(44100, 20)[1] + 1 > HK.MAX_TAPS_BATCH
    want = np.asarray(JFL.equalizer(jnp.asarray(x), jnp.asarray(db), 44100, conv_method="fft"))
    got = PFL.equalizer(torch.from_numpy(x), torch.from_numpy(db), 44100).numpy()
    assert _rel(got, want) < 1e-4


def test_fir_plain_version_matches_numpy_convolution():
    rng = np.random.RandomState(10)
    x = rng.randn(3, 3000).astype(np.float32)
    h = (rng.randn(3, 97) * 0.1).astype(np.float32)
    got = HK.fir_causal_batch_plain(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    want = np.stack([np.convolve(x[i].astype(np.float64), h[i])[:3000] for i in range(3)])
    assert _rel(got, want) < 1e-5
