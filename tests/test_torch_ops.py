"""The port's ops against the JAX package's on the CPU, same numpy inputs.

Tolerances are the JAX package's own pins for these functions or tighter:
iSTFT 1e-4 absolute (tests/parity/test_parity.py, ISTFT vs torch.istft),
loudness 5e-3 dB (test_parity.py, host vs device meter).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from audiotools_tpu.ops import fft as JF
from audiotools_tpu.ops import filters as JFL
from audiotools_tpu.ops import loudness as JL
from audiotools_tpu.ops import resample as JR
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
    got = PF.stft(torch.from_numpy(x), win, hop, match_stride=match_stride).numpy()
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
    got = PF.istft(torch.from_numpy(mod), win, hop, match_stride=match_stride, length=T).numpy()
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
    (relative rounding <= 2**-9 each) and sums in fp32. Its waveform stays
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
    x = torch.zeros(1, 4096)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PF.stft(x, 512, 128, method="fft")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PF.istft(torch.zeros(1, 257, 9, dtype=torch.complex64), 512, 128, length=4096,
                 method="matmul_bf16_fused")


@pytest.mark.parametrize("n_mels,sr", [(80, 44100), (40, 16000)])
def test_mel_spectrogram_matches_jax(n_mels, sr):
    x = _noise((2, 1, sr), 5, 0.3)
    want = np.asarray(JF.mel_spectrogram(jnp.asarray(x), sr, n_mels, method="matmul"))
    got = PF.mel_spectrogram(torch.from_numpy(x), sr, n_mels).numpy()
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
    assert 2 * PFL._split_band_kernels(44100, 20)[1] + 1 > HK.MAX_TAPS
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
