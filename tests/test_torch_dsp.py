"""The port's sinc filters, DSP mixin, effects, log magnitude, signal
surface and spectral gate against the JAX package's on the CPU.

Inputs are 2 x 1 x 8192 noise or 2 x 1 s of speech made from a seed with
numpy. Each tolerance is the JAX package's own pin for the function:
low_pass 5e-6 and high_pass 1e-5 (tests/core/test_filters_resample.py:
tight vs wide support, complement), overlap-save 1e-4 (against
fft_conv1d), pre-emphasis 1e-5, log magnitude 1e-4
(tests/core/test_fft_ops.py), magnitude and phase setters 1e-4
(tests/core/test_audio_signal.py), the transforms' outputs 1e-6
(tests/data/test_transforms.py:68: the same arguments twice) and the
spectral gate 1e-4 (its regression snapshot, SpectralDenoising.wav).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu import AudioSignal as JSignal
from audiotools_tpu.core import util as ju
from audiotools_tpu.ml.layers import SpectralGate as JGate
from audiotools_tpu.ops import fft as JF
from audiotools_tpu.ops import filters as JFL
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch.core import _dsp
from audiotools_tpu_torch.core import util as pu
from audiotools_tpu_torch.ml.layers import SpectralGate
from audiotools_tpu_torch.ops import fft as PF
from audiotools_tpu_torch.ops import filters as PFL
from tests.fixtures import speech_like

SR = 44100


def _noise(seed, shape=(2, 1, 8192), scale=0.1):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _speech(seed=0, batch=2):
    return np.stack([speech_like(seed + i, 1.0)[None] for i in range(batch)])


def _pair(x):
    return AudioSignal(x.copy(), SR, device="cpu"), JSignal(x.copy(), SR)


def _err(got, want):
    got = got.audio_data if isinstance(got, AudioSignal) else got
    want = want.audio_data if isinstance(want, JSignal) else want
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max()


# -- ops/filters ------------------------------------------------------------


@pytest.mark.parametrize("cutoff,half", [(4000 / SR, 281), (np.array([0.02, 0.3], np.float32), 1300),
                                         (np.array([0.5, 0.0], np.float32), 8)])
def test_lowpass_kernel_matches_jax(cutoff, half):
    got = PFL.lowpass_kernel(torch.as_tensor(cutoff), 51, half).numpy()
    want = np.asarray(JFL.lowpass_kernel(jnp.asarray(cutoff), 51, half))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-7


@pytest.mark.parametrize("cutoffs,route", [
    (np.array([4000.0, 8000.0], np.float32), "overlap-save"),
    (np.array([50.0, 400.0], np.float32), "one FFT"),
    (2000.0, "overlap-save"),
])
def test_low_and_high_pass_match_jax(cutoffs, route):
    """Both convolution routes: a 4 kHz cutoff gives 563 taps (overlap-save in
    8192-point blocks), 50 Hz gives 44,983 (one full-length FFT)."""
    x = _noise(1)
    half = int(51 / (float(np.min(cutoffs)) / SR) / 2)
    assert (PFL._auto_block(2 * half, 8, 4096, 32768) is None) == (route == "one FFT")
    got = PFL.low_pass(torch.from_numpy(x), torch.as_tensor(cutoffs), SR)
    assert _err(got, JFL.low_pass(jnp.asarray(x), jnp.asarray(cutoffs), SR)) < 5e-6
    got = PFL.high_pass(torch.from_numpy(x), torch.as_tensor(cutoffs), SR)
    assert _err(got, JFL.high_pass(jnp.asarray(x), jnp.asarray(cutoffs), SR)) < 1e-5
    # a support sized by min_cutoff_hz below the cutoffs gives the same filter
    wide = PFL.low_pass(torch.from_numpy(x), torch.as_tensor(cutoffs), SR, min_cutoff_hz=40.0,
                        block_size=None)
    assert _err(wide, JFL.low_pass(jnp.asarray(x), jnp.asarray(cutoffs), SR)) < 5e-6


def test_overlap_save_and_fft_conv_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 1, 7001).astype(np.float32)
    k = rng.randn(4, 513).astype(np.float32)
    for correlate in (True, False):
        got = PFL.overlap_save_valid(torch.from_numpy(x)[..., None, :], torch.from_numpy(k), 2048,
                                     correlate=correlate)
        want = JFL.overlap_save_valid(jnp.asarray(x)[..., None, :], jnp.asarray(k), 2048,
                                      correlate=correlate)
        assert _err(got, want) < 1e-4
    with pytest.raises(ValueError, match="must exceed"):
        PFL.overlap_save_valid(torch.zeros(1, 256), torch.zeros(129), 128)
    k2 = rng.randn(2, 301).astype(np.float32)
    got = PFL._fft_conv_valid(torch.from_numpy(x), torch.from_numpy(k2))
    assert _err(got, JFL._fft_conv_valid(jnp.asarray(x), jnp.asarray(k2))) < 1e-4
    assert np.array_equal(PFL._edge_pad(torch.from_numpy(x), 5).numpy(),
                          np.asarray(JFL._edge_pad(jnp.asarray(x), 5)))
    for overlap in (10, 562, 2047, 4095, 44982):
        assert PFL._auto_block(overlap, 8, 4096, 32768) == JFL._auto_block(overlap, 8, 4096, 32768)


def test_preemphasis_matches_jax():
    x = _noise(7, (2, 1, 4096))
    got = PFL.preemphasis(torch.from_numpy(x), 0.85)
    assert _err(got, JFL.preemphasis(jnp.asarray(x), 0.85)) < 1e-5
    p, j = _pair(x)
    assert _err(p.preemphasis(0.9), j.preemphasis(0.9)) < 1e-5


def test_dist_lower_bound_matches_jax():
    for dist in (("const", 3.0), ("uniform", 40.0, 80.0), ("choice", [8000, 4000]), 7,
                 ("normal", 0.0, 1.0), ()):
        assert pu.dist_lower_bound(dist, default=40.0) == ju.dist_lower_bound(dist, default=40.0)


# -- core/_dsp.py -----------------------------------------------------------


def test_dsp_filters_match_jax_and_drop_the_stft():
    x = _speech()
    cut = np.array([1000.0, 8000.0], np.float32)
    for method, pin in (("low_pass", 5e-6), ("high_pass", 1e-5)):
        p, j = _pair(x)
        p.stft()
        got = getattr(p, method)(cut, min_cutoff_hz=500.0)
        assert got.stft_data is None
        assert _err(got, getattr(j, method)(jnp.asarray(cut), min_cutoff_hz=500.0)) < pin
        p, j = _pair(x)
        assert _err(getattr(p, method)(4000), getattr(j, method)(4000)) < pin


@pytest.mark.parametrize("stop,num", [(22050.0, 1025), (22050.0, 513), (8000.0, 257),
                                      (1.0, 87), (5.0, 431), (2.9999, 300), (1.0, 1)])
def test_mask_grids_are_bit_equal_to_jax(stop, num):
    (grid,) = _dsp._grid(stop, num)
    want = np.asarray(jnp.linspace(0, stop, num))
    assert grid.dtype == want.dtype and np.array_equal(grid, want)


def _spectral_pair(seed=0):
    p, j = _pair(_speech(seed))
    p.stft()
    j.stft()
    return p, j


def _stft_err(p, j):
    got, want = p.stft_data.numpy(), np.asarray(j.stft_data)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("method,args", [
    ("mask_frequencies", (np.array([0.0, 1000.0], np.float32), np.array([3000.0, 1033.59375], np.float32))),
    ("mask_timesteps", (np.array([0.1, 0.25], np.float32), np.array([0.4, 0.5], np.float32))),
    ("mask_low_magnitudes", (np.array([-10.0, 5.0], np.float32),)),
    ("shift_phase", (np.array([0.5, -2.0], np.float32),)),
])
def test_spectral_methods_match_jax(method, args):
    """The masks select the same cells (the second frequency mask ends on a
    bin: 1033.59375 Hz is bin 48 of 1025), then the audio after the
    inverse STFT agrees at the transforms' pin."""
    p, j = _spectral_pair()
    getattr(p, method)(*args)
    getattr(j, method)(*(jnp.asarray(a) for a in args))
    assert _stft_err(p, j) < 1e-5  # the STFT's pin (tests/test_torch_ops.py)
    if method.startswith("mask"):
        assert np.array_equal(p.magnitude.numpy() == 0, np.asarray(j.magnitude) == 0)
    assert _err(p.istft(), j.istft()) < 1e-6


def test_shift_phase_broadcasts_a_plane_over_the_batch():
    p, j = _spectral_pair(1)
    plane = np.random.RandomState(2).randn(*p.phase.shape[1:]).astype(np.float32)
    p.shift_phase(plane)
    j.shift_phase(jnp.asarray(plane))
    assert _stft_err(p, j) < 1e-5
    full = np.random.RandomState(3).randn(*p.phase.shape).astype(np.float32)
    p.shift_phase(full)
    j.shift_phase(jnp.asarray(full))
    assert _err(p.istft(), j.istft()) < 1e-6


def test_corrupt_phase_draws_only_from_the_state_given():
    """A RandomState draws the JAX package's host stream (its numpy path,
    here seeded); a torch.Generator draws on its device; the global
    generators are never touched and no state raises."""
    p, j = _spectral_pair(2)
    np.random.seed(5)
    j.corrupt_phase(np.array([0.5, 1.0], np.float32))
    before = (np.random.get_state()[1].copy(), torch.random.get_rng_state().clone())
    p.corrupt_phase(np.array([0.5, 1.0], np.float32), np.random.RandomState(5))
    assert _stft_err(p, j) < 1e-5
    assert _err(p.istft(), j.istft()) < 1e-6
    q, _ = _spectral_pair(2)
    q.corrupt_phase(0.5, torch.Generator().manual_seed(0))
    r, _ = _spectral_pair(2)
    r.corrupt_phase(0.5, torch.Generator().manual_seed(0))
    assert torch.equal(q.stft_data, r.stft_data)
    assert np.array_equal(np.random.get_state()[1], before[0])
    assert torch.equal(torch.random.get_rng_state(), before[1])
    with pytest.raises(ValueError, match="Generator"):
        q.corrupt_phase(0.5, None)


# -- effects ----------------------------------------------------------------


@pytest.mark.parametrize("perc", [0.1, np.array([0.0, 0.35], np.float32)])
def test_clip_distortion_matches_jax(perc):
    x = _speech(3)
    x[1, 0, 100] = x[1, 0, 2000]  # ties
    p, j = _pair(x)
    assert _err(p.clip_distortion(perc), j.clip_distortion(jnp.asarray(perc))) == 0.0


def test_row_quantiles_match_jnp_quantile():
    from audiotools_tpu_torch.core._effects import _row_quantiles

    x = _noise(4, (3, 2, 1001))
    x[2, 1, 7] = np.nan
    q = np.array([[0.0, 0.3, 0.999], [1.0, 0.5, 0.25]], np.float32)
    got = _row_quantiles(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    want = np.stack([[np.asarray(jnp.quantile(jnp.asarray(x[b]), q[i, b], axis=-1, keepdims=True))
                      for b in range(3)] for i in range(2)])
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("channels", [8, np.array([32, 1024], np.int32)])
def test_quantizers_match_jax_with_a_straight_through_gradient(channels):
    """Uniform quantization is exact. The mu-law expansion's ``exp`` and
    ``log1p`` round differently in the two libraries (by an ulp or so in
    some samples), but no sample changes level."""
    x = _speech(4)
    for method, pin in (("quantization", 0.0), ("mulaw_quantization", 1e-6)):
        p, j = _pair(x)
        got = getattr(p, method)(channels)
        assert _err(got, getattr(j, method)(jnp.asarray(channels))) <= pin
        audio = torch.from_numpy(x.copy()).requires_grad_(True)
        getattr(AudioSignal(audio, SR), method)(channels).audio_data.sum().backward()
        assert torch.equal(audio.grad, torch.ones_like(audio))


# -- signal surface -------------------------------------------------------


def test_log_magnitude_matches_jax():
    mag = np.abs(np.random.RandomState(4).randn(3, 5, 7)).astype(np.float32)
    for kw in ({}, {"ref_value": 2.0, "amin": 1e-3, "top_db": 40.0}, {"top_db": None}):
        got = PF.log_magnitude(torch.from_numpy(mag), **kw)
        assert _err(got, JF.log_magnitude(jnp.asarray(mag), **kw)) < 1e-4
    p, j = _spectral_pair(5)
    assert _err(p.log_magnitude(top_db=40.0), j.log_magnitude(top_db=40.0)) < 1e-4


def test_stft_setters_match_jax():
    p, j = _spectral_pair(6)
    mag, phase = p.magnitude, p.phase
    p.magnitude = mag * 0.5
    j.magnitude = j.magnitude * 0.5
    p.phase = phase + 1.0
    j.phase = j.phase + 1.0
    assert _stft_err(p, j) < 1e-4
    with pytest.raises(ValueError, match="complex"):
        p.stft_data = mag
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p.stft_data = p.stft_data[..., :10]
    assert any("changed shape" in str(w.message) for w in caught)
    p.stft_data = None
    assert p.stft_data is None


def test_window_trim_and_operators_match_jax():
    for window_type, length in (("average", 16), ("sqrt_hann", 512), ("hann", 64)):
        got = AudioSignal.get_window(window_type, length)
        want = JSignal.get_window(window_type, length)
        assert got.device.type == "cpu" and np.array_equal(got.numpy(), np.asarray(want))
    a, b = _noise(8), _noise(9)
    (pa, ja), (pb, jb) = _pair(a), _pair(b)
    assert _err(pa.clone().trim(10, 20), ja.clone().trim(10, 20)) == 0.0
    assert _err(pa + pb, ja + jb) == 0.0
    assert _err(1.0 + pa, 1.0 + ja) == 0.0
    assert _err(pa - pb, ja - jb) == 0.0
    assert _err(pa * 0.5, ja * 0.5) == 0.0
    gain = np.array([[[2.0]], [[3.0]]], np.float32)
    assert _err(pa * torch.from_numpy(gain), ja * jnp.asarray(gain)) == 0.0
    c = pa.clone()
    c += pb
    assert _err(c, ja + jb) == 0.0 and pa.audio_data is not c.audio_data


# -- ml/layers/spectral_gate.py ---------------------------------------------


def test_spectral_gate_matches_jax():
    clean = _speech(7)
    nz = (np.random.RandomState(1).randn(2, 1, SR) * 0.01).astype(np.float32)
    p, j = _pair(clean + nz)
    pn, jn = _pair(nz)
    p.stft()  # the gate analyses a clone with its own parameters
    gate = SpectralGate()
    assert isinstance(gate, torch.nn.Module)
    assert [name for name, _ in gate.named_buffers()] == ["smoothing_filter"]
    assert np.array_equal(gate.smoothing_filter.numpy(), np.asarray(JGate().smoothing_filter))
    amount = np.array([1.0, 0.8], np.float32)
    got = gate(p, pn, torch.from_numpy(amount))
    want = JGate()(j, jn, jnp.asarray(amount))
    assert _err(got, want) < 1e-4
    assert got.stft_params == tuple(want.stft_params)
    assert p.stft_data.shape[-2] == 1025 and p.stft_params.window_type == "hann"
    small = SpectralGate(1, 2)
    assert np.array_equal(small.smoothing_filter.numpy(), np.asarray(JGate(1, 2).smoothing_filter))
    assert _err(small(p.clone(), pn, 0.5), JGate(1, 2)(j.clone(), jn, 0.5)) < 1e-4
