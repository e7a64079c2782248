"""The port's AudioSignal and effects against the JAX package's on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu import AudioSignal as JSignal
from audiotools_tpu.core import Meter as JMeter
from audiotools_tpu_torch import AudioSignal, Meter
from audiotools_tpu_torch.core import util
from audiotools_tpu_torch.io import write_wav
from audiotools_tpu_torch.ops import fft as PF

SR = 44100


def _audio(seed, shape, scale=0.1):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _ir(seed, batch, n):
    rng = np.random.RandomState(seed)
    ir = np.zeros((batch, 1, n), np.float32)
    for b in range(batch):
        ir[b, 0, 10 + 7 * b] = 1.0
        ir[b, 0, 11 + 7 * b :] = 0.2 * rng.randn(n - 11 - 7 * b) * np.exp(-np.linspace(0, 8, n - 11 - 7 * b))
    return ir


def _pair(x):
    return AudioSignal(x.copy(), SR, device="cpu"), JSignal(x.copy(), SR)


def _close(port, jax_sig, atol):
    got = port.audio_data.numpy() if hasattr(port, "audio_data") else np.asarray(port)
    want = np.asarray(jax_sig.audio_data) if hasattr(jax_sig, "audio_data") else np.asarray(jax_sig)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < atol


@pytest.mark.parametrize("T,K", [(SR, 9000), (20000, 4096), (6000, 6000), (6000, 9000)])
def test_convolve_matches_jax(T, K):
    """Every branch: compact IR with aliasing fold, compact IR that fits the
    pow2 transform, IR as long as (or longer than) the signal."""
    x = _audio(1, (2, 1, T))
    ir = _ir(2, 2, K)
    p, j = _pair(x)
    _close(p.convolve(AudioSignal(ir, SR, device="cpu")), j.convolve(JSignal(ir, SR)), 1e-5)


@pytest.mark.parametrize("drr", [0.0, 12.0, np.array([5.0, 25.0], np.float32)])
def test_apply_ir_with_drr_and_eq_matches_jax(drr):
    x = _audio(3, (2, 1, 2 * SR))
    ir = _ir(4, 2, SR)
    eq = -np.random.RandomState(5).rand(2, 6).astype(np.float32)
    p, j = _pair(x)
    got = p.apply_ir(AudioSignal(ir, SR, device="cpu"), drr, torch.from_numpy(eq))
    want = j.apply_ir(JSignal(ir, SR), drr, jnp.asarray(eq))
    _close(got, want, 1e-5)


# a silent lead of 20,000 samples, or half the signal where it is shorter
# than 40,000: frames of digital silence, where the FFT's zeros carry a sign
LEAD = 20000


def _lead(x, lead):
    x = x.copy()
    x[..., : min(lead, x.shape[-1] // 2)] = 0.0
    return x


@pytest.mark.parametrize("lead", [0, LEAD])
@pytest.mark.parametrize("drr_eq", [False, True])
@pytest.mark.parametrize("T,K", [(SR, 9000), (20000, 4096), (6000, 6000), (6000, 9000)])
def test_apply_ir_with_original_phase_matches_jax(T, K, drr_eq, lead):
    """F4: the wet magnitude on the dry phase, through every branch of
    ``convolve``, with and without the IR's EQ and DRR, with and without a
    silent lead (where the dry phase of an exactly-zero cell reads 0 in both
    packages, F5). The pin of ``test_apply_ir_with_drr_and_eq_matches_jax``,
    over every sample."""
    x = _lead(_audio(1, (2, 1, T)), lead)
    ir = _ir(2, 2, K)
    eq = -np.random.RandomState(5).rand(2, 6).astype(np.float32)
    drr = np.array([5.0, 25.0], np.float32)
    p, j = _pair(x)
    got = p.apply_ir(AudioSignal(ir, SR, device="cpu"), drr if drr_eq else None,
                     torch.from_numpy(eq) if drr_eq else None, use_original_phase=True)
    want = j.apply_ir(JSignal(ir, SR), drr if drr_eq else None,
                      jnp.asarray(eq) if drr_eq else None, use_original_phase=True)
    _close(got, want, 1e-5)
    assert got.stft_data is not None


def test_apply_ir_with_original_phase_reads_the_wet_spectrum():
    """With a dry STFT cached beforehand, the magnitude put on the dry phase
    is still the wet signal's: the convolved audio's STFT is taken anew (the
    audio setter keeps the cached spectrum), as in the JAX package."""
    x = _lead(_audio(3, (2, 1, 2 * SR)), LEAD)
    ir = _ir(4, 2, SR)
    p, j = _pair(x)
    dry = p.stft().clone()
    j.stft()
    got = p.apply_ir(AudioSignal(ir, SR, device="cpu"), use_original_phase=True)
    want = j.apply_ir(JSignal(ir, SR), use_original_phase=True)
    _close(got, want, 1e-5)
    # not the dry magnitude on the dry phase: that is the dry signal again
    assert np.abs(got.audio_data.numpy() - x).max() > 1e-2
    assert not torch.equal(got.stft_data.abs(), dry.abs())


def test_phase_reads_zero_at_every_exactly_zero_cell():
    """F5: ``phase`` is 0 where the spectrum is exactly ``0 + 0j``, as the
    JAX package's reads, although the CPU's FFT gives ``-0.0`` (angle pi) in
    some such cells; elsewhere it is ``angle``. The magnitude setter then
    puts a new magnitude at phase 0 there, as the JAX package does."""
    x = _lead(_audio(30, (2, 1, 2 * SR)), LEAD)
    p, j = _pair(x)
    z = p.stft()
    zero = z == 0
    assert int(zero.sum()) > 1000
    assert bool((z.angle()[zero] != 0).any())  # the sign that read pi before
    phase = p.phase
    assert bool((phase[zero] == 0).all())
    assert torch.equal(phase[~zero], z.angle()[~zero])
    want = np.asarray(j.phase)
    assert (want[zero.numpy()] == 0).all()
    ones = torch.ones(z.shape)
    p.magnitude = ones
    j.magnitude = jnp.ones(z.shape)
    assert bool((p.stft_data.real[zero] == 1).all())
    assert np.abs(p.stft_data.numpy() - np.asarray(j.stft_data))[zero.numpy()].max() == 0


def test_phase_passes_no_gradient_into_a_zero_cell():
    """``angle``'s backward at ``0 + 0j`` and the constant branch give a
    zero, finite gradient there; elsewhere the gradient is ``angle``'s."""
    z = torch.tensor([[[[0j, -0.0 + 0j, 1 + 1j, -2 + 0.5j]]]], dtype=torch.complex64)
    leaf = z.clone().requires_grad_(True)
    sig = AudioSignal(np.zeros((1, 1, 8), np.float32), SR, device="cpu")
    sig.stft_data = leaf
    (sig.phase * torch.arange(1.0, 5.0)).sum().backward()
    ref = z.clone().requires_grad_(True)
    (ref.angle() * torch.arange(1.0, 5.0)).sum().backward()
    assert bool(torch.isfinite(torch.view_as_real(leaf.grad)).all())
    assert torch.equal(leaf.grad[..., :2], torch.zeros(1, 1, 1, 2, dtype=torch.complex64))
    assert torch.equal(leaf.grad[..., 2:], ref.grad[..., 2:])


def test_drr_measure_and_decomposition_match_jax():
    ir = _ir(6, 3, 8000)
    p, j = _pair(ir)
    assert np.abs(p.measure_drr().numpy() - np.asarray(j.measure_drr())).max() < 1e-4
    for a, b in zip(p.decompose_ir(), j.decompose_ir()):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-6


def test_mix_normalize_volume_match_jax():
    x, n = _audio(7, (2, 1, SR)), _audio(8, (2, 1, SR - 500), 0.3)
    eq = -np.random.RandomState(9).rand(2, 3).astype(np.float32)
    p, j = _pair(x)
    p.mix(AudioSignal(n, SR, device="cpu"), np.array([10.0, 20.0], np.float32), torch.from_numpy(eq))
    j.mix(JSignal(n, SR), jnp.asarray([10.0, 20.0]), jnp.asarray(eq))
    _close(p, j, 1e-5)
    _close(p.normalize(-20.0), j.normalize(-20.0), 1e-5)
    assert np.abs(p.loudness().numpy() + 20.0).max() < 0.05
    _close(p.volume_change(np.array([-3.0, 2.0])), j.volume_change(jnp.asarray([-3.0, 2.0])), 1e-5)


def test_loudness_is_cached_until_the_audio_changes():
    p, _ = _pair(_audio(10, (2, 1, SR)))
    first = p.loudness()
    assert p.loudness() is first
    p.audio_data = p.audio_data * 0.5
    assert p._loudness is None
    assert np.allclose(p.loudness().numpy(), first.numpy() - 6.0206, atol=1e-3)


def test_meter_matches_jax():
    x = _audio(11, (2, SR, 2), 0.2)
    got = Meter(SR).integrated_loudness(torch.from_numpy(x))
    want = JMeter(SR).integrated_loudness(jnp.asarray(x))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 5e-3


def test_signal_construction_and_shape_ops(tmp_path):
    x = _audio(12, (1, 2, 3000))
    path = tmp_path / "a.wav"
    write_wav(path, x[0], SR, subtype="FLOAT")
    sig = AudioSignal(path, offset=0.01, duration=0.02, device="cpu")
    assert sig.shape == (1, 2, 882) and sig.path_to_file == path
    assert np.array_equal(sig.audio_data.numpy(), x[..., 441:1323])
    assert AudioSignal(list(x[0, 0]), SR, device="cpu").shape == (1, 1, 3000)
    assert AudioSignal.zeros(0.5, SR, num_channels=2, batch_size=3, device="cpu").shape == (3, 2, SR // 2)
    assert sig.clone().to_mono().shape == (1, 1, 882)
    assert sig.clone().zero_pad_to(1000, mode="before").signal_length == 1000
    assert sig.clone().truncate_samples(10).signal_length == 10
    resampled = sig.clone().resample(16000)
    assert resampled.sample_rate == 16000 and resampled.signal_length == 320
    assert sig.duration == pytest.approx(0.02)
    with pytest.raises(ValueError, match="sample_rate"):
        AudioSignal(x)
    with pytest.raises(ValueError, match="Cannot build"):
        AudioSignal(3.0, SR)


@pytest.mark.parametrize("mode", ["after", "before", "center"])
@pytest.mark.parametrize("length", [1500, 600])
def test_zero_pad_to_matches_jax(length, mode):
    """Padding before or after, or for any other mode (and for a target
    shorter than the signal) not at all, as the JAX package does."""
    port, jax_sig = _pair(_audio(13, (2, 2, 1000)))
    assert port.zero_pad_to(length, mode=mode) is port
    jax_sig.zero_pad_to(length, mode=mode)
    assert port.signal_length == jax_sig.signal_length
    assert np.array_equal(port.audio_data.numpy(), np.asarray(jax_sig.audio_data))


def test_batch_pads_or_refuses_mismatched_signals():
    a = AudioSignal(_audio(13, (1, 1, 100)), SR, device="cpu")
    b = AudioSignal(_audio(14, (1, 1, 80)), SR, device="cpu")
    with pytest.raises(RuntimeError, match="lengths"):
        AudioSignal.batch([a.clone(), b.clone()])
    assert AudioSignal.batch([a.clone(), b.clone()], pad_signals=True).shape == (2, 1, 100)
    assert AudioSignal.batch([a.clone(), b.clone()], truncate_signals=True).shape == (2, 1, 80)
    with pytest.raises(RuntimeError, match="sample rates"):
        AudioSignal.batch([a, AudioSignal(_audio(15, (1, 1, 100)), 16000, device="cpu")])


def test_indexing_and_where():
    sig = AudioSignal(_audio(16, (3, 1, 500)), SR, device="cpu")
    sig.loudness()
    picked = sig[np.array([True, False, True])]
    assert picked.batch_size == 2 and picked._loudness.shape == (2,)
    assert sig[1].batch_size == 1
    other = AudioSignal(torch.zeros(3, 1, 500), SR)
    mixed = AudioSignal.where(np.array([True, False, True]), sig, other)
    assert torch.equal(mixed.audio_data[0], sig.audio_data[0])
    assert float(mixed.audio_data[1].abs().max()) == 0.0


def test_ensure_tensor_and_random_state():
    t = util.ensure_tensor(np.float64(2.5), ndim=2, batch_size=3)
    assert t.shape == (3, 1) and t.dtype == torch.float32
    with pytest.raises(ValueError, match="at most"):
        util.ensure_tensor(np.zeros((2, 2, 2)), ndim=2)
    state = np.random.RandomState(0)
    assert util.random_state(state) is state
    assert util.random_state(None) is np.random.mtrand._rand
    with pytest.raises(ValueError):
        util.random_state("seed")
    assert util.sample_from_dist(("const", 4)) == 4
    batch = util.collate([{"a": 1, "b": {"c": 0.5}}, {"a": 2, "b": {"c": 1.5}}])
    assert batch["a"].dtype == np.int32 and batch["b"]["c"].dtype == np.float32


# -- repairs of the STFT cache and the pitch shift's signature ---------------


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_pitch_shift_drops_the_cached_stft():
    """R6: after ``stft(); pitch_shift(2)`` the magnitude is the shifted
    audio's, as in the JAX package. The pitch shift's pin is 1e-4 on the
    audio (tests/test_torch_defaults.py); through the STFT a sample's error
    moves a bin by at most the window's sum times it."""
    p, j = _pair(_audio(20, (2, 1, 8192)))
    before = p.stft().abs().clone()
    j.stft()
    p.pitch_shift(2)
    j.pitch_shift(2)
    assert p.stft_data is None
    assert np.abs(p.audio_data.numpy() - np.asarray(j.audio_data)).max() < 1e-4
    window_sum = float(np.sum(PF.get_window("hann", 2048)))
    assert np.abs(p.magnitude.numpy() - np.asarray(j.magnitude)).max() < 1e-4 * window_sum
    assert torch.equal(p.magnitude, p.clone().stft().abs())
    assert _rel(p.magnitude.numpy(), before.numpy()) > 1e-2


def test_getitem_keeps_stft_params_and_co_indexes_the_stft():
    """R7: a slice of a signal with a 512/128 STFT keeps its parameters and
    its cached STFT, as the JAX package's does."""
    from audiotools_tpu.core import STFTParams as JParams
    from audiotools_tpu_torch.core.signal import STFTParams

    x = _audio(21, (3, 1, 8192))
    p = AudioSignal(x.copy(), SR, stft_params=STFTParams(512, 128), device="cpu")
    j = JSignal(x.copy(), SR, stft_params=JParams(512, 128))
    p.stft()
    j.stft()
    p.loudness()
    for key in (slice(0, 1), np.array([True, False, True]), [2, 0], 1):
        got, want = p[key], j[key]
        assert got.stft_params == tuple(want.stft_params)
        # the STFT's parity pin (tests/test_torch_ops.py), and exactly the
        # port's own items
        assert _rel(got.stft_data.numpy().reshape(-1), np.asarray(want.stft_data).reshape(-1)) < 1e-5
        items = np.arange(3)[key if not isinstance(key, list) else np.asarray(key)]
        assert torch.equal(got.stft_data.reshape(-1), p.stft_data[items].reshape(-1))
        assert got.stft_data.ndim == 4 and got._loudness.ndim == 1
    one = p[0:1]
    assert one[np.True_].stft_data is one.stft_data
    assert p[(0, ..., slice(0, 100))].stft_data is None  # samples indexed: cache dropped
    with pytest.raises(ValueError, match="batch 1"):
        p[np.array(True)]
    with pytest.raises(ValueError, match="Unsupported key"):
        p[np.zeros((2, 2), bool)]


@pytest.mark.parametrize("mismatch", [False, True])
def test_where_selects_the_cached_stft_per_item(mismatch):
    """R8: ``where`` of two cached STFTs under a mixed mask takes each item's
    STFT from its side, as the JAX package does; STFTs of another shape
    leave the result without one."""
    a, b = _audio(22, (2, 1, 8192)), _audio(23, (2, 1, 8192))
    pa, ja = _pair(a)
    pb, jb = _pair(b)
    for s in (pa, ja):
        s.stft()
    for s in (pb, jb):
        s.stft(window_length=1024 if mismatch else None, hop_length=256 if mismatch else None)
    mask = np.array([True, False])
    got, want = AudioSignal.where(mask, pa, pb), JSignal.where(mask, ja, jb)
    assert np.array_equal(got.audio_data.numpy(), np.asarray(want.audio_data))
    if mismatch:
        assert got.stft_data is None and want.stft_data is None
    else:
        assert _rel(got.stft_data.numpy(), want.stft_data) < 1e-5  # the STFT's pin
        assert torch.equal(got.stft_data[0], pa.stft_data[0])
        assert torch.equal(got.stft_data[1], pb.stft_data[1])


def test_pitch_shift_accepts_quick():
    """R9: ``quick`` is accepted and ignored; other keywords pass through."""
    x = _audio(24, (1, 1, 8192))
    plain = AudioSignal(x.copy(), SR, device="cpu").pitch_shift(2)
    quick = AudioSignal(x.copy(), SR, device="cpu").pitch_shift(2, quick=True)
    assert torch.equal(plain.audio_data, quick.audio_data)
    with pytest.raises(TypeError):
        AudioSignal(x.copy(), SR, device="cpu").pitch_shift(2, no_such_option=1)
    phasor = AudioSignal(x.copy(), SR, device="cpu").pitch_shift(2, quick=False,
                                                                 pv_formulation="phasor")
    assert not torch.equal(phasor.audio_data, plain.audio_data)
