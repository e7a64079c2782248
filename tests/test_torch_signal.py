"""The port's AudioSignal and effects against the JAX package's on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotools_tpu import AudioSignal as JSignal
from audiotools_tpu.core import Meter as JMeter
from audiotools_tpu_torch import AudioSignal, Meter
from audiotools_tpu_torch.core import util
from audiotools_tpu_torch.io import write_wav

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
    return AudioSignal(x.copy(), SR), JSignal(x.copy(), SR)


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
    _close(p.convolve(AudioSignal(ir, SR)), j.convolve(JSignal(ir, SR)), 1e-5)


@pytest.mark.parametrize("drr", [0.0, 12.0, np.array([5.0, 25.0], np.float32)])
def test_apply_ir_with_drr_and_eq_matches_jax(drr):
    x = _audio(3, (2, 1, 2 * SR))
    ir = _ir(4, 2, SR)
    eq = -np.random.RandomState(5).rand(2, 6).astype(np.float32)
    p, j = _pair(x)
    got = p.apply_ir(AudioSignal(ir, SR), drr, torch.from_numpy(eq))
    want = j.apply_ir(JSignal(ir, SR), drr, jnp.asarray(eq))
    _close(got, want, 1e-5)


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
    p.mix(AudioSignal(n, SR), np.array([10.0, 20.0], np.float32), torch.from_numpy(eq))
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
    sig = AudioSignal(path, offset=0.01, duration=0.02)
    assert sig.shape == (1, 2, 882) and sig.path_to_file == path
    assert np.array_equal(sig.audio_data.numpy(), x[..., 441:1323])
    assert AudioSignal(list(x[0, 0]), SR).shape == (1, 1, 3000)
    assert AudioSignal.zeros(0.5, SR, num_channels=2, batch_size=3).shape == (3, 2, SR // 2)
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


def test_batch_pads_or_refuses_mismatched_signals():
    a, b = AudioSignal(_audio(13, (1, 1, 100)), SR), AudioSignal(_audio(14, (1, 1, 80)), SR)
    with pytest.raises(RuntimeError, match="lengths"):
        AudioSignal.batch([a.clone(), b.clone()])
    assert AudioSignal.batch([a.clone(), b.clone()], pad_signals=True).shape == (2, 1, 100)
    assert AudioSignal.batch([a.clone(), b.clone()], truncate_signals=True).shape == (2, 1, 80)
    with pytest.raises(RuntimeError, match="sample rates"):
        AudioSignal.batch([a, AudioSignal(_audio(15, (1, 1, 100)), 16000)])


def test_indexing_and_where():
    sig = AudioSignal(_audio(16, (3, 1, 500)), SR)
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
