"""Kernels A and B of the port on the CPU: their plain versions against the
JAX package's Pallas kernels run in interpret mode, and the dispatch rules
of their wrappers (a non-CPU tensor goes to the kernel or the call raises).
"""
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu.ops import filters as JFL
from audiotools_tpu.ops import pallas_kernels as JPK
from audiotools_tpu.ops import stretch as JS
from audiotools_tpu_torch import _build
from audiotools_tpu_torch.ops import filters as PFL
from audiotools_tpu_torch.ops import hopper_kernels as HK
from audiotools_tpu_torch.ops import ragged_shapes as RAGGED
from audiotools_tpu_torch.ops import stretch as PS


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


# -- A: the equalizer's per-item FIR ----------------------------------------


@pytest.mark.parametrize("shape,db_shape,n_bands", [
    ((2, 1, 22050), (2, 6), 6),
    ((3, 2, 22050), (6,), 6),  # one curve broadcast over a batch of stereo
    ((3, 2, 22050), (1, 6), 6),
    ((2, 1, 22050), (2, 3), 3),
])
def test_equalizer_matches_jax_pallas_interpret(shape, db_shape, n_bands):
    rng = np.random.RandomState(sum(shape) + n_bands)
    x = rng.randn(*shape).astype(np.float32)
    db = (rng.rand(*db_shape) * 12 - 6).astype(np.float32)
    want = np.asarray(JFL.equalizer(jnp.asarray(x), jnp.asarray(db), 44100,
                                    conv_method="pallas_interpret"))
    got = PFL.equalizer(torch.from_numpy(x), torch.from_numpy(db), 44100).numpy()
    assert got.shape == x.shape
    # the JAX package's pin for its Pallas FIR (tests/core/test_pallas_kernels.py)
    assert _rel(got, want) < 1e-4


def test_fir_plain_matches_jax_batch_kernel():
    rng = np.random.RandomState(7)
    x = rng.randn(3, 5000).astype(np.float32)
    h = (rng.randn(3, 481) * 0.1).astype(np.float32)
    want = np.asarray(JPK.fir_conv_causal_batch(jnp.asarray(x), jnp.asarray(h), interpret=True))
    got = HK.fir_causal_batch(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    assert _rel(got, want) < 1e-4


def test_fir_wrapper_checks_its_inputs():
    with pytest.raises(ValueError, match="batch"):
        HK.fir_causal_batch(torch.zeros(2, 100), torch.zeros(3, 5))
    with pytest.raises(TypeError, match="float32"):
        HK.fir_causal_batch(torch.zeros(2, 100, dtype=torch.float64), torch.zeros(2, 5))


# -- B: the fused phasor phase vocoder --------------------------------------


def _spectrum(seed, shape):
    rng = np.random.RandomState(seed)
    z = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    z[..., 3, :] = 0  # a silent bin
    z[..., 5, 1::4] = 0  # transient zero frames
    return z


@pytest.mark.parametrize("rate", [2.0 ** (-2.0 / 12.0), 1.31, 0.77])
def test_phase_vocoder_matches_jax_fused_interpret(rate):
    z = _spectrum(0, (2, 129, 61))
    want = np.asarray(JS.phase_vocoder(jnp.asarray(z), rate, 64, 256,
                                       formulation="phasor_fused_interpret"))
    got = PS.phase_vocoder(torch.from_numpy(z), rate, 64, 256, formulation="phasor_fused").numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("rate", [2.0 ** (-2.0 / 12.0), 1.31, 0.77])
def test_phasor_fused_interpret_matches_jax_interpret(rate):
    """Both packages' interpreter-mode name: B's plain version against the
    Pallas kernel interpreted, at B's pin."""
    z = _spectrum(2, (2, 129, 61))
    want = np.asarray(JS.phase_vocoder(jnp.asarray(z), rate, 64, 256,
                                       formulation="phasor_fused_interpret"))
    got = PS.phase_vocoder(torch.from_numpy(z), rate, 64, 256,
                           formulation="phasor_fused_interpret").numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


def test_phasor_fused_interpret_runs_bs_plain_version(monkeypatch):
    """``"phasor_fused_interpret"`` never calls kernel B's wrapper, with or
    without grad, and gives what ``"phasor_fused"`` gives a CPU tensor;
    ``time_stretch`` and ``pitch_shift`` pass the name through."""
    z = torch.from_numpy(_spectrum(3, (1, 65, 40)))
    x = torch.from_numpy((np.random.RandomState(4).randn(1, 1, 8192) * 0.1).astype(np.float32))
    ops = ((PS.time_stretch, (1.2,)), (PS.pitch_shift, (2.0, 44100)))
    want = PS.phase_vocoder(z, 0.9, 64, 256, formulation="phasor_fused")
    want_ops = [op(x, *args, window_length=512, pv_formulation="phasor_fused")
                for op, args in ops]
    monkeypatch.setattr(HK, "phase_vocoder_fused", lambda *a, **k: pytest.fail("kernel B called"))
    assert torch.equal(PS.phase_vocoder(z, 0.9, 64, 256, formulation="phasor_fused_interpret"),
                       want)
    grad = PS.phase_vocoder(z.clone().requires_grad_(True), 0.9, 64, 256,
                            formulation="phasor_fused_interpret")
    assert torch.equal(grad.detach(), want)
    for (op, args), w in zip(ops, want_ops):
        assert torch.equal(op(x, *args, window_length=512, pv_formulation="phasor_fused_interpret"),
                           w)


def test_phasor_track_matches_jax():
    z = _spectrum(1, (1, 2, 65, 40))
    i0, i1, frac = PS._pv_indices(40, 0.9)
    want, (wpr, wpi) = JPK.phase_vocoder_fused(jnp.asarray(z), i0, i1, frac,
                                               interpret=True, with_phasor=True)
    got, track = HK.phase_vocoder_fused(torch.from_numpy(z), i0, i1, frac, with_phasor=True)
    assert _rel(got.numpy(), want) < 1e-5
    assert _rel(track.real.numpy(), wpr) < 1e-5
    assert _rel(track.imag.numpy(), wpi) < 1e-5
    # |P| = 1, and out = mag * P
    assert np.abs(np.abs(track.numpy()) - 1).max() < 1e-5


@pytest.mark.parametrize("case", [c for c, (shape, _) in enumerate(RAGGED.PV)
                                  if np.prod(shape[:-1]) <= 2050])
def test_phase_vocoder_matches_jax_on_ragged_cases(case):
    """The kernel's ragged cases (``ops.ragged_shapes.PV``: a single bin,
    steps fewer than the prefetch depth, rates 0.77 to 2, silent bins and
    zero frames, a step table that is not monotone) through the plain
    version and the Pallas kernel interpreted, with the phasor track."""
    shape, rate = RAGGED.PV[case]
    z, i0, i1, frac = RAGGED.pv_case(shape, rate, seed=case)
    want, (wpr, wpi) = JPK.phase_vocoder_fused(jnp.asarray(z), i0, i1, frac,
                                               interpret=True, with_phasor=True)
    got, track = HK.phase_vocoder_fused(torch.from_numpy(z), i0, i1, frac, with_phasor=True)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-5
    assert np.abs(track.real.numpy() - np.asarray(wpr)).max() < 1e-5
    assert np.abs(track.imag.numpy() - np.asarray(wpi)).max() < 1e-5


def test_phase_vocoder_checks_its_tables():
    z = torch.zeros(2, 9, 10, dtype=torch.complex64)
    i0, i1, frac = PS._pv_indices(10, 0.8)
    with pytest.raises(ValueError, match="lie in"):
        HK.phase_vocoder_fused(z, i0, i1 + 5, frac)
    shifted = i0.copy()
    shifted[0] = 1
    with pytest.raises(ValueError, match="frame 0"):
        HK.phase_vocoder_fused(z, shifted, i1, frac)
    with pytest.raises(TypeError, match="complex64"):
        HK.phase_vocoder_fused(z.to(torch.complex128), i0, i1, frac)
    # an unknown formulation raises, as in the JAX package
    with pytest.raises(ValueError, match="formulation must be"):
        PS.phase_vocoder(z, 0.8, 64, 256, formulation="phasor_fused_scan")


# -- dispatch: CPU -> plain version; any other device -> kernel or raise ----


def test_cpu_tensors_run_the_plain_versions_without_counting_launches():
    HK.reset_launch_counts()
    HK.fir_causal_batch(torch.zeros(2, 64), torch.zeros(2, 5))
    HK.phase_vocoder_fused(torch.zeros(1, 3, 8, dtype=torch.complex64), *PS._pv_indices(8, 1.1))
    HK.fir_causal(torch.zeros(2, 64), torch.zeros(5))
    HK.rotation_cumprod(torch.ones(2, 4), torch.zeros(2, 4), torch.ones(2), torch.zeros(2))
    env = torch.ones(64 + 16 * 2)
    w = HK.synthesis_weights(torch.zeros(33, 64), torch.zeros(33, 64), 16)
    HK.istft_synthesis_fused(torch.zeros(1, 3, 33, dtype=torch.complex64), w, 16, env)
    HK.iir_block_scan(torch.zeros(2, 5, 4), torch.zeros(4, 4))
    HK.snake(torch.zeros(2, 3, 7), torch.ones(1, 3, 1))
    HK.snake_backward(torch.zeros(2, 3, 7), torch.ones(1, 3, 1), torch.zeros(2, 3, 7))
    assert HK.LAUNCHES == dict.fromkeys(HK.LAUNCHES, 0)
    assert sorted(HK.LAUNCHES) == sorted(["fir_causal_batch", "phase_vocoder_fused", "fir_causal",
                                          "rotation_cumprod", "istft_synthesis_fused",
                                          "iir_block_scan", "snake", "snake_backward"])


def _no_plain(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")
    monkeypatch.setattr(HK, "fir_causal_batch_plain", boom)
    monkeypatch.setattr(HK, "phase_vocoder_fused_plain", boom)


def _call_both(device):
    with pytest.raises(RuntimeError) as a:
        HK.fir_causal_batch(torch.zeros(2, 64, device=device), torch.zeros(2, 5, device=device))
    with pytest.raises(RuntimeError) as b:
        HK.phase_vocoder_fused(torch.zeros(1, 3, 8, dtype=torch.complex64, device=device),
                               *PS._pv_indices(8, 1.1))
    return str(a.value), str(b.value)


def test_missing_kernel_library_raises_instead_of_falling_back(monkeypatch):
    """A tensor off the CPU ("meta" stands in for a CUDA tensor here) must
    reach the kernel: when its library cannot be loaded the call raises,
    and the plain version never runs."""
    _no_plain(monkeypatch)

    def missing(name):
        raise RuntimeError(f"cannot load the {name} kernel library")

    monkeypatch.setattr(_build, "library", missing)
    msgs = _call_both("meta")
    assert "fir_causal_batch kernel library" in msgs[0]
    assert "phase_vocoder kernel library" in msgs[1]


def test_kernel_path_requires_cuda_tensors(monkeypatch):
    _no_plain(monkeypatch)

    class _Lib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(_build, "library", lambda name: _Lib())
    for msg in _call_both("meta"):
        assert "expected CUDA tensors" in msg


def test_build_raises_with_nvcc_output(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")

    def failing_nvcc(cmd, **kw):
        assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
        return subprocess.CompletedProcess(cmd, 2, stdout="", stderr="error: bad token")

    monkeypatch.setattr(_build.subprocess, "run", failing_nvcc)
    with pytest.raises(RuntimeError, match="bad token"):
        _build.library("fir_causal_batch")
    assert list(tmp_path.iterdir()) == []  # no half-built library left behind


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "Path", lambda p: tmp_path / "no" / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("phase_vocoder")


def test_library_path_tracks_source_and_flags(monkeypatch):
    a = _build.library_path("phase_vocoder")
    assert a.parent == _build.BUILD_DIR and a.name.startswith("libphase_vocoder-")
    assert _build.library_path("fir_causal_batch") != a
    monkeypatch.setitem(_build.EXTRA_FLAGS, "phase_vocoder", [])
    assert _build.library_path("phase_vocoder") != a
