"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test needs a CUDA device and skips without one. This file imports no
JAX, so it also runs where JAX is not installed (``--noconftest`` skips the
suite's JAX setup and ``-o addopts=`` its coverage options):

    python -m pytest --noconftest -o addopts= -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from audiotools_tpu_torch.ops import filters as PFL
from audiotools_tpu_torch.ops import hopper_kernels as HK
from audiotools_tpu_torch.ops import stretch as PS

pytestmark = pytest.mark.cuda

# Kernel vs plain version, relative to the largest output magnitude. Both
# sum in fp32 (A: in another order; B: in the same order, no FMA
# contraction), so they agree far inside this.
KERNEL_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(got, want):
    got, want = got.cpu(), want.cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("rows,T,L", [(3, 1000, 1), (5, 777, 2048), (2, 5000, 231),
                                      (7, 1025, 1024), (64, 44100 + 640, 641)])
def test_fir_kernel_matches_plain(cuda, rows, T, L):
    rng = np.random.RandomState(rows * 7 + L)
    x = torch.from_numpy(rng.randn(rows, T).astype(np.float32)).to(cuda)
    h = torch.from_numpy((rng.randn(rows, L) * 0.05).astype(np.float32)).to(cuda)
    before = HK.LAUNCHES["fir_causal_batch"]
    got = HK.fir_causal_batch(x, h)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["fir_causal_batch"] == before + 1
    assert got.shape == x.shape
    assert _rel_err(got, HK.fir_causal_batch_plain(x, h)) < KERNEL_RTOL


def test_fir_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros(2, 4000, device=cuda)
    with pytest.raises(ValueError, match="taps"):
        HK.fir_causal_batch(x, torch.zeros(2, 2049, device=cuda))
    with pytest.raises(ValueError, match="batch"):
        HK.fir_causal_batch(x, torch.zeros(3, 9, device=cuda))
    with pytest.raises(RuntimeError, match="contiguous"):
        HK.fir_causal_batch(torch.zeros(4000, 2, device=cuda).T, torch.zeros(2, 9, device=cuda))


def _spectrum(rng, shape, zero_bins=True):
    z = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    if zero_bins:
        z[..., 3, :] = 0  # a silent bin: identity rotations throughout
        z[..., 5, 1::4] = 0  # transient zero frames
    return torch.from_numpy(z)


@pytest.mark.parametrize("with_phasor", [False, True])
@pytest.mark.parametrize("shape,rate", [((2, 3, 65, 37), 2 ** (-2 / 12)),
                                        ((1, 300, 19), 1.31), ((129, 50), 0.77)])
def test_pv_kernel_matches_plain(cuda, shape, rate, with_phasor):
    z = _spectrum(np.random.RandomState(len(shape)), shape).to(cuda)
    i0, i1, frac = PS._pv_indices(shape[-1], rate)
    got = HK.phase_vocoder_fused(z, i0, i1, frac, with_phasor=with_phasor)
    want = HK.phase_vocoder_fused_plain(z, i0, i1, frac, with_phasor=with_phasor)
    torch.cuda.synchronize()
    for g, w in zip(got, want) if with_phasor else [(got, want)]:
        assert g.shape == w.shape == shape[:-1] + (len(i0),)
        assert _rel_err(g, w) < KERNEL_RTOL


def test_pv_kernel_main_path_shape(cuda):
    """The pitch shift's +2 semitone vocoder: 64 x 1025 rows, 384 -> 432."""
    z = _spectrum(np.random.RandomState(0), (64, 1, 1025, 384), zero_bins=False).to(cuda)
    i0, i1, frac = PS._pv_indices(384, 2 ** (-2 / 12))
    assert len(i0) == 432
    got = HK.phase_vocoder_fused(z, i0, i1, frac)
    assert _rel_err(got, HK.phase_vocoder_fused_plain(z, i0, i1, frac)) < KERNEL_RTOL


def test_pv_kernel_reads_a_transposed_spectrum_in_place(cuda):
    """``ops.fft.stft`` returns a transposed view of a time-major tensor;
    the kernel must read it as is and agree with a contiguous copy."""
    z = _spectrum(np.random.RandomState(3), (2, 40, 65)).to(cuda).transpose(-1, -2)
    assert not z.is_contiguous()
    i0, i1, frac = PS._pv_indices(40, 0.9)
    got = HK.phase_vocoder_fused(z, i0, i1, frac)
    want = HK.phase_vocoder_fused(z.contiguous(), i0, i1, frac)
    assert torch.equal(got, want)


def test_equalizer_and_pitch_shift_on_card_match_cpu(cuda):
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(3, 1, 22050) * 0.1).astype(np.float32))
    db = torch.from_numpy((-rng.rand(3, 6)).astype(np.float32))
    eq_cpu = PFL.equalizer(x, db, 44100)
    eq_gpu = PFL.equalizer(x.to(cuda), db.to(cuda), 44100)
    assert (eq_gpu.cpu() - eq_cpu).abs().max() < 1e-5
    ps_cpu = PS.pitch_shift(x, 2.0, 44100)
    ps_gpu = PS.pitch_shift(x.to(cuda), 2.0, 44100)
    assert (ps_gpu.cpu() - ps_cpu).abs().max() < 1e-4
