"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test needs a CUDA device and skips without one. This file imports no
JAX, so it also runs where JAX is not installed (``--noconftest`` skips the
suite's JAX setup and ``-o addopts=`` its coverage options):

    python -m pytest --noconftest -o addopts= -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from audiotools_tpu_torch.ops import fft as PF
from audiotools_tpu_torch.ops import filters as PFL
from audiotools_tpu_torch.ops import hopper_kernels as HK
from audiotools_tpu_torch.ops import loudness as PL
from audiotools_tpu_torch.ops import ragged_shapes as RAGGED
from audiotools_tpu_torch.ops import stretch as PS

pytestmark = pytest.mark.cuda

# Kernel vs plain version, relative to the largest output magnitude. Both
# sum in fp32 (A, C, E: in another order, E on the same bf16-rounded
# operands; B, D: in the same order, no FMA contraction), so they agree far
# inside this.
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


@pytest.mark.parametrize("rows,T,L", RAGGED.FIR_BATCH)
def test_fir_kernel_ragged_tiles(cuda, rows, T, L):
    rng = np.random.RandomState(rows * 31 + T + L)
    x = torch.from_numpy(rng.randn(rows, T).astype(np.float32)).to(cuda)
    h = torch.from_numpy((rng.randn(rows, L) * 0.05).astype(np.float32)).to(cuda)
    got = HK.fir_causal_batch(x, h)
    assert _rel_err(got, HK.fir_causal_batch_plain(x, h)) < KERNEL_RTOL


@pytest.mark.parametrize("rows,T,L", RAGGED.FIR_SHARED)
def test_shared_fir_kernel_ragged_tiles(cuda, rows, T, L):
    rng = np.random.RandomState(rows * 37 + T + L)
    x = torch.from_numpy(rng.randn(rows, T).astype(np.float32)).to(cuda)
    h = torch.from_numpy((rng.randn(L) * 0.05).astype(np.float32)).to(cuda)
    assert _rel_err(HK.fir_causal(x, h), HK.fir_causal_plain(x, h)) < KERNEL_RTOL


def test_fir_kernels_equal_cudnn_at_the_main_path_shapes(cuda):
    """Each output sums its taps in the order cuDNN's conv1d does (TF32
    off), one fp32 FMA a tap: the equalizer's and the meter's calls agree
    bit for bit."""
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(64, 220500 + 640).astype(np.float32)).to(cuda)
    h = torch.from_numpy((rng.randn(64, 641) * 0.05).astype(np.float32)).to(cuda)
    assert torch.equal(HK.fir_causal_batch(x, h), HK.fir_causal_batch_plain(x, h))
    meter = torch.from_numpy(PL._composed_fir(44100, "K-weighting", 512)).to(cuda)
    x = x[:, :220500].contiguous()
    assert torch.equal(HK.fir_causal(x, meter), HK.fir_causal_plain(x, meter))


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


@pytest.mark.parametrize("with_phasor", [False, True])
@pytest.mark.parametrize("case", range(len(RAGGED.PV)))
def test_pv_kernel_ragged_shapes_bit_equal(cuda, case, with_phasor):
    """Bins, rows and steps that do not fill the block or the prefetch
    ring, rates below and above 1, silent bins and zero frames, and a step
    table that is not monotone: the same bits as the plain version."""
    shape, rate = RAGGED.PV[case]
    z, i0, i1, frac = RAGGED.pv_case(shape, rate, seed=case)
    z = torch.from_numpy(z).to(cuda)
    got = HK.phase_vocoder_fused(z, i0, i1, frac, with_phasor=with_phasor)
    want = HK.phase_vocoder_fused_plain(z, i0, i1, frac, with_phasor=with_phasor)
    for g, w in zip(got, want) if with_phasor else [(got, want)]:
        assert g.shape == w.shape == shape[:-1] + (len(i0),)
        assert torch.equal(g, w)


@pytest.mark.parametrize("with_phasor", [False, True])
def test_pv_kernel_main_path_shape_bit_equal(cuda, with_phasor):
    """The chains' launch (time-major spectrum, read in place) in both
    variants, at the pitch shift's shape: the same bits as the plain version."""
    rng = np.random.RandomState(1)
    z = torch.from_numpy((rng.randn(64, 1, 384, 1025) + 1j * rng.randn(64, 1, 384, 1025))
                         .astype(np.complex64)).to(cuda).transpose(-1, -2)
    i0, i1, frac = PS._pv_indices(384, 2 ** (-2 / 12))
    got = HK.phase_vocoder_fused(z, i0, i1, frac, with_phasor=with_phasor)
    want = HK.phase_vocoder_fused_plain(z, i0, i1, frac, with_phasor=with_phasor)
    for g, w in zip(got, want) if with_phasor else [(got, want)]:
        assert torch.equal(g, w)


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


# -- C: causal FIR with one shared kernel -----------------------------------


@pytest.mark.parametrize("shape,L", [((3, 1000), 1), ((2, 3, 5000), 1023), ((4, 777), 4095),
                                     ((2, 9000), 8192), ((130, 2048), 33)])
def test_shared_fir_kernel_matches_plain(cuda, shape, L):
    rng = np.random.RandomState(L + len(shape))
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
    h = torch.from_numpy((rng.randn(L) * 0.05).astype(np.float32)).to(cuda)
    before = HK.LAUNCHES["fir_causal"]
    got = HK.fir_causal(x, h)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["fir_causal"] == before + 1
    assert got.shape == x.shape
    assert _rel_err(got, HK.fir_causal_plain(x, h)) < KERNEL_RTOL


def test_shared_fir_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros(2, 4000, device=cuda)
    with pytest.raises(ValueError, match="taps"):
        HK.fir_causal(x, torch.zeros(HK.MAX_TAPS + 1, device=cuda))
    with pytest.raises(ValueError, match=r"\(L,\)"):
        HK.fir_causal(x, torch.zeros(2, 9, device=cuda))


def test_fir_meter_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(6)
    x = torch.from_numpy((rng.randn(3, 1, 44100) * 0.1).astype(np.float32))
    before = HK.LAUNCHES["fir_causal"]
    got = PL.loudness(x.to(cuda), 44100, use_fir=True, conv_method="pallas")
    assert HK.LAUNCHES["fir_causal"] == before + 1
    want = PL.loudness(x, 44100, use_fir=True, conv_method="pallas")
    assert (got.cpu() - want).abs().max() < 1e-3


# -- D: exclusive complex cumulative product --------------------------------


@pytest.mark.parametrize("shape", [(3, 5, 40), (200, 1), (1, 129, 33), (300, 432)])
def test_rotation_kernel_matches_plain(cuda, shape):
    rng = np.random.RandomState(len(shape) + shape[-1])
    ang = rng.uniform(-np.pi, np.pi, shape)
    seed = rng.uniform(-np.pi, np.pi, shape[:-1])
    ur, ui, cr, ci = (torch.from_numpy(a.astype(np.float32)).to(cuda)
                      for a in (np.cos(ang), np.sin(ang), np.cos(seed), np.sin(seed)))
    before = HK.LAUNCHES["rotation_cumprod"]
    got = HK.rotation_cumprod(ur, ui, cr, ci)
    want = HK.rotation_cumprod_plain(ur, ui, cr, ci)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["rotation_cumprod"] == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape == shape
        assert _rel_err(g, w) < KERNEL_RTOL


def _rotation_planes(rng, shape, cuda):
    ang = rng.uniform(-np.pi, np.pi, shape)
    seed = rng.uniform(-np.pi, np.pi, shape[:-1])
    return [torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
            for a in (np.cos(ang), np.sin(ang), np.cos(seed), np.sin(seed))]


@pytest.mark.parametrize("shape", RAGGED.ROTATION + [(64 * 1025, 432)])
def test_rotation_kernel_bit_equal(cuda, shape):
    """Rows not a multiple of the block, one row, one step, steps not a
    multiple of the tile, and the main path's 65,600 x 432: the same bits as
    the plain version."""
    planes = _rotation_planes(np.random.RandomState(shape[-1]), shape, cuda)
    for g, w in zip(HK.rotation_cumprod(*planes), HK.rotation_cumprod_plain(*planes)):
        assert g.shape == w.shape == shape
        assert torch.equal(g, w)


def test_rotation_kernel_misaligned_planes_take_the_4_byte_route(cuda):
    """Planes whose rows do not start on 16 bytes (a view 4 bytes into its
    buffer) with n % 4 == 0 go through the 4-byte copies: the same bits."""
    rng = np.random.RandomState(11)
    rows, n = 300, 432
    planes = _rotation_planes(rng, (rows, n), cuda)
    shifted = []
    for p in planes[:2]:
        buf = torch.empty(rows * n + 1, device=cuda)
        view = buf[1:].view(rows, n)
        view.copy_(p)
        shifted.append(view)
    assert shifted[0].data_ptr() % 16 != 0
    assert not HK.rotation_plan(rows, n, aligned=False).wide
    got = HK.rotation_cumprod(*shifted, *planes[2:])
    for g, w in zip(got, HK.rotation_cumprod_plain(*planes)):
        assert torch.equal(g, w)


# -- E: fused bf16 iSTFT synthesis ------------------------------------------


@pytest.mark.parametrize("B,nt,n_fft,hop", [(2, 37, 2048, 512), (3, 70, 512, 128),
                                            (1, 5, 256, 32), (2, 130, 64, 64)])
def test_synthesis_kernel_matches_plain(cuda, B, nt, n_fft, hop):
    rng = np.random.RandomState(nt)
    n_freq = n_fft // 2 + 1
    spec = torch.from_numpy(((rng.randn(B, nt, n_freq) + 1j * rng.randn(B, nt, n_freq)) * 0.1)
                            .astype(np.complex64)).to(cuda)
    (w,) = PF._on_device(PF._synthesis_design, ("hann", n_fft, hop), cuda)
    for edge in (0, 2):  # 2: match_stride's zero frames, read as zeros
        (env,) = PF._on_device(PF._inverse_envelope, ("hann", n_fft, hop, nt + 2 * edge), cuda)
        before = HK.LAUNCHES["istft_synthesis_fused"]
        got = HK.istft_synthesis_fused(spec, w, hop, env, edge)
        torch.cuda.synchronize()
        assert HK.LAUNCHES["istft_synthesis_fused"] == before + 1
        want = HK.istft_synthesis_fused_plain(spec, w, hop, env, edge)
        assert got.shape == want.shape == (B, n_fft + hop * (nt + 2 * edge - 1))
        assert _rel_err(got, want) < KERNEL_RTOL


@pytest.mark.parametrize("B,nt,n_fft,hop", RAGGED.SYNTHESIS)
def test_synthesis_kernel_ragged_tiles(cuda, B, nt, n_fft, hop):
    rng = np.random.RandomState(nt + n_fft)
    n_freq = n_fft // 2 + 1
    spec = torch.from_numpy(((rng.randn(B, nt, n_freq) + 1j * rng.randn(B, nt, n_freq)) * 0.1)
                            .astype(np.complex64)).to(cuda)
    (w,) = PF._on_device(PF._synthesis_design, ("hann", n_fft, hop), cuda)
    for edge in (0, 2):
        (env,) = PF._on_device(PF._inverse_envelope, ("hann", n_fft, hop, nt + 2 * edge), cuda)
        got = HK.istft_synthesis_fused(spec, w, hop, env, edge)
        want = HK.istft_synthesis_fused_plain(spec, w, hop, env, edge)
        assert got.shape == want.shape
        assert _rel_err(got, want) < KERNEL_RTOL


def test_fused_istft_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(8)
    x = torch.from_numpy((rng.randn(2, 1, 22050) * 0.3).astype(np.float32))
    spec = PF.stft(x, 2048, 512, match_stride=True)
    got = PF.istft(spec.to(cuda), 2048, 512, match_stride=True, original_length=22050,
                   method="matmul_bf16_fused")
    want = PF.istft(spec, 2048, 512, match_stride=True, original_length=22050,
                    method="matmul_bf16_fused")
    assert _rel_err(got, want) < KERNEL_RTOL


def test_salient_excerpt_returns_on_the_card(cuda, tmp_path):
    """Drawn and metered on the host, the excerpt goes to the card by
    default: the same offset and samples as with ``device="cpu"``."""
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch.io import write_wav

    path = tmp_path / "a.wav"
    write_wav(path, (np.random.RandomState(10).randn(1, 44100) * 0.1).astype(np.float32), 44100)
    for cutoff in (None, -70.0, 0.0):  # no meter, the first draw, every retry
        kw = dict(loudness_cutoff=cutoff, num_tries=4, state=3, duration=0.5)
        got = AudioSignal.salient_excerpt(path, **kw)
        want = AudioSignal.salient_excerpt(path, device="cpu", **kw)
        assert got.device.type == "cuda"
        assert got.metadata["offset"] == want.metadata["offset"]
        assert torch.equal(got.audio_data.cpu(), want.audio_data)


def test_parity_pitch_shift_on_card_matches_cpu(cuda):
    """The vocoder (B) writes the layout the synthesis (E) reads in place."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy((rng.randn(2, 1, 22050) * 0.1).astype(np.float32))
    kw = dict(synthesis_method="matmul_bf16_fused", pv_formulation="phasor_fused")
    before = dict(HK.LAUNCHES)
    got = PS.pitch_shift(x.to(cuda), 2.0, 44100, **kw)
    for name in ("phase_vocoder_fused", "istft_synthesis_fused"):
        assert HK.LAUNCHES[name] == before[name] + 1
    # bf16 rounding may fall on the other side on the two devices (one
    # bf16 ulp, 2**-8, of a value), as chip_smoke.py's CHAIN_TOL states
    assert (got.cpu() - PS.pitch_shift(x, 2.0, 44100, **kw)).abs().max() < 4e-3


# -- R4, R5: gradients ---------------------------------------------------------

# the fused vocoder's gradient against the phasor formulation's, relative to
# the largest gradient (the JAX package's pin, docs/perf.md)
PV_GRAD_RTOL = 4.4e-5


@pytest.mark.parametrize("case", [0, 3, 5, 8])
def test_fused_vocoder_gradient_matches_phasor_on_card(cuda, case):
    """R4: ``phase_vocoder(formulation="phasor_fused")`` on the card runs
    kernel B with its phasor track once under the forward, and its custom
    backward gives the autograd gradient of the ``phasor`` formulation, at
    ragged shapes with silent bins and transient zero frames."""
    shape, rate = RAGGED.PV[case]
    z, _, _, _ = RAGGED.pv_case(shape, rate, seed=case)
    grads = {}
    for formulation in ("phasor_fused", "phasor"):
        zt = torch.from_numpy(z).to(cuda).requires_grad_(True)
        before = HK.LAUNCHES["phase_vocoder_fused"]
        out = PS.phase_vocoder(zt, rate, 512, 2048, formulation=formulation)
        launched = HK.LAUNCHES["phase_vocoder_fused"] - before
        assert launched == (formulation == "phasor_fused")
        w = torch.from_numpy(np.random.RandomState(case).randn(*out.shape).astype(np.float32))
        ((out.abs() ** 2).sum() + (out.real * w.to(cuda)).sum()).backward()
        grads[formulation] = zt.grad.cpu()
    scale = float(grads["phasor"].abs().max())
    assert torch.isfinite(grads["phasor_fused"]).all()
    assert float((grads["phasor_fused"] - grads["phasor"]).abs().max()) / scale < PV_GRAD_RTOL


def _grad_inputs(cuda):
    """One call of each kernel wrapper without a backward (A, C, D, E) at a
    small shape, with the argument that requires grad made by ``g``."""
    from audiotools_tpu_torch.ops import fft as PF

    w = PF._on_device(PF._synthesis_design, ("hann", 64, 16), cuda)[0]
    env = PF._on_device(PF._inverse_envelope, ("hann", 64, 16, 3), cuda)[0]
    return {
        "fir_causal_batch": lambda g: HK.fir_causal_batch(
            torch.randn(2, 640, device=cuda, requires_grad=g), torch.randn(2, 5, device=cuda)),
        "fir_causal": lambda g: HK.fir_causal(
            torch.randn(2, 640, device=cuda), torch.randn(5, device=cuda, requires_grad=g)),
        "rotation_cumprod": lambda g: HK.rotation_cumprod(
            torch.ones(3, 8, device=cuda, requires_grad=g), torch.zeros(3, 8, device=cuda),
            torch.ones(3, device=cuda), torch.zeros(3, device=cuda)),
        "istft_synthesis_fused": lambda g: HK.istft_synthesis_fused(
            torch.randn(1, 3, 33, dtype=torch.complex64, device=cuda, requires_grad=g), w, 16,
            env),
    }


@pytest.mark.parametrize("name", ["fir_causal_batch", "fir_causal", "rotation_cumprod",
                                  "istft_synthesis_fused"])
def test_kernels_without_backward_raise_on_grad(cuda, name):
    """R5: kernels A, C, D and E have no backward. Given an input that
    requires grad while grad mode is on, the wrapper raises instead of
    returning a result cut from the graph, and launches nothing; under
    ``no_grad`` the same call launches."""
    call = _grad_inputs(cuda)[name]
    before = HK.LAUNCHES[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    assert HK.LAUNCHES[name] == before
    with torch.no_grad():
        out = call(True)
    torch.cuda.synchronize()
    assert HK.LAUNCHES[name] == before + 1
    assert all(not t.requires_grad for t in (out if isinstance(out, tuple) else (out,)))


# -- the augmentation zoo: each transform on the card against the CPU --------

ZOO_SOURCES = {"BackgroundNoise": "nz.csv", "CrossTalk": "spk.csv",
               "RoomImpulseResponse": "ir.csv"}
ZOO_LEAVES = ["BackgroundNoise", "ClippingDistortion", "CorruptPhase", "CrossTalk", "Equalizer",
              "FrequencyMask", "FrequencyNoise", "GlobalVolumeNorm", "HighPass", "InvertPhase",
              "LowPass", "MaskLowMagnitudes", "MuLawQuantization", "NoiseFloor", "Quantization",
              "RescaleAudio", "RoomImpulseResponse", "ShiftPhase", "Silence", "Smoothing",
              "SpectralDenoising", "TimeMask", "TimeNoise", "VolumeChange", "VolumeNorm"]
# chip_smoke.py's zoo bounds: max abs error on the audio, and for the
# quantizers the share of samples differing by more than it (a sample whose
# input lies within rounding of a level's edge moves by a whole level)
ZOO_ABS, ZOO_SHARE = 1e-4, 1e-3


@pytest.fixture(scope="module")
def zoo_sources(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import build_fixture_tree

    root = tmp_path_factory.mktemp("zoo")
    build_fixture_tree(root)
    return root


@pytest.mark.parametrize("name", ZOO_LEAVES)
def test_transform_on_card_matches_cpu(cuda, zoo_sources, name):
    """4 clips of 5 s, masks mixed by probability 0.5, the same drawn
    arguments staged to each device."""
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch.core import util
    from audiotools_tpu_torch.data import transforms as tfm
    from chip_smoke import speech_like

    kwargs = {"prob": 0.5}
    if name in ZOO_SOURCES:
        kwargs["sources"] = [str(zoo_sources / ZOO_SOURCES[name])]
    transform = getattr(tfm, name)(**kwargs)
    x = np.stack([speech_like(20 + i, 5.0)[None] for i in range(4)])
    item = AudioSignal(x[:1].copy(), 44100, device="cpu")
    item.metadata["loudness"] = -20.0
    drawn = transform.batch_instantiate([0, 1, 2, 3], item)
    before = HK.LAUNCHES["fir_causal_batch"]
    got = transform(AudioSignal(torch.from_numpy(x).to(cuda), 44100),
                    **util.prepare_batch(drawn, cuda))
    torch.cuda.synchronize()
    launched = HK.LAUNCHES["fir_causal_batch"] - before
    want = transform(AudioSignal(torch.from_numpy(x), 44100), **util.prepare_batch(drawn, "cpu"))
    assert got.device.type == "cuda" and got.audio_data.shape == want.audio_data.shape
    diff = (got.audio_data.cpu() - want.audio_data).abs()
    if name in ("Quantization", "MuLawQuantization"):
        assert float((diff > ZOO_ABS).float().mean()) <= ZOO_SHARE
    else:
        assert float(diff.max()) <= ZOO_ABS
    if name in ("BackgroundNoise", "Equalizer", "RoomImpulseResponse", "SpectralDenoising"):
        assert launched > 0  # their equalizers run through kernel A


@pytest.mark.parametrize("channels", [1, 2])
def test_clip_distortion_at_full_width_matches_cpu(cuda, channels):
    """64 x 220,500 samples (and 64 x 2 x 220,500, over torch.quantile's
    2**24-element limit) with one percentile per item: the sort-based
    quantiles give the CPU's result exactly."""
    from audiotools_tpu_torch import AudioSignal

    rng = np.random.RandomState(13)
    x = torch.from_numpy((rng.randn(64, channels, 220500) * 0.1).astype(np.float32))
    perc = rng.uniform(0.0, 0.1, 64).astype(np.float32)
    got = AudioSignal(x.to(cuda), 44100).clip_distortion(perc).audio_data
    want = AudioSignal(x.clone(), 44100).clip_distortion(perc).audio_data
    assert torch.equal(got.cpu(), want)
    assert float(got.abs().max()) < float(x.abs().max())


# -- the multitrack path's surface (time stretch, EQ routes, int16 wire) ------


@pytest.mark.parametrize("shape,rate", RAGGED.STRETCH)
def test_pv_kernel_at_the_stretch_shapes_bit_equal(cuda, shape, rate):
    """Kernel B at ``time_stretch``'s factors 1.25 and 0.8 on 64 clips of
    5 s, on a time-major spectrum read in place: the plain version's bits."""
    rng = np.random.RandomState(int(rate * 100))
    tm = shape[:-2] + shape[-1:] + shape[-2:-1]
    z = torch.from_numpy((rng.randn(*tm) + 1j * rng.randn(*tm)).astype(np.complex64)).to(
        cuda).transpose(-1, -2)
    i0, i1, frac = PS._pv_indices(shape[-1], rate)
    assert torch.equal(HK.phase_vocoder_fused(z, i0, i1, frac),
                       HK.phase_vocoder_fused_plain(z, i0, i1, frac))


@pytest.mark.parametrize("factor", [1.25, 0.8])
def test_time_stretch_fused_on_card_matches_cpu(cuda, factor):
    """``AudioSignal.time_stretch(pv_formulation="phasor_fused")`` on the
    card launches kernel B once; the vocoder on one spectrum gives the CPU's
    bits; and the stretch of noise (no bin at the rounding floor) is within
    the chain's 1e-4 of the CPU's."""
    from audiotools_tpu_torch import AudioSignal

    x = torch.from_numpy((np.random.RandomState(9).randn(2, 1, 44100) * 0.1).astype(np.float32))
    before = HK.LAUNCHES["phase_vocoder_fused"]
    got = AudioSignal(x.to(cuda), 44100).time_stretch(factor, pv_formulation="phasor_fused")
    torch.cuda.synchronize()
    assert HK.LAUNCHES["phase_vocoder_fused"] == before + 1
    spec = PF.stft(x, 2048, 512, "hann", method="matmul")
    on_card = PS.phase_vocoder(spec.to(cuda), factor, 512, 2048, "phasor_fused")
    assert torch.equal(on_card.cpu(), PS.phase_vocoder(spec, factor, 512, 2048, "phasor_fused"))
    cpu = AudioSignal(x, 44100).time_stretch(factor, pv_formulation="phasor_fused")
    assert float((got.audio_data.cpu() - cpu.audio_data).abs().max()) < 1e-4


def test_equalizer_pallas_on_card_matches_its_plain_version(cuda):
    rng = np.random.RandomState(10)
    x = torch.from_numpy((rng.randn(4, 2, 30000) * 0.1).astype(np.float32)).to(cuda)
    db = torch.from_numpy(-rng.rand(4, 6).astype(np.float32)).to(cuda)
    before = HK.LAUNCHES["fir_causal_batch"]
    got = PFL.equalizer(x, db, 44100, conv_method="pallas")
    torch.cuda.synchronize()
    assert HK.LAUNCHES["fir_causal_batch"] == before + 1
    want = PFL.equalizer(x, db, 44100, conv_method="pallas_interpret")
    assert HK.LAUNCHES["fir_causal_batch"] == before + 1
    assert _rel_err(got, want) < KERNEL_RTOL
    fft = PFL.equalizer(x, db, 44100, conv_method="fft")
    assert float((fft - want).abs().max()) < 1e-5


def test_loader_stages_an_int16_batch_on_the_card(cuda, tmp_path):
    """One aligned multitrack batch: every signal crosses as int16 and
    dequantizes on the card to the host's float batch within int16
    rounding."""
    from audiotools_tpu_torch.core import util
    from audiotools_tpu_torch.data import DataLoader
    from audiotools_tpu_torch.data.datasets import (AudioDataset, AudioLoader,
                                                    ResumableSequentialSampler)

    util.seed(1)
    root = util.generate_chord_dataset(max_voices=3, num_items=4, duration=0.5,
                                       output_dir=tmp_path / "chords")
    loaders = {v: AudioLoader(sources=[str(root / f"{v}.csv")]) for v in ("voice_0", "voice_1")}
    ds = AudioDataset(loaders, sample_rate=44100, n_examples=4, duration=0.5, aligned=True)
    kw = dict(batch_size=4, sampler=ResumableSequentialSampler(ds), drop_last=True, num_workers=2)
    batch = next(iter(DataLoader(ds, wire_dtype="int16", **kw)))
    host = next(iter(DataLoader(ds, device="cpu", **kw)))
    for voice in loaders:
        signal = batch[voice]["signal"]
        assert signal.audio_data.dtype == torch.int16 and signal.device.type == "cuda"
        back = signal.clone().dequantize_wire().audio_data
        assert back.device.type == "cuda"
        assert float((back.cpu() - host[voice]["signal"].audio_data).abs().max()) <= 2.0 ** -16


# -- the serving and evaluation path (no kernel of its own) --------------------

SERVING_TINY = dict(encoder_dim=8, encoder_rates=(2, 4, 4), latent_dim=16, decoder_dim=64,
                    n_codebooks=2, codebook_size=32, codebook_dim=4, sample_rate=16000)


@pytest.mark.parametrize("chunk", [4, 16])
def test_streamed_codec_equals_whole_pass_on_card(cuda, chunk):
    """On the card: streamed codes equal the whole pass's and the CPU's,
    streamed audio within 2e-6 of the whole decode and of the CPU's."""
    from audiotools_tpu_torch.models import DAC, compress, decompress

    cpu_model = DAC(**SERVING_TINY)
    card_model = DAC(**SERVING_TINY).to(cuda)
    audio = (np.random.RandomState(7).randn(2, 1, 3000) * 0.3).astype(np.float32)
    art = compress(card_model, audio)
    art_s = compress(card_model, audio, streaming=True, chunk_frames=chunk)
    assert np.array_equal(art["codes"], art_s["codes"])
    assert np.array_equal(art["codes"], compress(cpu_model, audio)["codes"])
    rec = decompress(card_model, art)
    rec_s = decompress(card_model, art, streaming=True, chunk_frames=chunk)
    assert rec.device.type == rec_s.device.type == "cuda"
    assert float((rec_s.audio_data - rec.audio_data).abs().max()) <= 2e-6
    assert float((rec.audio_data.cpu() - decompress(cpu_model, art).audio_data).abs().max()) <= 2e-6


def test_quality_metrics_on_card_match_cpu(cuda):
    """STOI (and its retained frames), PESQ (and its delays) and NSIM on the
    card against the same programs on the CPU, at the JAX package's pins."""
    from audiotools_tpu_torch.ops import nsim as PN
    from audiotools_tpu_torch.ops import pesq as PPQ
    from audiotools_tpu_torch.ops import stoi as PST

    # broadband speech-like test signals (a pure tone would leave most bands
    # at the FFTs' rounding floor, where STOI correlates rounding noise)
    rng = np.random.RandomState(3)
    t = np.arange(32000) / 16000
    phase = np.cumsum(2 * np.pi * (120 + 30 * np.sin(2 * np.pi * 0.4 * t)) / 16000)
    voiced = sum(np.sin(h * phase) / h for h in range(1, 6)) + 0.15 * rng.randn(32000)
    x = (0.15 * voiced * 0.5 * (1 + np.sin(2 * np.pi * 2.5 * t))).astype(np.float32)
    ref = np.stack([x, x, x])
    est = np.stack([x, x + 0.05 * rng.randn(32000), np.roll(x, 40)]).astype(np.float32)
    cpu = (torch.from_numpy(ref), torch.from_numpy(est))
    card = tuple(a.to(cuda) for a in cpu)
    for ext in (False, True):  # the 16 kHz signals scored as if at 10 kHz: any rate will do
        got, n_got = PST._stoi_parts(card[0], card[1], ext)
        want, n_want = PST._stoi_parts(cpu[0], cpu[1], ext)
        assert torch.equal(n_got.cpu(), n_want)
        assert float((got.cpu() - want).abs().max()) <= 5e-4
    got, d_got = PPQ._pesq_parts(*card, "wb")
    want, d_want = PPQ._pesq_parts(*cpu, "wb")
    assert torch.equal(d_got.cpu(), d_want)
    assert float((got.cpu() - want).abs().max()) <= 2e-3
    got = PN.nsim_batch(*card, mode="speech")
    assert float((got.cpu() - PN.nsim_batch(*cpu, mode="speech")).abs().max()) <= 1e-4


def test_accelerator_and_bf16_adversarial_step_on_card(cuda, tmp_path):
    """The Accelerator puts models and batches on the card by default; one
    adversarial step of the bf16 toy models there leaves fp32 parameters on
    the card and finite losses; the Checkpointer round-trips the card's
    modules and optimizers bit for bit, onto the card."""
    import copy

    from audiotools_tpu_torch import ml
    from audiotools_tpu_torch.examples.train_dac import TOY_DAC, TOY_DISC, adamw
    from audiotools_tpu_torch.models import DAC, Discriminator
    from audiotools_tpu_torch.models.adversarial import make_adversarial_train_step

    accel = ml.Accelerator(amp=True)
    assert accel.device.type == "cuda" and accel.num_processes == 1
    gen = accel.prepare_model(DAC(**TOY_DAC, sample_rate=16000, dtype=torch.bfloat16))
    disc = accel.prepare_model(Discriminator(**TOY_DISC, dtype=torch.bfloat16, seed=1))
    opts = {"g": adamw(gen, 1e-4), "d": adamw(disc, 1e-4)}
    audio = accel.prepare_batch({"x": np.random.RandomState(0).randn(2, 1, 3200)
                                 .astype(np.float32) * 0.1})["x"]
    assert audio.device.type == "cuda"
    metrics = make_adversarial_train_step(gen, disc, opts["g"], opts["d"], 16000)(audio)
    assert all(bool(torch.isfinite(v)) and v.device.type == "cuda" for v in metrics.values())
    params = [p for m in (gen, disc) for p in m.parameters()]
    assert all(p.device.type == "cuda" and p.dtype == torch.float32 for p in params)

    ckpt = ml.Checkpointer(tmp_path)
    ckpt.save(1, {"g": gen, "d": disc}, opts, data_idx=2)
    saved = copy.deepcopy({"g": gen.state_dict(), "d": disc.state_dict(),
                           "og": opts["g"].state_dict(), "od": opts["d"].state_dict()})
    gen2 = accel.prepare_model(DAC(**TOY_DAC, sample_rate=16000, dtype=torch.bfloat16, seed=5))
    disc2 = accel.prepare_model(Discriminator(**TOY_DISC, dtype=torch.bfloat16, seed=6))
    opts2 = {"g": adamw(gen2, 1e-4), "d": adamw(disc2, 1e-4)}
    make_adversarial_train_step(gen2, disc2, opts2["g"], opts2["d"], 16000)(audio)
    _, meta = ckpt.restore(template={"params": {"g": gen2, "d": disc2}, "opt_state": opts2})
    assert meta["data_idx"] == 2
    got = {"g": gen2.state_dict(), "d": disc2.state_dict(),
           "og": opts2["g"].state_dict(), "od": opts2["d"].state_dict()}
    for key in ("g", "d"):
        for name, tensor in saved[key].items():
            assert got[key][name].device.type == "cuda" and torch.equal(got[key][name], tensor)
    for key in ("og", "od"):
        for i, state in saved[key]["state"].items():
            for name, tensor in state.items():
                assert torch.equal(got[key]["state"][i][name].cpu(), tensor.cpu()), (key, i, name)


def test_bf16_gap_on_card_is_the_cpus(cuda):
    """The bf16 path the card runs (cuDNN's bf16 convolutions, bias and
    Snake in bf16) against the one the CPU runs (fp32 sums of bf16-rounded
    operands), on one state dict: for the DAC's audio and latents and the
    discriminators' feature and logit maps, the card's relative L2 distance
    between bf16 and fp32 is above 0 (the convolutions did run in bf16) and
    at most 1.5x the CPU's (which ``test_torch_amp`` holds to the JAX
    package's own gap)."""
    from audiotools_tpu_torch.models import DAC, Discriminator

    gen = dict(encoder_dim=8, encoder_rates=(2, 4, 4), latent_dim=16, decoder_dim=64,
               n_codebooks=2, codebook_size=32, codebook_dim=4, sample_rate=16000)
    disc = dict(periods=(2, 3), fft_sizes=(256, 128), mpd_channels=(4, 8), mrd_channels=4)
    gen_sd, disc_sd = DAC(**gen).state_dict(), Discriminator(**disc, seed=1).state_dict()
    x = torch.from_numpy((np.random.RandomState(4).randn(2, 1, 4096) * 0.1).astype(np.float32))

    def outputs(device, dtype):
        g, d = DAC(**gen, dtype=dtype), Discriminator(**disc, dtype=dtype)
        g.load_state_dict(gen_sd)
        d.load_state_dict(disc_sd)
        g, d, xd = g.to(device), d.to(device), x.to(device)
        with torch.no_grad():
            out = {"audio": g(xd)["audio"], "latents": g.encoder(xd),
                   "maps": torch.cat([f.flatten() for o in d(xd) for f in o])}
        assert all(v.dtype == torch.float32 and v.device.type == device.type
                   for v in out.values())
        return {k: v.double().cpu() for k, v in out.items()}

    def gaps(device):
        bf16, fp32 = outputs(device, torch.bfloat16), outputs(device, None)
        return {k: float((bf16[k] - fp32[k]).norm() / fp32[k].norm()) for k in fp32}

    card, cpu = gaps(cuda), gaps(torch.device("cpu"))
    for name in card:
        assert 0 < card[name] <= 1.5 * cpu[name], (name, card[name], cpu[name])


# -- host I/O and codecs: card signals through the host layers ---------------------


def _codec_input(seed=7, batch=2, seconds=0.5, sr=44100):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = np.stack([0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t) * (1 + 0.5 * np.sin(3 * t))
                  + 0.02 * rng.randn(t.size) for i in range(batch)])
    return x[:, None].astype(np.float32)


def _codec_present(preset):
    from audiotools_tpu_torch.io import codecs

    return {"MP3": codecs.mp3_available, "GSM-FR": codecs.gsm_available,
            "Amr-nb": lambda: True, "8-bit": lambda: True}.get(
        preset, lambda: codecs.vorbis_available() and codecs.vorbis_encode_available())()


@pytest.mark.parametrize("preset", ["MP3", "Vorbis", "Ogg"])
def test_file_codec_presets_on_card_equal_cpu(cuda, preset):
    """MP3 and Vorbis get the same bytes from a card signal as from a host
    one: the card's result is the CPU's, to the bit, and on the card."""
    from audiotools_tpu_torch import AudioSignal

    if not _codec_present(preset):
        pytest.skip(f"no system library for {preset}")
    x = _codec_input()
    card = AudioSignal(x, 44100, device=cuda).apply_codec(preset)
    cpu = AudioSignal(x, 44100, device="cpu").apply_codec(preset)
    assert card.device.type == "cuda" and card.signal_length == x.shape[-1]
    assert torch.equal(card.audio_data.cpu(), cpu.audio_data)


@pytest.mark.parametrize("preset", ["GSM-FR", "Amr-nb"])
def test_telephone_presets_on_card_match_cpu_stage_by_stage(cuda, preset):
    """The 8 kHz resample on the card within the resample's 1e-5 pin of the
    CPU's; the host codec, fed the card's 8 kHz audio, gives the card's
    preset its bits; the resample back within 1e-5; the whole preset on the
    card, with its length."""
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch.io import amrnb, codecs

    if not _codec_present(preset):
        pytest.skip(f"no system library for {preset}")
    x = _codec_input(8)
    card = AudioSignal(x, 44100, device=cuda)
    down = card.clone().resample(8000)
    assert float((down.audio_data.cpu() - AudioSignal(x, 44100, device="cpu").resample(8000)
                  .audio_data).abs().max()) < 1e-5
    host = down.audio_data.cpu().numpy()
    coded = (amrnb.amrnb_roundtrip_batch(host) if preset == "Amr-nb"
             else np.stack([codecs.gsm_roundtrip(item) for item in host])).astype(np.float32)
    up = AudioSignal(torch.from_numpy(coded).to(cuda), 8000).resample(44100)
    up.zero_pad(0, max(0, x.shape[-1] - up.signal_length)).truncate_samples(x.shape[-1])
    cpu_up = AudioSignal(coded, 8000, device="cpu").resample(44100)
    cpu_up.zero_pad(0, max(0, x.shape[-1] - cpu_up.signal_length)).truncate_samples(x.shape[-1])
    assert float((up.audio_data.cpu() - cpu_up.audio_data).abs().max()) < 1e-5
    out = card.clone().apply_codec(preset)
    assert out.device.type == "cuda" and out.signal_length == x.shape[-1]
    assert torch.equal(out.audio_data, up.audio_data)


@pytest.mark.parametrize("suffix", [".wav", ".flac", ".mp3", ".ogg", ".m4a"])
def test_every_format_loads_onto_the_card(cuda, tmp_path, suffix):
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch import io as pio
    from audiotools_tpu_torch import native

    if suffix in (".mp3", ".ogg") and not _codec_present({".mp3": "MP3", ".ogg": "Ogg"}[suffix]):
        pytest.skip(f"no system library for {suffix}")
    if suffix == ".m4a" and not native.av_available():
        pytest.skip("no libav")
    x = _codec_input(9, batch=1)
    AudioSignal(x, 44100, device=cuda).write(tmp_path / f"a{suffix}")
    sig = AudioSignal(tmp_path / f"a{suffix}")  # the card by default
    data, sr = pio.load_audio(tmp_path / f"a{suffix}")
    assert sig.device.type == "cuda" and sr == sig.sample_rate == 44100
    assert torch.equal(sig.audio_data[0].cpu(), torch.from_numpy(data))


def test_ffmpeg_mixin_meters_and_resamples_on_the_card(cuda, tmp_path):
    from audiotools_tpu_torch import AudioSignal

    x = _codec_input(10)
    sig = AudioSignal(x, 44100, device=cuda)
    lufs = sig.clone().ffmpeg_loudness()
    assert lufs.device.type == "cuda"
    for i in range(x.shape[0]):
        sig[i].write(tmp_path / f"{i}.wav")
        want = AudioSignal(tmp_path / f"{i}.wav").loudness()
        assert abs(float(lufs[i]) - float(want[0])) < 1e-4
    resampled = sig.clone().ffmpeg_resample(16000)
    assert resampled.device.type == "cuda"
    assert torch.equal(resampled.audio_data, sig.clone().resample(16000).audio_data)


# -- the long-signal path at world size 1 (nccl) ------------------------------


@pytest.fixture(scope="module")
def sp_mesh():
    """A one-rank nccl group and its ``{"sp": 1}`` mesh on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket

    import torch.distributed as dist

    from audiotools_tpu_torch.parallel import make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield make_mesh({"sp": 1})
    finally:
        dist.destroy_process_group()


def _sharded(x, mesh):
    from torch.distributed.tensor import DTensor, Shard

    return DTensor.from_local(x, mesh, [Shard(x.ndim - 1)])


def _long(seconds=10.0, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(1, 2, int(seconds * 44100)) * 0.1).astype(np.float32))


def test_sharded_fir_and_resample_on_card_equal_local(sp_mesh):
    """The JAX package's pins: FIR 1e-4, resample 1e-6."""
    from audiotools_tpu_torch.ops import resample as PRS
    from audiotools_tpu_torch.parallel import sharded_fir_conv, sharded_resample

    x = _long().cuda()
    h = torch.from_numpy(PL._exact_fir(44100, "K-weighting")).cuda()
    got = sharded_fir_conv(_sharded(x, sp_mesh), h, sp_mesh).to_local()
    assert float((got - PFL.causal_fft_conv1d(x, h)).abs().max()) < 1e-4
    got = sharded_resample(_sharded(x, sp_mesh), 44100, 16000, sp_mesh).to_local()
    want = PRS.resample(x, 44100, 16000)
    assert got.shape == want.shape and float((got - want).abs().max()) < 1e-6


def test_sharded_stft_round_trip_on_card_equals_local(sp_mesh):
    """STFT 1e-5 of its scale, iSTFT 1e-5, round trip 1e-4 (hop = window / 2:
    one shard refuses a smaller hop, as the JAX package's geometry does)."""
    from audiotools_tpu_torch.parallel import sharded_istft, sharded_stft

    x = _long()[:, 0, :440320].cuda().contiguous()  # 215 hops of 2048
    spec, n_valid = sharded_stft(_sharded(x, sp_mesh), 2048, 1024, sp_mesh)
    want = PF.stft(x, 2048, 1024)
    got = spec.to_local()[..., :n_valid]
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    y = sharded_istft(spec, 2048, 1024, sp_mesh, n_valid=n_valid).to_local()
    assert float((y - PF.istft(want, 2048, 1024, length=x.shape[-1])).abs().max()) < 1e-5
    assert float((y - x).abs().max()) < 1e-4
    with pytest.raises(ValueError, match="narrow"):
        sharded_stft(_sharded(x, sp_mesh), 2048, 512, sp_mesh)


def test_sharded_loudness_and_signal_mesh_methods_on_card(sp_mesh):
    """The sharded meter equals the exact single-device meter (1e-5 LU) and
    the signal's ``mesh=`` methods equal their single-device ones (the JAX
    package's signal-API pins, 1e-3 LU and 1e-4)."""
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch.parallel import shard_signal, sharded_loudness

    x = _long(seed=1).cuda()
    x[..., 100000:200000] *= 1e-3
    got = sharded_loudness(_sharded(x, sp_mesh), 44100, sp_mesh).to_local()
    assert float((got - PL.loudness(x, 44100, use_fir=False)).abs().max()) < 1e-5
    sig = shard_signal(AudioSignal(x.clone(), 44100), sp_mesh)
    ref = AudioSignal(x.clone(), 44100)
    assert float((sig.loudness(mesh=sp_mesh).to_local() - ref.loudness()).abs().max()) < 1e-3
    sig.resample(22050, mesh=sp_mesh)
    ref.resample(22050)
    assert float((sig.audio_data.to_local() - ref.audio_data).abs().max()) < 1e-4


def test_codec_example_runs_on_card(cuda, tmp_path):
    from audiotools_tpu_torch.examples import codec
    from audiotools_tpu_torch.io import read_wav, write_wav

    write_wav(tmp_path / "in.wav", _long(seconds=1.0)[0, :1].numpy(), 44100)
    art = codec.main(["compress", str(tmp_path / "in.wav"), str(tmp_path / "c.npz"), "--toy"])
    recon = codec.main(["decompress", str(tmp_path / "c.npz"), str(tmp_path / "out.wav"), "--toy"])
    assert recon.device.type == "cuda" and art["codes"].shape[:2] == (1, 4)
    assert read_wav(tmp_path / "out.wav")[0].shape == (1, 44100)


GLOO_WORKER = r"""
import datetime, json, sys
import torch
import torch.distributed as dist
from audiotools_tpu_torch.parallel.timeshard import ppermute

rank, address, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(0)
x = torch.ones(1024, device="cuda")
dist.init_process_group("gloo", init_method=address, rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=30))
# everything before the exchange has worked: what fails from here is the transport
json.dump({"started": True}, open(out, "w"))
try:
    ppermute(x, dist.group.WORLD, 1)
    err = None
except Exception as e:  # reported to the test, which expects gloo's transport error
    err = f"{type(e).__name__}: {e}"
json.dump({"started": True, "error": err}, open(out, "w"))
"""

# gloo's TCP transport on a card pointer ("writev ...: Bad address", raised
# from its pair.cc), as an exception or in the dying process's stderr
GLOO_TRANSPORT_ERRORS = ("Bad address", "pair.cc")


def test_the_halo_transport_fails_where_gloo_cannot_carry_card_tensors(cuda, tmp_path):
    """Two gloo ranks on the card: gloo's point-to-point TCP transport reads
    a card tensor as host memory and fails ("Bad address"), and the halo
    exchange fails with it on the sending rank, by an exception or by the
    process's end, instead of staging through the host (so the multi-rank
    halo logic runs in the CPU tests). The sending rank must have reached
    the exchange, and the failure must be gloo's transport error."""
    import json
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_WORKER, str(r), address,
                               str(tmp_path / f"{r}.json")], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    stderr = logs[0][1][-4000:]
    report = tmp_path / "0.json"
    assert report.exists(), f"rank 0 did not reach the exchange:\n{stderr}"
    record = json.loads(report.read_text())
    assert record.get("error", "") is not None, "gloo carried a card tensor"
    said = (record.get("error") or "") + stderr
    assert any(e in said for e in GLOO_TRANSPORT_ERRORS), said


NCCL_WORKER = r"""
import datetime, json, sys, time
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

rank, world, address, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dev = torch.device("cuda", rank)
torch.cuda.set_device(dev)
dist.init_process_group("nccl", init_method=address, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120), device_id=dev)
from audiotools_tpu_torch.ops import fft as PF
from audiotools_tpu_torch.ops import loudness as PL
from audiotools_tpu_torch.ops import resample as PRS
from audiotools_tpu_torch.ops.filters import causal_fft_conv1d
from audiotools_tpu_torch.parallel import (make_mesh, sharded_fir_conv, sharded_istft,
                                           sharded_loudness, sharded_resample, sharded_stft)

mesh = make_mesh({"sp": world})
g = torch.Generator(device=dev).manual_seed(3)  # the same signal on every card
T = 60 * 44100  # whole polyphase periods and gating strides on 2, 4 or 8 shards
full = torch.randn(1, 2, T, generator=g, device=dev) * 0.1
full[..., T // 3: T // 2] *= 1e-3
k = T // world
x = DTensor.from_local(full[..., rank * k:(rank + 1) * k].contiguous(), mesh, [Shard(2)])
T1 = T // (world * 2048) * (world * 2048)  # one channel, whole hops on every shard
mono = full[:, 0, :T1].contiguous()
k1 = T1 // world
m = DTensor.from_local(mono[:, rank * k1:(rank + 1) * k1].contiguous(), mesh, [Shard(1)])
h = torch.from_numpy(PL._exact_fir(44100, "K-weighting")).to(dev)


def mine(want):
    n = want.shape[-1] // world
    return want[..., rank * n:(rank + 1) * n]


res = {}
t0 = time.perf_counter()
got = sharded_fir_conv(x, h, mesh).to_local()
res["fir"] = float((got - mine(causal_fft_conv1d(full, h))).abs().max())
got = sharded_resample(x, 44100, 16000, mesh).to_local()
res["resample"] = float((got - mine(PRS.resample(full, 44100, 16000))).abs().max())
spec, n_valid = sharded_stft(m, 2048, 512, mesh)
want = PF.stft(mono, 2048, 512)
nf = spec.to_local().shape[-1]
valid = max(0, min(nf, n_valid - rank * nf))
res["stft"] = float((spec.to_local()[..., :valid] - want[..., rank * nf: rank * nf + valid])
                    .abs().max() / want.abs().max()) if valid else 0.0
got = sharded_istft(spec, 2048, 512, mesh, n_valid=n_valid).to_local()
res["istft"] = float((got - mine(PF.istft(want, 2048, 512, length=T1))).abs().max())
got = sharded_loudness(x, 44100, mesh).to_local()
res["loudness"] = float((got - PL.loudness(full, 44100, use_fir=False)).abs().max())
torch.cuda.synchronize()
res["seconds"] = time.perf_counter() - t0
json.dump(res, open(out, "w"))
dist.destroy_process_group()
"""


def test_sharded_ops_over_every_card_equal_local(cuda, tmp_path):
    """One nccl rank a card, the halos over NVLink: each rank's shard of
    every sharded op (the STFT at 2048/512) against the same slice of the
    single-device op, at the JAX package's pins (FIR 1e-4, resample 1e-6,
    STFT 1e-5 of its scale, iSTFT 1e-5, loudness 1e-5 LU). Needs two cards
    or more, and skips on one."""
    import json
    import socket
    import subprocess
    import sys
    from pathlib import Path

    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two CUDA devices or more")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_WORKER, str(r), str(world), address,
                               str(tmp_path / f"{r}.json")], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    tol = {"fir": 1e-4, "resample": 1e-6, "stft": 1e-5, "istft": 1e-5, "loudness": 1e-5}
    for r in range(world):
        got = json.loads((tmp_path / f"{r}.json").read_text())
        print(f"rank {r} of {world}: {got}")
        for name, bound in tol.items():
            assert got[name] <= bound, (r, name, got[name])
