"""The port on the card: its CUDA kernels against their plain PyTorch
versions, and its paths (the augmentation chains, the zoo, the multitrack
stages, the gradients, training, serving and quality metrics, host I/O, the
long signal and model parallelism) against the CPU, with the kernels each
launches.

Every test needs a CUDA device and skips without one. This file imports no
JAX, so it also runs where JAX is not installed (``--noconftest`` skips the
suite's JAX setup and ``-o addopts=`` its coverage options):

    python -m pytest --noconftest -o addopts= -p no:cacheprovider tests/test_torch_cuda.py
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu_torch.ops import fft as PF
from audiotools_tpu_torch.ops import filters as PFL
from audiotools_tpu_torch.ops import hopper_kernels as HK
from audiotools_tpu_torch.ops import loudness as PL
from audiotools_tpu_torch.ops import ragged_shapes as RAGGED
from audiotools_tpu_torch.ops import stretch as PS
from audiotools_tpu_torch.ops._fp32 import strict_fp32

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


# -- the fixtures: seeded clips, the augmentation chains, the training steps --

SR = 44100


def _fixture_clips(root, n, samples, n_examples=None):
    """The first ``n`` excerpts of ``samples`` that ``AudioDataset`` draws
    from the speech fixtures of ``build_fixture_tree``, ``(n, 1, samples)``
    on the host."""
    from audiotools_tpu_torch.core import util
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader

    ds = AudioDataset(AudioLoader(sources=[str(root / "spk.csv")]), sample_rate=SR,
                      n_examples=n_examples or n, duration=samples / SR)
    return util.collate([ds[i] for i in range(n)])["signal"].audio_data


def noise_like(seed, duration=12.0):
    rng = np.random.RandomState(seed)
    b = np.exp(-np.arange(64) / 16.0)
    return (np.convolve(rng.randn(int(duration * SR)), b / b.sum(), mode="same") * 0.2).astype(
        np.float32)


def ir_like(seed, duration=1.0):
    rng = np.random.RandomState(seed)
    n = int(duration * SR)
    out = np.zeros(n, dtype=np.float32)
    out[64] = 1.0
    out[65:] = 0.25 * rng.randn(n - 65) * np.exp(-np.linspace(0, 9, n - 65))
    return out


def build_fixture_tree(root):
    """Seeded speech-like, noise and impulse-response WAVs at 44.1 kHz under
    ``root/{spk,nz,ir}/``, each group listed in ``root/<group>.csv``."""
    import csv

    from audiotools_tpu_torch.examples.train_dac import speech_like
    from audiotools_tpu_torch.io import write_wav

    groups = {
        "spk": [speech_like(i) for i in range(3)],
        "nz": [noise_like(100 + i) for i in range(2)],
        "ir": [ir_like(200 + i) for i in range(2)],
    }
    for name, sigs in groups.items():
        (root / name).mkdir()
        with open(root / f"{name}.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["path"])
            writer.writeheader()
            for i, s in enumerate(sigs):
                path = root / name / f"{name}_{i}.wav"
                write_wav(path, s[None, :], SR)
                writer.writerow({"path": str(path)})


def make_dataset(root, n_examples, use_original_phase=False):
    """The benchmark chain's AudioDataset of 5 s excerpts;
    ``use_original_phase``: the reverb keeps the dry signal's STFT phase."""
    from audiotools_tpu_torch.data import transforms as tfm
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader

    transform = tfm.Compose(
        tfm.RoomImpulseResponse(sources=[str(root / "ir.csv")],
                                use_original_phase=use_original_phase),
        tfm.BackgroundNoise(sources=[str(root / "nz.csv")]),
        tfm.Equalizer(),
        tfm.VolumeNorm(),
    )
    return AudioDataset(AudioLoader(sources=[str(root / "spk.csv")]), sample_rate=SR,
                        n_examples=n_examples, duration=5.0, transform=transform)


def run_chain(ds, batch, synthesis_method="matmul_bf16"):
    """The chain on a staged batch: the dataset's transforms,
    ``pitch_shift(+2 st, "phasor_fused")``, mel-80 and loudness with the
    process-wide meter (``loudness.set_fast_meter``)."""
    out = ds.transform(batch["signal"].clone(), **batch["transform_args"])
    audio = PS.pitch_shift(out.audio_data, 2.0, SR, synthesis_method=synthesis_method,
                           pv_formulation="phasor_fused")
    return audio, PF.mel_spectrogram(audio, SR, 80, method="matmul"), PL.loudness(audio, SR)


@contextlib.contextmanager
def meter(fast):
    """The process-wide meter for one chain; the exact meter is restored on
    the way out, whatever happens inside."""
    PL.set_fast_meter(fast)
    try:
        yield
    finally:
        PL.set_fast_meter(False)


# one AdamW step of the training steps (train_dac's optimizer: optax.adamw's
# defaults)
LR = 1e-4


def _training_step(label, dev, stft_method="matmul"):
    """Fresh seeded ``DAC()`` (and ``Discriminator()``, its MRD's analysis
    ``stft_method``) at their defaults on ``dev``, and the step of ``label``
    ("reconstruction" or "adversarial")."""
    from audiotools_tpu_torch.examples.train_dac import adamw
    from audiotools_tpu_torch.models import DAC, Discriminator
    from audiotools_tpu_torch.models.adversarial import make_adversarial_train_step
    from audiotools_tpu_torch.models.train import make_train_step

    gen = DAC(seed=0).to(dev)
    if label == "reconstruction":
        return (gen,), make_train_step(gen, adamw(gen, LR), SR)
    disc = Discriminator(seed=1, stft_method=stft_method).to(dev)
    return (gen, disc), make_adversarial_train_step(gen, disc, adamw(gen, LR), adamw(disc, LR), SR)


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


def _accounting_case(name, cuda):
    """A wrapper and its card arguments, by launch-counter name, at a shape
    where the kernel takes 0.1-0.6 ms on the card: several times its
    wrapper's host time (up to ~50 us), so that both of the test's timers
    read the device and not the host's enqueue rate."""
    rng = np.random.RandomState(13)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(cuda)

    if name == "fir_causal_batch":
        return HK.fir_causal_batch, (randn(64, 44100 + 640), randn(64, 641, scale=0.05))
    if name == "phase_vocoder_fused":
        z = _spectrum(rng, (64, 1, 1025, 384), zero_bins=False).to(cuda)
        return HK.phase_vocoder_fused, (z, *PS._pv_indices(384, 2 ** (-2 / 12)))
    if name == "fir_causal":
        return HK.fir_causal, (randn(64, 44100, scale=0.1), torch.from_numpy(
            PL._composed_fir(44100, "K-weighting", 512)).to(cuda))
    if name == "rotation_cumprod":
        return HK.rotation_cumprod, tuple(_rotation_planes(rng, (64 * 1025, 432), cuda))
    if name == "istft_synthesis_fused":
        spec = torch.from_numpy(((rng.randn(16, 432, 1025) + 1j * rng.randn(16, 432, 1025))
                                 * 0.05).astype(np.complex64)).to(cuda)
        (w,) = PF._on_device(PF._synthesis_design, ("hann", 2048, 512), cuda)
        (env,) = PF._on_device(PF._inverse_envelope, ("hann", 2048, 512, 432), cuda)
        return HK.istft_synthesis_fused, (spec, w, 512, env)
    if name == "iir_block_scan":
        # 60 s a row (5,168 blocks of 512): F's chain of dependent steps takes
        # ~12x the 431 blocks of the meter's 5 s, where F (19 us) is shorter
        # than its wrapper's host time
        _, a_l_t = _meter_scan_inputs(1, torch.float32, cuda)
        gen = torch.Generator(device=cuda).manual_seed(13)
        return HK.iir_block_scan, (torch.randn(128, 5168, 4, device=cuda, generator=gen) * 0.1,
                                   a_l_t)
    x, alpha, g = _snake_case(cuda, "codec")
    return (HK.snake, (x, alpha)) if name == "snake" else (HK.snake_backward, (x, alpha, g))


@pytest.mark.parametrize("name", list(HK.LAUNCHES))
def test_fir_kernel_device_time_and_counted_work(cuda, name):
    """For each kernel: ``ops.benchmark.device_time`` (CUDA events, N and 2N
    calls) is positive and within 2x of the mean of n calls after a warm
    one, and ``device_time_stats``'s fastest repeat positive;
    ``ops.perf.xla_cost`` of the wrapper on the card launches the kernel
    once and counts its registered work, as on the CPU."""
    from audiotools_tpu_torch.ops import benchmark as BM
    from audiotools_tpu_torch.ops import perf as PP

    wrapper, args = _accounting_case(name, cuda)

    def call(a):
        return wrapper(*a)

    call(args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        call(args)
    end.record()
    end.synchronize()
    time_s = start.elapsed_time(end) / 50 / 1e3
    seconds = BM.device_time(call, args, iters=50)
    assert seconds > 1e-9
    assert time_s / 2 <= seconds <= 2 * time_s
    assert BM.device_time_stats(call, args, iters=10, repeats=3)["min"] > 1e-9
    before = HK.LAUNCHES[name]
    cost = PP.xla_cost(wrapper, *args)
    torch.cuda.synchronize()
    assert HK.LAUNCHES[name] == before + 1
    on_cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    assert cost == wrapper.work(*args) == PP.xla_cost(wrapper, *on_cpu)


@pytest.mark.parametrize("label", ["reconstruction", "adversarial"])
def test_counted_work_of_a_training_step_on_card(cuda, zoo_sources, label):
    """``DAC()`` and ``Discriminator()`` at their defaults, one step of 2 x
    16,896 samples on the card: its counted FLOPs (``xla_cost``, kernel G's
    registered work for the Snakes) between the analytic core and 3x it
    (tests/test_torch_perf.py's band: the count adds the losses' matmul
    STFTs and the MRD's matmul DFT); ``summarize`` of the step timed by
    ``device_time_queued`` has the JAX package's keys."""
    from audiotools_tpu_torch.ops import benchmark as BM
    from audiotools_tpu_torch.ops import perf as PP

    _, step = _training_step(label, cuda)
    audio = _fixture_clips(zoo_sources, 2, 16_896).to(cuda)
    step(audio)  # cuDNN's algorithm search
    analytic = (PP.dac_train_step_flops if label == "reconstruction"
                else PP.adversarial_train_step_flops)(2, 16_896)
    cost = PP.xla_cost(step, audio)
    assert analytic <= cost["flops"] <= 3.0 * analytic
    seconds = BM.device_time_queued(step, audio, iters=2, sync=lambda out: out["loss"])
    assert set(PP.summarize(label, seconds, analytic, cost)) == {"mfu", "mfu_xla", "hbm_frac"}


def test_stage_roofline_on_card(cuda, zoo_sources):
    """A ``stage_roofline`` row of the chain's pitch shift on 8 clips of 5 s
    on the card (its keys, positive device time and bytes), and the stage's
    ``summarize`` from ``device_time`` and ``xla_cost`` with ``hbm_frac``."""
    from audiotools_tpu_torch.ops import benchmark as BM
    from audiotools_tpu_torch.ops import perf as PP

    audio = _fixture_clips(zoo_sources, 8, 220_500).to(cuda)

    def shift(a):
        return PS.pitch_shift(a, 2.0, 44100, synthesis_method="matmul_bf16",
                              pv_formulation="phasor_fused")

    row = PP.stage_roofline("pitch_shift", shift, audio, iters=3)
    assert set(row) == {"stage", "ms", "gbytes", "hbm_frac", "gflops", "mfu_xla"}
    assert row["ms"] > 0 and row["gbytes"] > 0
    summary = PP.summarize("pitch_shift", BM.device_time(shift, audio, iters=3),
                           cost=PP.xla_cost(shift, audio))
    assert "hbm_frac" in summary


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


# -- F: the blocked IIR's block-state recurrence ----------------------------


def _meter_scan_inputs(rows, dtype, device):
    """The K-weighting cascade's u and (A^L)^T at 44.1 kHz for ``rows``
    rows of 5 s (431 blocks of 512, 4 states), from seeded noise."""
    stages = [(b, a, g) for (b, a), g in PL.design_filters(44100)]
    key = tuple((tuple(map(float, b)), tuple(map(float, a)), float(g)) for b, a, g in stages)
    _, _, psi_x_t, a_l_t = PFL._iir_operators_on(key, 512, device, dtype)
    x = torch.from_numpy(np.random.RandomState(rows).randn(rows, 220500) * 0.1).to(device, dtype)
    xb = torch.nn.functional.pad(x, (0, -220500 % 512)).reshape(rows, -1, 512)
    with strict_fp32():
        return xb @ psi_x_t, a_l_t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows", [64, 128])
def test_block_scan_kernel_matches_plain_at_the_meter_shapes(cuda, rows, dtype):
    """F against its plain version (fp64) or, in fp32, against the float64
    recurrence within ``SCAN_VS_PLAIN_ERROR`` times the plain version's
    error (``ops/ragged_shapes.py`` says why)."""
    u, a_l_t = _meter_scan_inputs(rows, dtype, cuda)
    assert u.shape == (rows, 431, 4)
    before = HK.LAUNCHES["iir_block_scan"]
    got = HK.iir_block_scan(u, a_l_t)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["iir_block_scan"] == before + 1
    assert got.shape == u.shape and got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))
    plain = HK.iir_block_scan_plain(u, a_l_t)
    if dtype == torch.float64:
        assert _rel_err(got, plain) < RAGGED.SCAN_RTOL[dtype]
        return
    ref = HK.iir_block_scan_plain(u.cpu().double(), a_l_t.cpu().double())
    assert _rel_err(got.double(), ref) <= RAGGED.SCAN_VS_PLAIN_ERROR * _rel_err(plain.double(), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,n_blk,ns", RAGGED.IIR_SCAN)
def test_block_scan_kernel_ragged_shapes(cuda, rows, n_blk, ns, dtype):
    rng = np.random.RandomState(rows * 31 + n_blk * 7 + ns)
    q, _ = np.linalg.qr(rng.randn(ns, ns))
    a_l_t = torch.from_numpy(q * 0.9).to(cuda, dtype)  # a contracting transition
    u = torch.from_numpy(rng.randn(rows, n_blk, ns)).to(cuda, dtype)
    got = HK.iir_block_scan(u, a_l_t)
    want = HK.iir_block_scan_plain(u, a_l_t)
    if n_blk == 1:
        assert torch.equal(got, torch.zeros_like(got))
    else:
        assert _rel_err(got, want) < RAGGED.SCAN_RTOL[dtype]
    # a contiguous input off a 16-byte boundary is copied, not refused
    shifted = torch.cat([torch.zeros(1, dtype=dtype, device=cuda), u.flatten()])[1:]
    assert torch.equal(HK.iir_block_scan(shifted.view(u.shape), a_l_t), got)


def test_block_scan_kernel_rejects_what_it_cannot_take(cuda):
    with pytest.raises(ValueError, match="at most 16 states"):
        HK.iir_block_scan(torch.zeros(2, 5, 17, device=cuda), torch.zeros(17, 17, device=cuda))
    with pytest.raises(TypeError, match="float32 or float64"):
        HK.iir_block_scan(torch.zeros(2, 5, 4, device=cuda),
                          torch.zeros(4, 4, dtype=torch.float64, device=cuda))
    with pytest.raises(RuntimeError, match="contiguous"):
        HK.iir_block_scan(torch.zeros(5, 2, 4, device=cuda).transpose(0, 1),
                          torch.zeros(4, 4, device=cuda))


def test_exact_meter_on_card_matches_the_float64_lfilter_meter(cuda):
    """The exact meter through kernel F against scipy's float64 ``lfilter``
    cascade: the weighted audio within the blocked cascade's pin (1e-4,
    test_torch_ops.py), the LUFS within the benchmark's ``lufs_db`` limit
    (5e-4 LU, PERF.md); one launch of F a meter call."""
    from scipy.signal import lfilter

    rng = np.random.RandomState(21)
    x = rng.randn(64, 1, 220500) * 0.05
    x *= np.repeat(rng.rand(64, 1, 51) > 0.4, 4410, axis=-1)[..., :220500]  # both gates act
    x = x.astype(np.float32)
    ref = x.astype(np.float64)
    for (b, a), g in PL.design_filters(44100):
        ref = g * lfilter(b, a, ref, axis=-1)
    before = HK.LAUNCHES["iir_block_scan"]
    weighted = PL.apply_k_weighting(torch.from_numpy(x).to(cuda), 44100)
    lufs = PL.loudness(torch.from_numpy(x).to(cuda), 44100, use_fir=False)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["iir_block_scan"] == before + 2
    assert np.abs(weighted.cpu().numpy() - ref).max() < 1e-4
    assert np.abs(lufs.cpu().numpy() - PL.host_loudness(x, 44100)).max() < 5e-4


# the benchmark's chains: (the reverb's use_original_phase, the FIR meter,
# the synthesis method)
CHAINS = {"main": (False, False, "matmul_bf16"), "parity": (False, True, "matmul_bf16_fused"),
          "original_phase": (True, False, "matmul_bf16")}
# a batch of each launches A for the reverb's, the noise's and Equalizer's
# EQs and B for the vocoder; it meters three times (the mix's stacked signal
# and noise, VolumeNorm, the features' loudness), each through F with the
# exact meter or through C with the FIR meter; the pitch shift's synthesis
# is E (fused) or the bf16 tensor-core product (the reverb's own iSTFT of
# the original-phase chain is the fp32 "fft" one)
CHAIN_LAUNCHES = {
    "main": {"fir_causal_batch": 3, "phase_vocoder_fused": 1, "iir_block_scan": 3,
             "bf16_synthesis_gemm": 1},
    "parity": {"fir_causal_batch": 3, "phase_vocoder_fused": 1, "fir_causal": 3,
               "istft_synthesis_fused": 1},
    "original_phase": {"fir_causal_batch": 3, "phase_vocoder_fused": 1, "iir_block_scan": 3,
                       "bf16_synthesis_gemm": 1},
}


def _launches():
    """The kernels' launch counts and the bf16 synthesis's tensor-core
    products (``fft.BF16_SYNTHESIS_GEMMS``), by name."""
    return {**HK.LAUNCHES, "bf16_synthesis_gemm": PF.BF16_SYNTHESIS_GEMMS}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_chain_batch_launches_the_block_scan_once_a_meter_call(cuda, zoo_sources, chain):
    """One batch of 8 clips of 5 s of each of the benchmark's chains,
    staged to the card by ``DataLoader``: each kernel launched as often as
    ``CHAIN_LAUNCHES`` says and every other never (with the FIR meter F is
    never launched; with E the bf16 tensor-core product never runs),
    outputs of the batch's shapes, finite, and loudness between -40 and -10
    LUFS. The original-phase chain's dataset draws the main chain's clips."""
    from audiotools_tpu_torch.data import DataLoader

    original_phase, fast, method = CHAINS[chain]
    ds = make_dataset(zoo_sources, 8, use_original_phase=original_phase)
    batch = next(iter(DataLoader(ds, batch_size=8, num_workers=0)))
    assert batch["signal"].device.type == "cuda"
    if original_phase:
        main = next(iter(DataLoader(make_dataset(zoo_sources, 8), batch_size=8, num_workers=0)))
        assert torch.equal(batch["signal"].audio_data, main["signal"].audio_data)
    with meter(fast):
        before = _launches()
        audio, mel, lufs = run_chain(ds, batch, method)
        torch.cuda.synchronize()
    after = _launches()
    want = {**dict.fromkeys(after, 0), **CHAIN_LAUNCHES[chain]}
    assert {k: after[k] - before[k] for k in want} == want
    assert audio.shape == (8, 1, 220_500) and lufs.shape == (8,)
    assert mel.shape == (8, 1, 80, 1 + 220_500 // 512)
    assert all(bool(torch.isfinite(t).all()) for t in (audio, mel, lufs))
    assert bool(((lufs > -40) & (lufs < -10)).all())


# each chain on the card against the CPU, every sample. With the fp32
# synthesis both sides sum in fp32 in other orders. With the bf16 synthesis
# a spectrum value within fp32 rounding of a bf16 rounding boundary goes to
# different bf16 neighbours on the two devices, which moves it by one bf16
# ulp, 2**-8 ~ 3.9e-3 of itself: the bound for the largest outputs
CHAIN_TOL = {"fp32": {"audio_abs": 1e-4, "mel_rel": 1e-4, "lufs_db": 0.01},
             "bf16": {"audio_abs": 4e-3, "mel_rel": 4e-3, "lufs_db": 0.01}}


@pytest.mark.parametrize("chain,method,lead", [
    ("main", "matmul", 0), ("main", "matmul_bf16", 0), ("parity", "matmul_bf16_fused", 0),
    ("original_phase", "matmul_bf16", 0), ("original_phase", "matmul_bf16", 11_025)])
def test_chain_on_card_matches_cpu(cuda, zoo_sources, chain, method, lead):
    """4 clips of 5 s through each chain on the card and on the CPU (plain
    versions) from the same drawn arguments, within ``CHAIN_TOL``; the
    original-phase chain also on clips led by 0.25 s of exact zeros
    (digital silence, where the sign of the FFT's zeros decided the dry
    phase before it read 0 at every exactly-zero cell)."""
    from audiotools_tpu_torch.core import util

    original_phase, fast, _ = CHAINS[chain]
    ds = make_dataset(zoo_sources, 4, use_original_phase=original_phase)
    items = util.collate([ds[i] for i in range(4)])
    items["signal"].audio_data[..., :lead] = 0.0
    with meter(fast):
        got = [t.cpu() for t in run_chain(ds, util.prepare_batch(items, cuda), method)]
        want = run_chain(ds, util.prepare_batch(items, "cpu"), method)
    tol = CHAIN_TOL["fp32" if method == "matmul" else "bf16"]
    assert float((got[0] - want[0]).abs().max()) <= tol["audio_abs"]
    assert _rel_err(got[1], want[1]) <= tol["mel_rel"]
    assert float((got[2] - want[2]).abs().max()) <= tol["lufs_db"]


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


# -- the bf16 synthesis as one tensor-core product -----------------------------

# istft(method="matmul_bf16") on the card against its two fp32 products of
# the bf16-rounded operands, relative to the largest output. The products of
# bf16 values are exact in fp32, and both sum them in fp32 over K = 2050 (re
# and im of 1025 bins), in other orders: they part by the fp32 roundings of
# the partial sums, ~sqrt(K / 2) x 2^-24 ~ 2e-6 of a frame's scale (2.6e-6
# of the largest output at 64 x 432 x 1025 on an H100). A product with bf16
# sums or a bf16 result would miss by ~2^-8 ~ 4e-3.
BF16_GEMM_RTOL = 1e-5


def two_product_bf16_istft(spec, n_fft, hop, match_stride, n):
    """``istft(spec, n_fft, hop, "hann", match_stride, original_length=n,
    method="matmul_bf16")`` as the module computes it off the card and under
    a recorded gradient: the bf16-rounded spectrum and iDFT matrices as
    fp32, two fp32 products under ``strict_fp32``, overlap-add, envelope,
    trim."""
    right_pad, pad = PF.compute_stft_padding(n, n_fft, hop, match_stride)
    edge = 2 if match_stride else 0
    S = F.pad(spec.reshape(-1, *spec.shape[-2:]).transpose(-1, -2), (0, 0, edge, edge))
    nt = S.shape[1]
    Ci, Si = PF._on_device(PF._idft_matrices, ("hann", n_fft), S.device)
    (env,) = PF._on_device(PF._inverse_envelope, ("hann", n_fft, hop, nt), S.device)
    re, im, Ci, Si = PF._bf16(S.real), PF._bf16(S.imag), PF._bf16(Ci), PF._bf16(Si)
    with strict_fp32():
        frames = re @ Ci + im @ Si
    y = PF._overlap_add(frames, hop, n_fft + hop * (nt - 1)) * env
    return PF._istft_trim(y, n_fft, n + 2 * pad + right_pad, match_stride, pad, right_pad,
                          spec.shape[:-2])


def _card_spectrum(seed, shape, cuda):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(((rng.randn(*shape) + 1j * rng.randn(*shape)) * 0.1)
                            .astype(np.complex64)).to(cuda)


@pytest.mark.parametrize("match_stride,nt", [(False, 432), (True, 431)])
def test_bf16_synthesis_gemm_matches_the_two_fp32_products(cuda, match_stride, nt):
    """The chain's synthesis shape, 8 x 1025 x 432 at n_fft 2048 and hop
    512 (431 frames with match_stride's zero frames at each end): one
    tensor-core product a call, within ``BF16_GEMM_RTOL`` of the two fp32
    products, and the same bits from the time-major layout the vocoder
    writes."""
    spec = _card_spectrum(nt, (8, 1025, nt), cuda)
    time_major = spec.transpose(-1, -2).contiguous().transpose(-1, -2)
    kw = dict(match_stride=match_stride, original_length=220_500, method="matmul_bf16")
    before = PF.BF16_SYNTHESIS_GEMMS
    got = PF.istft(spec, 2048, 512, **kw)
    got_tm = PF.istft(time_major, 2048, 512, **kw)
    torch.cuda.synchronize()
    assert PF.BF16_SYNTHESIS_GEMMS == before + 2
    want = two_product_bf16_istft(spec, 2048, 512, match_stride, 220_500)
    assert got.shape == want.shape == (8, 220_500)
    assert got.dtype == torch.float32
    assert _rel_err(got, want) < BF16_GEMM_RTOL
    assert torch.equal(got, got_tm)


def test_bf16_synthesis_recording_a_gradient_keeps_the_two_fp32_products(cuda):
    """A card spectrum that requires grad under grad mode takes the two
    fp32 products: no tensor-core product, and the output and the
    spectrum's gradient bit-equal to the written-out path's. Under
    ``no_grad`` the same spectrum takes the product."""
    spec = _card_spectrum(5, (2, 1025, 40), cuda).requires_grad_(True)
    n = 512 * 39
    w = torch.from_numpy(np.random.RandomState(6).randn(2, n).astype(np.float32)).to(cuda)
    before = PF.BF16_SYNTHESIS_GEMMS
    out = PF.istft(spec, 2048, 512, original_length=n, method="matmul_bf16")
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert PF.BF16_SYNTHESIS_GEMMS == before
    ref = spec.detach().clone().requires_grad_(True)
    want = two_product_bf16_istft(ref, 2048, 512, False, n)
    (want * w).sum().backward()
    assert torch.equal(out, want) and torch.equal(spec.grad, ref.grad)
    with torch.no_grad():
        PF.istft(spec, 2048, 512, original_length=n, method="matmul_bf16")
    assert PF.BF16_SYNTHESIS_GEMMS == before + 1


def test_fused_istft_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(8)
    x = torch.from_numpy((rng.randn(2, 1, 22050) * 0.3).astype(np.float32))
    spec = PF.stft(x, 2048, 512, match_stride=True)
    got = PF.istft(spec.to(cuda), 2048, 512, match_stride=True, original_length=22050,
                   method="matmul_bf16_fused")
    want = PF.istft(spec, 2048, 512, match_stride=True, original_length=22050,
                    method="matmul_bf16_fused")
    assert _rel_err(got, want) < KERNEL_RTOL


def test_signals_from_arrays_default_to_the_card(cuda):
    """A signal made from a numpy array goes to the card unless told
    ``device="cpu"``; one made from a CPU tensor stays where it is."""
    from audiotools_tpu_torch import AudioSignal

    x = np.zeros((1, 1, 100), np.float32)
    assert AudioSignal(x, SR).device.type == "cuda"
    assert AudioSignal(x, SR, device="cpu").device.type == "cpu"
    assert AudioSignal(torch.from_numpy(x), SR).device.type == "cpu"


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
    # bf16 ulp, 2**-8, of a value), as CHAIN_TOL states
    assert (got.cpu() - PS.pitch_shift(x, 2.0, 44100, **kw)).abs().max() < 4e-3


# -- R4, R5: gradients ---------------------------------------------------------

# the fused vocoder's gradient against the phasor formulation's, relative to
# the largest gradient: at the vocoder the JAX package's pin (docs/perf.md),
# through the whole pitch shift its test's
# (tests/core/test_stretch.py::test_pitch_shift_fused_is_differentiable)
PV_GRAD_RTOL = 4.4e-5
PITCH_GRAD_RTOL = 1e-4
@pytest.mark.parametrize("case", [0, 3, 5, 8, "main"])
def test_fused_vocoder_gradient_matches_phasor_on_card(cuda, zoo_sources, case):
    """R4: ``phase_vocoder(formulation="phasor_fused")`` on the card runs
    kernel B with its phasor track once under the forward, and its custom
    backward gives the autograd gradient of the ``phasor`` formulation, at
    ragged shapes with silent bins and transient zero frames, and on the
    spectrum the pitch shift's vocoder sees at +2 semitones: 64 speech
    excerpts of 5 s resampled by 55/49, (64, 1, 1025, 384)."""
    from audiotools_tpu_torch.ops import resample as PR

    if case == "main":
        seed, rate = len(RAGGED.PV), 2 ** (-2 / 12)
        audio = PR.resample(_fixture_clips(zoo_sources, 64, 220_500).to(cuda), 55, 49)
        z = PF.stft(audio, 2048, 512, method="matmul")
        assert z.shape == (64, 1, 1025, 384)
    else:
        seed, (shape, rate) = case, RAGGED.PV[case]
        z = torch.from_numpy(RAGGED.pv_case(shape, rate, seed=case)[0]).to(cuda)
    grads = {}
    for formulation in ("phasor_fused", "phasor"):
        zt = z.detach().clone().requires_grad_(True)
        before = HK.LAUNCHES["phase_vocoder_fused"]
        out = PS.phase_vocoder(zt, rate, 512, 2048, formulation=formulation)
        launched = HK.LAUNCHES["phase_vocoder_fused"] - before
        assert launched == (formulation == "phasor_fused")
        w = torch.from_numpy(np.random.RandomState(seed).randn(*out.shape).astype(np.float32))
        ((out.abs() ** 2).sum() + (out.real * w.to(cuda)).sum()).backward()
        grads[formulation] = zt.grad.cpu()
    scale = float(grads["phasor"].abs().max())
    assert torch.isfinite(grads["phasor_fused"]).all()
    assert float((grads["phasor_fused"] - grads["phasor"]).abs().max()) / scale < PV_GRAD_RTOL


def _graph_has(t, node_name):
    """Whether the autograd graph behind ``t`` holds a node ``node_name``."""
    seen, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == node_name:
            return True
        stack.extend(f for f, _ in fn.next_functions)
    return False


def test_fused_pitch_shift_gradient_matches_phasor_on_card(cuda, zoo_sources):
    """R4 through the whole pitch shift (+2 st, 4 clips of 1 s): d sum(w *
    out) / dx with the fused vocoder, whose pass launches kernel B once (with
    its phasor track) and no other kernel and goes back through its custom
    backward, against autograd of the ``phasor`` formulation."""
    audio = _fixture_clips(zoo_sources, 4, SR).to(cuda)
    w = torch.from_numpy(np.random.RandomState(11).randn(*audio.shape).astype(np.float32)).to(cuda)

    def gradient(formulation):
        x = audio.clone().requires_grad_(True)
        out = PS.pitch_shift(x, 2.0, SR, pv_formulation=formulation)
        (out * w).sum().backward()
        return x.grad, out

    before = dict(HK.LAUNCHES)
    fused, out = gradient("phasor_fused")
    torch.cuda.synchronize()
    assert {k: HK.LAUNCHES[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "phase_vocoder_fused": 1}
    assert _graph_has(out, "_FusedPhaseVocoderBackward")
    assert _rel_err(fused, gradient("phasor")[0]) < PITCH_GRAD_RTOL


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
        "iir_block_scan": lambda g: HK.iir_block_scan(
            torch.randn(3, 9, 4, device=cuda, requires_grad=g), torch.eye(4, device=cuda) * 0.5),
    }


@pytest.mark.parametrize("name", ["fir_causal_batch", "fir_causal", "rotation_cumprod",
                                  "istft_synthesis_fused", "iir_block_scan"])
def test_kernels_without_backward_raise_on_grad(cuda, name):
    """R5: kernels A, C, D, E and F have no backward. Given an input that
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


# -- G: DAC's Snake, forward and backward ---------------------------------------

# (B, C, T) and the input's storage offset in floats: the codec decoder's
# last Snake at 30 s, the training cell's first, an odd T whose rows start
# at every alignment, and an input 4 bytes past a 16-byte boundary (its
# output is aligned: the kernel's one-element-a-lane path)
SNAKE_CASES = {"codec": ((1, 96, 1_323_008), 0), "training": ((18, 64, 16_896), 0),
               "odd_T": ((3, 5, 1031), 0), "offset": ((2, 3, 4099), 1)}
# x's gradient against eager autograd's, in ulp of its two addends' sizes
# (the same product chain; sincosf against sinf and cosf), and alpha's
# against eager's fp32 reductions, relative to its largest value
SNAKE_GX_ULP = 4
SNAKE_GALPHA_RTOL = 1e-5


def _snake_case(cuda, label, seed=0):
    (B, C, T), offset = SNAKE_CASES[label]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(offset + B * C * T, device=cuda, generator=gen) * 2.0)[offset:].view(B, C, T)
    alpha = torch.exp(torch.randn(1, C, 1, device=cuda, generator=gen) * 0.5)
    g = torch.randn(B, C, T, device=cuda, generator=gen)
    return x, alpha, g


@pytest.mark.parametrize("label", sorted(SNAKE_CASES))
def test_snake_forward_is_the_expression_bit_for_bit(cuda, label):
    """G's forward equals the eager expression bit for bit, one launch."""
    from audiotools_tpu_torch.models import dac as PD

    x, alpha, _ = _snake_case(cuda, label)
    before = HK.LAUNCHES["snake"]
    with torch.no_grad():
        got = PD.snake(x, alpha)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["snake"] == before + 1
    assert torch.equal(got, HK.snake_plain(x, alpha))


@pytest.mark.parametrize("label", sorted(SNAKE_CASES))
def test_snake_backward_matches_eager_autograd(cuda, label):
    """Under autograd G runs one forward and one backward call; x's gradient
    is within a few ulp of eager autograd's, alpha's within 1e-5."""
    x, alpha, g = _snake_case(cuda, label)
    xk, ak = x.detach().requires_grad_(True), alpha.clone().requires_grad_(True)
    before = dict(HK.LAUNCHES)
    HK.snake(xk, ak).backward(g)
    torch.cuda.synchronize()
    assert {k: HK.LAUNCHES[k] - before[k] for k in ("snake", "snake_backward")} == {
        "snake": 1, "snake_backward": 1}
    xe, ae = x.detach().clone().requires_grad_(True), alpha.clone().requires_grad_(True)
    HK.snake_plain(xe, ae).backward(g)
    eps = torch.finfo(torch.float32).eps
    size = g.abs() + (xe.grad - g).abs()
    assert bool(((xk.grad - xe.grad).abs() <= SNAKE_GX_ULP * eps * size).all())
    assert float((ak.grad - ae.grad).abs().max() / ae.grad.abs().max()) < SNAKE_GALPHA_RTOL


def test_snake_backward_twice_gives_the_same_bits(cuda):
    """alpha's gradient is reduced in a fixed order, without atomics."""
    x, alpha, g = _snake_case(cuda, "training", seed=1)
    first, second = HK.snake_backward(x, alpha, g), HK.snake_backward(x, alpha, g)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_snake_off_fp32_on_card_runs_the_expression(cuda):
    """bf16 and fp64 on the card keep eager's expression: G does not launch."""
    from audiotools_tpu_torch.models import dac as PD

    x, alpha, _ = _snake_case(cuda, "odd_T")
    before = dict(HK.LAUNCHES)
    for dtype in (torch.bfloat16, torch.float64):
        xd, ad = x.to(dtype), alpha.to(dtype)
        assert torch.equal(PD.snake(xd, ad), xd + (1.0 / (ad + 1e-9)) * torch.sin(ad * xd) ** 2)
    assert HK.LAUNCHES == before


def test_snake_launches_in_a_codec_round_trip_and_a_training_step(cuda):
    """The default DAC has 29 Snakes in its encoder and 29 in its decoder:
    a round trip launches G's forward 58 times and its backward never; one
    adversarial step launches each 58 times."""
    from audiotools_tpu_torch.examples.train_dac import TOY_DISC, adamw
    from audiotools_tpu_torch.models import DAC, Discriminator, compress, decompress
    from audiotools_tpu_torch.models.adversarial import make_adversarial_train_step
    from audiotools_tpu_torch.models.dac import Snake

    model = DAC().to(cuda)
    assert [sum(isinstance(m, Snake) for m in part.modules())
            for part in (model.encoder, model.decoder)] == [29, 29]
    rng = np.random.RandomState(3)
    before = dict(HK.LAUNCHES)
    art = compress(model, (rng.randn(1, 1, 44_100) * 0.1).astype(np.float32))
    encoded = dict(HK.LAUNCHES)
    decompress(model, art)
    torch.cuda.synchronize()
    assert [encoded["snake"] - before["snake"], HK.LAUNCHES["snake"] - encoded["snake"],
            HK.LAUNCHES["snake_backward"] - before["snake_backward"]] == [29, 29, 0]

    disc = Discriminator(**TOY_DISC, seed=1).to(cuda)
    step = make_adversarial_train_step(model, disc, adamw(model, 1e-4), adamw(disc, 1e-4), 44_100)
    audio = torch.from_numpy((rng.randn(2, 1, 16_896) * 0.1).astype(np.float32)).to(cuda)
    with strict_fp32():
        before = dict(HK.LAUNCHES)
        metrics = step(audio)
        torch.cuda.synchronize()
    assert {k: HK.LAUNCHES[k] - before[k] for k in ("snake", "snake_backward")} == {
        "snake": 58, "snake_backward": 58}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


# -- the augmentation zoo: each transform on the card against the CPU --------

ZOO_SOURCES = {"BackgroundNoise": "nz.csv", "CrossTalk": "spk.csv",
               "RoomImpulseResponse": "ir.csv"}
ZOO_LEAVES = ["BackgroundNoise", "ClippingDistortion", "CorruptPhase", "CrossTalk", "Equalizer",
              "FrequencyMask", "FrequencyNoise", "GlobalVolumeNorm", "HighPass", "InvertPhase",
              "LowPass", "MaskLowMagnitudes", "MuLawQuantization", "NoiseFloor", "Quantization",
              "RescaleAudio", "RoomImpulseResponse", "ShiftPhase", "Silence", "Smoothing",
              "SpectralDenoising", "TimeMask", "TimeNoise", "VolumeChange", "VolumeNorm"]
# the zoo's bounds, card against CPU on the same input: max abs error on the
# audio (FFTs, kernel A and the meters sum in other orders on the two
# devices), and for the quantizers the share of samples differing by more
# than it (a sample whose input lies within rounding of a level's edge,
# (x + 1) / 2 q, and mu-law's log1p and exp, round differently on the card,
# moves by a whole level)
ZOO_ABS, ZOO_SHARE = 1e-4, 1e-3


@pytest.fixture(scope="module")
def zoo_sources(tmp_path_factory):
    """The fixture tree (``build_fixture_tree``) that the chains, the zoo,
    the gradients and the training steps read, built once a module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
    from audiotools_tpu_torch.examples.train_dac import speech_like

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


@pytest.mark.parametrize("lead", [0, 11025])
def test_original_phase_reverb_on_card_matches_cpu(cuda, zoo_sources, lead):
    """``RoomImpulseResponse(use_original_phase=True)`` on 4 clips of 5 s,
    with and without 0.25 s of digital silence at their start: the dry
    phase of an exactly-zero cell reads 0 on both devices, so every sample
    holds the zoo's bound."""
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch.core import util
    from audiotools_tpu_torch.data import transforms as tfm
    from audiotools_tpu_torch.examples.train_dac import speech_like

    transform = tfm.RoomImpulseResponse(sources=[str(zoo_sources / "ir.csv")],
                                        use_original_phase=True)
    x = np.stack([speech_like(30 + i, 5.0)[None] for i in range(4)])
    x[..., :lead] = 0.0
    item = AudioSignal(x[:1].copy(), 44100, device="cpu")
    drawn = transform.batch_instantiate([0, 1, 2, 3], item)
    got = transform(AudioSignal(torch.from_numpy(x).to(cuda), 44100),
                    **util.prepare_batch(drawn, cuda))
    want = transform(AudioSignal(torch.from_numpy(x), 44100), **util.prepare_batch(drawn, "cpu"))
    assert got.device.type == "cuda" and got.audio_data.shape == want.audio_data.shape
    assert float((got.audio_data.cpu() - want.audio_data).abs().max()) <= ZOO_ABS
    if lead:  # the card's dry STFT holds exactly-zero cells
        assert bool((AudioSignal(torch.from_numpy(x).to(cuda), 44100).stft() == 0).any())


def make_zoo_dataset(root, n_examples):
    """AudioDataset over the speech fixtures with every leaf transform."""
    from audiotools_tpu_torch.data import transforms as tfm
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader

    transform = tfm.Compose(
        tfm.RoomImpulseResponse(sources=[str(root / "ir.csv")]),
        tfm.BackgroundNoise(sources=[str(root / "nz.csv")]),
        tfm.CrossTalk(sources=[str(root / "spk.csv")]),
        tfm.NoiseFloor(), tfm.Choose(tfm.LowPass(), tfm.HighPass()), tfm.Equalizer(),
        tfm.ClippingDistortion(prob=0.5),
        tfm.Choose(tfm.Quantization(), tfm.MuLawQuantization(), prob=0.5),
        tfm.Smoothing(prob=0.5), tfm.RepeatUpTo(tfm.VolumeChange(), max_repeat=3),
        tfm.SpectralDenoising(prob=0.5),
        tfm.Choose(tfm.ShiftPhase(), tfm.InvertPhase(), tfm.CorruptPhase()),
        tfm.FrequencyMask(prob=0.5), tfm.TimeMask(prob=0.5), tfm.MaskLowMagnitudes(prob=0.5),
        tfm.FrequencyNoise(prob=0.5), tfm.TimeNoise(prob=0.5), tfm.Silence(),
        tfm.GlobalVolumeNorm(), tfm.VolumeNorm(), tfm.RescaleAudio(),
    )
    return AudioDataset(AudioLoader(sources=[str(root / "spk.csv")]), sample_rate=SR,
                        n_examples=n_examples, duration=5.0, transform=transform)


def _holds(transform, kinds):
    """Whether a transform of the zoo is, or holds, one of ``kinds``."""
    return isinstance(transform, kinds) or any(
        _holds(c, kinds) for c in getattr(transform, "transforms", []))


def _one_sided_empty_samples(signal, cuda):
    """``(B, C, T)`` bool: the samples inside a frame whose STFT (at the
    signal's parameters) holds a cell that the noise fills read as empty
    (magnitude and phase 0, i.e. exactly zero) on one device and not on the
    other."""
    def empty(s):
        s.stft()
        return ((s.magnitude == 0) & (s.phase == 0)).cpu()

    p = signal.stft_params
    one_sided = (empty(signal.clone()) != empty(signal.clone().to(cuda))).any(dim=-2)
    out = torch.zeros(signal.audio_data.shape, dtype=torch.bool)
    for b, c, t in one_sided.nonzero().tolist():
        start = t * p.hop_length - p.window_length // 2
        out[b, c, max(start, 0):max(start + p.window_length, 0)] = True
    return out


def test_zoo_chain_on_card_matches_cpu_child_by_child(cuda, zoo_sources):
    """The augmentation zoo (every leaf transform under ``Compose``,
    ``Choose`` and ``RepeatUpTo``, probabilities below 1 mixing the masks
    within the batch) on 4 clips of 5 s: on the card kernel A launches (the
    equalizers), the output is finite, of the input's shape and peaks at
    most 1 (``RescaleAudio``); then child by child as ``Compose`` runs them,
    each on both devices from the CPU's output of the child before, within
    the zoo's bounds. TimeNoise and FrequencyNoise fill every cell whose
    magnitude and phase are 0, as the JAX package does: the phase of an
    exactly-zero cell reads 0 on both devices, so frames of digital silence
    are filled alike; but in frames of few distinct values (the quantizers
    make them) one FFT may cancel to an exact zero where the other leaves a
    rounding residue, so their bound holds outside the frames holding a cell
    the fill reads as empty on one device only."""
    from audiotools_tpu_torch.core import util
    from audiotools_tpu_torch.data import transforms as tfm

    ds = make_zoo_dataset(zoo_sources, 4)
    items = util.collate([ds[i] for i in range(4)])
    on_card, on_cpu = util.prepare_batch(items, cuda), util.prepare_batch(items, "cpu")
    args = on_cpu["transform_args"]["Compose"]
    assert any(0 < int(np.asarray(args[t.name]["mask"]).sum()) < 4 for t in ds.transform)
    before = HK.LAUNCHES["fir_causal_batch"]
    out = ds.transform(on_card["signal"].clone(), **on_card["transform_args"]).audio_data
    torch.cuda.synchronize()
    assert HK.LAUNCHES["fir_causal_batch"] > before
    assert out.device.type == "cuda" and out.shape == (4, 1, 220_500)
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) <= 1.0 + 1e-6

    signal = on_cpu["signal"].clone()
    for child in ds.transform:
        kept = torch.ones(signal.audio_data.shape, dtype=torch.bool)
        if _holds(child, (tfm.TimeNoise, tfm.FrequencyNoise)):
            kept = ~_one_sided_empty_samples(signal, cuda)
        got = child(signal.clone().to(cuda), **on_card["transform_args"]["Compose"])
        signal = child(signal, **args)
        diff = (got.audio_data.cpu() - signal.audio_data).abs()
        if _holds(child, (tfm.Quantization, tfm.MuLawQuantization)):
            assert float((diff > ZOO_ABS).float().mean()) <= ZOO_SHARE, child.name
        else:
            assert float(diff[kept].max()) <= ZOO_ABS, child.name
    assert bool(torch.isfinite(signal.audio_data).all())


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
    """One aligned multitrack batch, items 0-3 in order from the resumable
    sampler: every signal crosses as int16 and dequantizes on the card to
    the host's float batch within int16 rounding."""
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
    assert batch["idx"].tolist() == list(range(4))
    for voice in loaders:
        signal = batch[voice]["signal"]
        assert signal.audio_data.dtype == torch.int16 and signal.device.type == "cuda"
        back = signal.clone().dequantize_wire().audio_data
        assert back.device.type == "cuda"
        assert float((back.cpu() - host[voice]["signal"].audio_data).abs().max()) <= 2.0 ** -16


@pytest.fixture(scope="module")
def chords(tmp_path_factory):
    """The multitrack path's fixture: 2 tracks of 2 s, up to 4 sine voices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from audiotools_tpu_torch.core import util

    util.seed(0)
    return util.generate_chord_dataset(max_voices=4, num_items=2, duration=2.0, sample_rate=SR,
                                       output_dir=tmp_path_factory.mktemp("chords"))


# each stage after the stretch on both devices from the CPU's output of the
# stage before: audio 1e-4 abs (fp32 sums in other orders), the STFT 1e-5 of
# its largest magnitude (2048-term sums), the mel and the MFCCs' log-DCT
# 1e-4 of their largest magnitude, and on each device the bands' sum equal
# to their input within 1e-6 (the JAX package's partition-of-unity pin,
# tests/parity/test_parity.py). Not held: the whole stretch (pure sines
# leave bins at fp32's rounding floor for hundreds of frames, where the
# vocoder's phase is a random walk of rounding in either formulation) and
# the whole MFCC (its log turns the two FFTs' rounding floors into
# differences of order one); the vocoder on one spectrum is held bit for bit
# by test_time_stretch_fused_on_card_matches_cpu
MT_TOL = {"stft_rel": 1e-5, "istft_abs": 1e-4, "eq_abs": 1e-4, "bands_abs": 1e-4,
          "bands_sum_abs": 1e-6, "weighted_abs": 1e-4, "windows_abs": 1e-4, "mel_rel": 1e-4,
          "log_dct_rel": 1e-4}


@pytest.mark.parametrize("factor", [1.25, 0.8])
def test_multitrack_stages_on_card_match_cpu(cuda, chords, tmp_path, factor):
    """Two aligned voices of the chord fixture through the int16 wire,
    dequantized and summed on each device (the same bits), then the stages
    that follow ``time_stretch``: the STFT; the iSTFT of the CPU's stretched
    spectrum; the per-item EQ through kernel A; ``split_bands(6)``; the
    K-weighting ``biquad_cascade``; a ``collect_windows`` /
    ``overlap_and_add`` round trip (exact on each device); the mel and the
    MFCCs (40 of 80 bands), the MFCCs the log-DCT of the mel; an item
    written as float WAV, read back as written; all within ``MT_TOL``."""
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch.core import util
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader
    from audiotools_tpu_torch.data.loader import _wire_quantize
    from audiotools_tpu_torch.io import read_wav

    voices = ("voice_0", "voice_1")
    loaders = {v: AudioLoader(sources=[str(chords / f"{v}.csv")]) for v in voices}
    ds = AudioDataset(loaders, sample_rate=SR, n_examples=2, duration=2.0, aligned=True)
    items = _wire_quantize(util.collate([ds[i] for i in range(2)]), "int16")
    devices = (cuda, "cpu")
    mix = {}
    for d in devices:
        batch = util.prepare_batch(items, d)
        mix[d] = sum(batch[v]["signal"].clone().dequantize_wire().audio_data for v in voices)
    x = mix["cpu"]
    assert torch.equal(mix[cuda].cpu(), x)

    def gap(got, want, rel=False):
        err = float((got.cpu() - want).abs().max())
        return err / float(want.abs().max()) if rel else err

    err = {}
    spec = {d: PF.stft(x.to(d), 2048, 512, "hann", method="matmul") for d in devices}
    err["stft_rel"] = gap(spec[cuda], spec["cpu"], rel=True)
    voc = PS.phase_vocoder(spec["cpu"], factor, 512, 2048, "phasor_fused")
    length = round(x.shape[-1] / factor)
    st = {d: PF.istft(voc.to(d), 2048, 512, "hann", length=length, method="matmul")
          for d in devices}
    err["istft_abs"] = gap(st[cuda], st["cpu"])
    curve = torch.from_numpy(-np.random.RandomState(7).rand(2, 6).astype(np.float32))
    before = HK.LAUNCHES["fir_causal_batch"]
    eq = {d: AudioSignal(st["cpu"].to(d), SR).equalizer(curve.to(d), conv_method="pallas")
          .audio_data for d in devices}
    assert HK.LAUNCHES["fir_causal_batch"] == before + 1
    err["eq_abs"] = gap(eq[cuda], eq["cpu"])
    src = {d: AudioSignal(eq["cpu"].to(d), SR) for d in devices}
    bands = {d: src[d].mel_filterbank(6) for d in devices}
    assert bands[cuda].shape == (2, 1, length, 6)
    err["bands_abs"] = gap(bands[cuda], bands["cpu"])
    err["bands_sum_abs"] = max(gap(bands[d].sum(-1), eq["cpu"]) for d in devices)
    k_weighting = [(b, a, g) for (b, a), g in PL.design_filters(SR, "K-weighting")]
    weighted = {d: PFL.biquad_cascade(src[d].audio_data, k_weighting) for d in devices}
    err["weighted_abs"] = gap(weighted[cuda], weighted["cpu"])
    windows = {d: src[d].clone().collect_windows(1.0, 0.5).overlap_and_add(0.5).audio_data
               for d in devices}
    assert all(torch.equal(windows[d].cpu(), eq["cpu"]) for d in devices)
    err["windows_abs"] = gap(windows[cuda], windows["cpu"])
    mel = {d: src[d].mel_spectrogram(80) for d in devices}
    err["mel_rel"] = gap(mel[cuda], mel["cpu"], rel=True)
    with strict_fp32():
        log_dct = {d: AudioSignal.get_dct(40, 80, device=d).T @ torch.log(mel["cpu"].to(d) + 1e-6)
                   for d in devices}
    err["log_dct_rel"] = gap(log_dct[cuda], log_dct["cpu"], rel=True)
    mfcc = src[cuda].mfcc(40, 80)
    assert mfcc.shape == (2, 1, 40, 1 + length // 512) and bool(torch.isfinite(mfcc).all())
    assert torch.equal(src["cpu"].mfcc(40, 80), log_dct["cpu"])
    for d in devices:
        path = tmp_path / f"{torch.device(d).type}.wav"
        src[d][0].write(path, subtype="FLOAT")
        assert np.array_equal(read_wav(path)[0], eq["cpu"][0].numpy())
    assert all(bool(torch.isfinite(t).all()) for t in (eq[cuda], bands[cuda], weighted[cuda]))
    assert {k: v for k, v in err.items() if v > MT_TOL[k]} == {}


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


def test_codec_folder_stream_and_artifact_on_card(cuda, tmp_path):
    """The tiny DAC saved by ``save_to_folder`` and loaded by
    ``load_from_folder`` onto the card (its default device), the weights
    bit-equal; the encoder through the streaming windows gives the whole
    pass's latents within 1e-5 of their largest value, and a
    ``StreamingEncoder`` fed blocks of 0.1-0.7 s the whole pass's codes; the
    artifact through ``save_artifact`` and
    ``load_artifact`` unchanged; its decode on the card and on the CPU each
    within 1e-5 of the largest value of the card's float64 decode (a
    forward pass in fp32, in other orders on the two devices,
    tests/test_torch_models.py's FWD_RTOL)."""
    import copy

    from audiotools_tpu_torch.models import (DAC, StreamingEncoder, compress, decompress,
                                             load_artifact, save_artifact, streaming)

    host = DAC(**SERVING_TINY)
    host.save_to_folder(tmp_path / "dac")
    model, _ = DAC.load_from_folder(tmp_path / "dac")
    assert model.device.type == "cuda"
    assert all(torch.equal(v.cpu(), host.state_dict()[k]) for k, v in model.state_dict().items())
    audio = (np.random.RandomState(8).randn(2, 1, 32_000) * 0.3).astype(np.float32)
    art = compress(model, audio)
    x = torch.from_numpy(audio).to(cuda)
    hop, halo = model.hop_length, streaming.encoder_halo_frames(model)
    padded, width = model._pad(x), 16 + 2 * halo
    with torch.no_grad(), strict_fp32():
        parts = [model.encoder(padded[..., start * hop:(start + width) * hop].contiguous())[
            ..., lo:hi] for start, lo, hi in streaming._window_starts(
                padded.shape[-1] // hop, 16, halo, width)]
        assert _rel_err(torch.cat(parts, dim=-1), model.encoder(padded)) <= 1e-5
    rng = np.random.RandomState(12)
    enc, pieces, pos = StreamingEncoder(model, batch_size=2, chunk_frames=16), [], 0
    while pos < x.shape[-1]:
        step = int(rng.uniform(0.1, 0.7) * 16_000)
        pieces += list(enc.push(x[..., pos:pos + step]))
        pos += step
    pieces += list(enc.flush())
    assert np.array_equal(torch.cat(pieces, dim=-1).cpu().numpy(), art["codes"])
    back = load_artifact(save_artifact(str(tmp_path / "clips.npz"), art))
    assert back.keys() == art.keys() and np.array_equal(back["codes"], art["codes"])
    assert all(back[k] == art[k] for k in art if k != "codes")
    card, cpu = decompress(model, back).audio_data, decompress(host, back).audio_data
    model64 = copy.deepcopy(model).double()
    with torch.no_grad():
        ref = model64.decode_from_codes(torch.from_numpy(art["codes"].astype(np.int64)).to(cuda))
    ref = ref[..., :audio.shape[-1]].cpu()
    bound = 1e-5 * float(ref.abs().max())
    assert float((card.cpu().double() - ref).abs().max()) <= bound
    assert float((cpu.double() - ref).abs().max()) <= bound


def test_quality_metrics_on_card_match_cpu(cuda):
    """STOI (and its retained frames), PESQ (and its delays) and NSIM in both
    modes on the card against the same programs on the CPU, at the JAX
    package's pins; the entry points on card signals one finite score a pair
    on the card, within the same pins of the float64 host STOI and the
    native PESQ (where device PESQ reproduces the host's trim: a delay that
    is not negative, or a whole number of hops, ops/pesq.py)."""
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch.metrics import quality as Q
    from audiotools_tpu_torch.metrics._pesq import _MODES
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
    delays = d_got.cpu()
    for mode in ("speech", "audio"):
        fs = PN.MODES[mode]["fs"]
        card_fs, cpu_fs = ([AudioSignal(a[:, None], 16000).resample(fs).audio_data[:, 0] for a in pair]
                           for pair in (card, cpu))
        got = PN.nsim_batch(*card_fs, mode=mode)
        assert float((got.cpu() - PN.nsim_batch(*cpu_fs, mode=mode)).abs().max()) <= 1e-4

    ref, est = (AudioSignal(a[:, None], 16000) for a in card)
    host_ref, host_est = (AudioSignal(a[:, None], 16000) for a in cpu)
    hop = _MODES["wb"].hop
    for got, want, tol, held in (
            (Q.stoi_device(est, ref), Q.stoi(host_est, host_ref), 5e-4, range(3)),
            (Q.stoi_device(est, ref, extended=True), Q.stoi(host_est, host_ref, extended=True),
             5e-4, range(3)),
            (Q.pesq_device(est, ref), Q.pesq(host_est, host_ref, backend="native"), 2e-3,
             [i for i in range(3) if delays[i] >= 0 or delays[i] % hop == 0])):
        assert got.device.type == "cuda" and got.shape == (3,) and bool(torch.isfinite(got).all())
        gap = (got.cpu().double() - torch.as_tensor(want).double()).abs()
        assert all(gap[i] <= tol for i in held), gap
    for mode in ("audio", "speech"):
        scores = Q.visqol(est, ref, mode=mode, backend="nsim")
        assert scores.shape == (3,) and bool(torch.isfinite(scores).all())


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


def test_training_loop_runs_and_resumes_on_card(cuda, tmp_path, monkeypatch):
    """``examples.train_dac`` at the toy widths on the card (its default
    device), adversarial, 4 steps of 4 x 3,200 samples saving every 2: each
    batch and every parameter on the card, finite losses, checkpoints 2 and
    4 kept; a run of 2 steps, then a fresh run from its checkpoint: the
    restored models, optimizers and tracker are the saved ones bit for bit,
    the run is fed steps 3-4 of the whole run's dataset indices and its
    history holds the first run's 2 steps and 2 more; 2 steps with
    ``--amp``; one step under ``ml.profiling.trace`` writes a trace."""
    import copy

    from audiotools_tpu_torch.examples import train_dac
    from audiotools_tpu_torch.ml import profiling

    fed, on_card, restored = [], set(), {}
    build, checkpointer = train_dac.build, train_dac.Checkpointer

    def recording_build(args):
        run = build(args)
        prepare, step, idx = run.accel.prepare_dataloader, run.step_fn, []
        fed.append(idx)

        def batches(*a, **kw):
            for batch in prepare(*a, **kw):
                idx.append([int(i) for i in batch["idx"]])
                yield batch

        def checked(audio):
            on_card.add(audio.device.type)
            return step(audio)

        run.accel.prepare_dataloader, run.step_fn = batches, checked
        return run

    class Recording(checkpointer):
        def restore(self, step=None, template=None):
            state, meta = super().restore(step, template)
            restored.update(meta=meta, params={k: {n: t.clone() for n, t in m.state_dict().items()}
                                               for k, m in template["params"].items()},
                            opt_state={k: copy.deepcopy(o.state_dict())
                                       for k, o in template["opt_state"].items()})
            return state, meta

    monkeypatch.setattr(train_dac, "build", recording_build)
    monkeypatch.setattr(train_dac, "Checkpointer", Recording)

    def run(folder, steps, *extra):
        return train_dac.main(train_dac.parse_args([
            "--toy", "--adversarial", "--batch-size", "4", "--sample-rate", "16000",
            "--duration", "0.2", "--steps", str(steps), "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path / folder), *extra]))

    whole = run("whole", 4)
    first = run("resumed", 2)
    saved = {"params": {k: m.state_dict() for k, m in first.params.items()},
             "opt_state": {k: o.state_dict() for k, o in first.opt_state.items()}}
    second = run("resumed", 4)
    assert whole.T == 3200 and whole.ckpt.steps() == [2, 4]
    assert on_card == {"cuda"}
    assert all(p.device.type == "cuda" for r in (whole, second) for m in r.params.values()
               for p in m.parameters())
    history = whole.tracker.history["train"]
    assert all(np.isfinite(v).all() for k, v in history.items() if k.startswith("loss"))
    assert restored["meta"]["step"] == 2 and restored["meta"]["data_idx"] == 8
    for k, net in saved["params"].items():
        assert all(torch.equal(t, restored["params"][k][n]) for n, t in net.items()), k
    for k, opt in saved["opt_state"].items():
        for i, state in opt["state"].items():
            assert all(torch.equal(t, restored["opt_state"][k]["state"][i][n])
                       for n, t in state.items()), (k, i)
    assert fed[2] == fed[0][2:]
    resumed = second.tracker.history["train"]
    assert resumed["step"] == [1, 2, 3, 4]
    assert {k: v[:2] for k, v in resumed.items()} == first.tracker.history["train"]

    amp = run("amp", 2, "--amp")
    assert amp.model.dtype == torch.bfloat16
    assert all(np.isfinite(v).all() for k, v in amp.tracker.history["train"].items()
               if k.startswith("loss"))
    with profiling.trace(tmp_path / "trace"):
        run("traced", 1)
    assert any(f.stat().st_size > 0 for f in (tmp_path / "trace").rglob("*.json"))


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


# one step on the card against the CPU, both in full fp32. Forward values and
# losses: fp32 sums in other orders (cuDNN's algorithms) through ~60 layers.
# The gradient norm: the log-magnitude losses weigh quiet bins by 1 / |X| and
# magnify rounding there (tests/test_torch_losses.py). After one AdamW step
# each parameter moves by about LR; a gradient within rounding of zero may
# flip its sign and move by 2 LR the other way, so at most one entry in 1000
# may differ by more than 1e-3 LR, and none by more than 2 LR.
TRAIN_TOL = {"latent_rel": 1e-4, "decoded_rel": 1e-4, "loss_rel": 1e-4,
             "grad_norm_rel": 1e-3, "update_lr": 1e-3, "update_share": 1e-3}


def _update_gap(models, others):
    """Largest parameter difference between two copies of the same models
    after one step, and the share of entries differing by more than
    ``update_lr`` LR."""
    worst, over, total = 0.0, 0, 0
    for a, b in zip(models, others):
        for pa, pb in zip(a.parameters(), b.parameters()):
            pa, pb = (p.full_tensor() if hasattr(p, "full_tensor") else p for p in (pa, pb))
            diff = (pa.detach().cpu() - pb.detach().cpu()).abs()
            worst = max(worst, float(diff.max()))
            over += int((diff > TRAIN_TOL["update_lr"] * LR).sum())
            total += diff.numel()
    return worst, over / total


def _grad_norm(model):
    return float(torch.sqrt(sum((p.grad.detach().double().cpu() ** 2).sum()
                                for p in model.parameters() if p.grad is not None)))


@pytest.mark.parametrize("label,stft_method", [("reconstruction", "matmul"),
                                               ("adversarial", "matmul"),
                                               ("adversarial", "matmul_bf16")])
def test_training_step_on_card_matches_cpu(cuda, zoo_sources, label, stft_method):
    """``DAC()`` (and ``Discriminator()``, its MRD's analysis fp32 or the
    single-pass bf16) at their defaults from the same seeded weights, one
    step of the first 2 of 16 speech excerpts of 16,896 samples (33 hops of
    512) on the card and on the CPU inside
    ``strict_fp32``, held to ``TRAIN_TOL``: the encoder's latents and the
    decoder on the CPU's codes, the finite losses, the generator's gradient
    norm and the parameters after the update."""
    from audiotools_tpu_torch.ops._fp32 import strict_fp32

    audio = _fixture_clips(zoo_sources, 2, 16_896, n_examples=16)
    with strict_fp32():
        card_models, card_step = _training_step(label, cuda, stft_method)
        cpu_models, cpu_step = _training_step(label, "cpu", stft_method)
        if label == "reconstruction":
            (gen_card,), (gen_cpu,) = card_models, cpu_models
            with torch.no_grad():
                latents = gen_card.encoder(gen_card._pad(audio.to(cuda)))
                assert _rel_err(latents, gen_cpu.encoder(gen_cpu._pad(audio))) <= TRAIN_TOL[
                    "latent_rel"]
                _, codes = gen_cpu.encode(audio)
                decoded = gen_card.decode_from_codes(codes.to(cuda))
                assert _rel_err(decoded, gen_cpu.decode_from_codes(codes)) <= TRAIN_TOL[
                    "decoded_rel"]
        got = {k: float(v) for k, v in card_step(audio.to(cuda)).items()}
        want = {k: float(v) for k, v in cpu_step(audio).items()}
    assert all(np.isfinite(v) for v in got.values())
    assert max(abs(got[k] - want[k]) / abs(want[k]) for k in want) <= TRAIN_TOL["loss_rel"]
    norm = _grad_norm(cpu_models[0])
    assert abs(_grad_norm(card_models[0]) - norm) / norm <= TRAIN_TOL["grad_norm_rel"]
    worst, share = _update_gap(card_models, cpu_models)
    assert worst <= 2.01 * LR and share <= TRAIN_TOL["update_share"]


# the single-pass bf16 analysis (stft(method="matmul_bf16")): on the card
# against the CPU on the same bf16 operands, fp32 sums in other orders (1e-5
# of the spectrum's scale); against the card's fp32 spectrum more than fp32
# rounding and less than the two bf16 roundings of frames and matrices
# (tests/test_torch_parallel.py)
BF16_STFT_TOL = {"card_vs_cpu_rel": 1e-5, "vs_fp32_min": 1e-6, "vs_fp32_max": 2.0 ** -8}


def test_bf16_analysis_on_card_matches_cpu(cuda, zoo_sources):
    """The bf16 analysis at the main path's window and hop (2048 / 512) on 4
    clips of 5 s: complex64 of the fp32 STFT's shape, finite, within
    ``BF16_STFT_TOL``; ``MelSpectrogramLoss`` + ``MultiScaleSTFTLoss`` with
    it on 2 x 16,896 samples: the value within 1e-4 and the input's gradient
    norm within 1e-3 (``TRAIN_TOL``) of the CPU's, both finite."""
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch.metrics.spectral import MelSpectrogramLoss, MultiScaleSTFTLoss

    x = _fixture_clips(zoo_sources, 4, 220_500)[:, 0]
    spec = PF.stft(x.to(cuda), 2048, 512, method="matmul_bf16")
    spec32 = PF.stft(x.to(cuda), 2048, 512, method="matmul")
    assert spec.shape == spec32.shape == (4, 1025, 1 + 220_500 // 512)
    assert spec.dtype == torch.complex64 and bool(torch.isfinite(torch.view_as_real(spec)).all())
    assert _rel_err(spec, PF.stft(x, 2048, 512, method="matmul_bf16")) < BF16_STFT_TOL[
        "card_vs_cpu_rel"]
    vs_fp32 = float((spec - spec32).abs().max()) / float(spec32.abs().max())
    assert BF16_STFT_TOL["vs_fp32_min"] < vs_fp32 < BF16_STFT_TOL["vs_fp32_max"]

    def loss_and_grad(audio):
        est = audio.detach().clone().requires_grad_(True)
        ref = audio.detach().flip(0)
        with strict_fp32():
            loss = (MelSpectrogramLoss(stft_method="matmul_bf16")(AudioSignal(est, SR),
                                                                  AudioSignal(ref, SR))
                    + MultiScaleSTFTLoss(stft_method="matmul_bf16")(AudioSignal(est, SR),
                                                                    AudioSignal(ref, SR)))
            loss.backward()
        return float(loss.detach()), est.grad

    audio = _fixture_clips(zoo_sources, 2, 16_896)
    card_loss, card_grad = loss_and_grad(audio.to(cuda))
    cpu_loss, cpu_grad = loss_and_grad(audio)
    assert np.isfinite(card_loss) and bool(torch.isfinite(card_grad).all())
    assert abs(card_loss - cpu_loss) / abs(cpu_loss) <= TRAIN_TOL["loss_rel"]
    norm = float(cpu_grad.norm())
    assert abs(float(card_grad.norm()) - norm) / norm <= TRAIN_TOL["grad_norm_rel"]


def _interpreted(name, audio):
    """The route that takes the interpreter-mode ``name`` on ``audio`` (B, T)
    and its kernel's plain version called directly on the same input."""
    rate, taps = 2.0 ** (-2.0 / 12.0), PL._composed_fir_on(SR, "K-weighting", 512, audio.device)
    spec = PF.stft(audio, 2048, 512, method="matmul")
    n = spec.shape[-1]
    if name == "pallas_interpret":
        return (PL.apply_k_weighting(audio, SR, use_fir=True, conv_method=name),
                HK.fir_causal_plain(audio, taps))
    if name == "phasor_fused_interpret":
        return (PS.phase_vocoder(spec, rate, 512, 2048, formulation=name),
                HK.phase_vocoder_fused_plain(spec, *PS._pv_indices(n, rate)))
    (w,) = PF._on_device(PF._synthesis_design, ("hann", 2048, 512), audio.device)
    (env,) = PF._on_device(PF._inverse_envelope, ("hann", 2048, 512, n), audio.device)
    length = audio.shape[-1]
    return (PF.istft(spec, 2048, 512, length=length, method=name),
            HK.istft_synthesis_fused_plain(spec.transpose(-1, -2), w, 512, env)[
                :, 1024:1024 + length])


@pytest.mark.parametrize("name", ["pallas_interpret", "phasor_fused_interpret",
                                  "matmul_bf16_fused_interpret"])
def test_interpreter_mode_names_on_card_run_the_plain_versions(cuda, zoo_sources, name):
    """The JAX package's interpreter-mode names on card tensors (2 clips of
    1 s): the route computes on the card, launches no kernel, and gives its
    kernel's plain version's bits."""
    audio = _fixture_clips(zoo_sources, 2, SR)[:, 0].to(cuda)
    before = dict(HK.LAUNCHES)
    got, want = _interpreted(name, audio)
    torch.cuda.synchronize()
    assert HK.LAUNCHES == before
    assert got.device.type == "cuda" and torch.equal(got, want)


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


@pytest.mark.parametrize("preset", ["MP3", "Vorbis", "Ogg", "8-bit"])
def test_file_codec_presets_on_card_equal_cpu(cuda, preset):
    """MP3 and Vorbis get the same bytes from a card signal as from a host
    one: the card's result is the CPU's, to the bit, and on the card. The
    8-bit preset is mu-law on the device: held as the zoo's quantizers."""
    from audiotools_tpu_torch import AudioSignal

    if not _codec_present(preset):
        pytest.skip(f"no system library for {preset}")
    x = _codec_input()
    card = AudioSignal(x, 44100, device=cuda).apply_codec(preset)
    cpu = AudioSignal(x, 44100, device="cpu").apply_codec(preset)
    assert card.device.type == "cuda" and card.signal_length == x.shape[-1]
    if preset == "8-bit":
        diff = (card.audio_data.cpu() - cpu.audio_data).abs()
        assert float((diff > ZOO_ABS).float().mean()) <= ZOO_SHARE
    else:
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


def _quantized(x, subtype):
    """What a lossless file of ``subtype`` holds for float32 ``x``."""
    if subtype == "FLOAT":
        return x
    scale = float(1 << (23 if subtype == "PCM_24" else 15))
    return (np.clip(np.rint(x.astype(np.float64) * scale), -scale, scale - 1) / scale).astype(
        np.float32)


@pytest.mark.parametrize("suffix,subtype", [(".wav", "PCM_16"), (".wav", "FLOAT"),
                                            (".flac", "PCM_16"), (".flac", "PCM_24"),
                                            (".mp3", None), (".ogg", None), (".m4a", None)])
def test_every_format_loads_onto_the_card(cuda, tmp_path, suffix, subtype):
    """A card signal written in each format reads back onto the card (its
    default device) as the host decodes the file, a lossless file as the
    quantization of the source; ``AudioDataset`` -> ``DataLoader`` stages the
    host's decode onto the card bit for bit; no kernel is launched."""
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch import io as pio
    from audiotools_tpu_torch import native
    from audiotools_tpu_torch.data import DataLoader
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader

    if suffix in (".mp3", ".ogg") and not _codec_present({".mp3": "MP3", ".ogg": "Ogg"}[suffix]):
        pytest.skip(f"no system library for {suffix}")
    if suffix == ".m4a" and not native.av_available():
        pytest.skip("no libav")
    x = _codec_input(9, batch=1)
    before = dict(HK.LAUNCHES)
    AudioSignal(x, 44100, device=cuda).write(tmp_path / f"a{suffix}",
                                             **({"subtype": subtype} if subtype else {}))
    sig = AudioSignal(tmp_path / f"a{suffix}")  # the card by default
    data, sr = pio.load_audio(tmp_path / f"a{suffix}")
    assert sig.device.type == "cuda" and sr == sig.sample_rate == 44100
    assert torch.equal(sig.audio_data[0].cpu(), torch.from_numpy(data))
    if subtype is not None:
        assert np.array_equal(data, _quantized(x[0], subtype))
    ds = AudioDataset(AudioLoader(sources=[str(tmp_path)], ext=[suffix]), sample_rate=44100,
                      n_examples=2, duration=0.5)
    batch = next(iter(DataLoader(ds, batch_size=2, num_workers=2)))["signal"]
    assert batch.device.type == "cuda"
    assert torch.equal(batch.audio_data.cpu(),
                       AudioDataset.collate([ds[i] for i in range(2)])["signal"].audio_data)
    assert HK.LAUNCHES == before


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
    assert float((lufs - sig.clone().loudness()).abs().max()) <= 0.2
    resampled = sig.clone().ffmpeg_resample(16000)
    assert resampled.device.type == "cuda"
    assert torch.equal(resampled.audio_data, sig.clone().resample(16000).audio_data)
    via = AudioSignal.load_from_file_with_ffmpeg(tmp_path / "0.wav")
    assert via.device.type == "cuda"
    assert torch.equal(via.audio_data, AudioSignal(tmp_path / "0.wav").audio_data)


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
    """The JAX package's pins: FIR 1e-4, resample 1e-6; the sharded ops
    launch no kernel."""
    from audiotools_tpu_torch.ops import resample as PRS
    from audiotools_tpu_torch.parallel import sharded_fir_conv, sharded_resample

    x = _long().cuda()
    h = torch.from_numpy(PL._exact_fir(44100, "K-weighting")).cuda()
    before = dict(HK.LAUNCHES)
    fir = sharded_fir_conv(_sharded(x, sp_mesh), h, sp_mesh).to_local()
    got = sharded_resample(_sharded(x, sp_mesh), 44100, 16000, sp_mesh).to_local()
    torch.cuda.synchronize()
    assert HK.LAUNCHES == before
    assert float((fir - PFL.causal_fft_conv1d(x, h)).abs().max()) < 1e-4
    want = PRS.resample(x, 44100, 16000)
    assert got.shape == want.shape and float((got - want).abs().max()) < 1e-6


def test_sharded_stft_round_trip_on_card_equals_local(sp_mesh):
    """STFT 1e-5 of its scale, iSTFT 1e-5, round trip 1e-4 (hop = window / 2:
    one shard refuses a smaller hop, as the JAX package's geometry does); no
    kernel launched."""
    from audiotools_tpu_torch.parallel import sharded_istft, sharded_stft

    x = _long()[:, 0, :440320].cuda().contiguous()  # 215 hops of 2048
    before = dict(HK.LAUNCHES)
    spec, n_valid = sharded_stft(_sharded(x, sp_mesh), 2048, 1024, sp_mesh)
    y = sharded_istft(spec, 2048, 1024, sp_mesh, n_valid=n_valid).to_local()
    torch.cuda.synchronize()
    assert HK.LAUNCHES == before
    want = PF.stft(x, 2048, 1024)
    got = spec.to_local()[..., :n_valid]
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    assert float((y - PF.istft(want, 2048, 1024, length=x.shape[-1])).abs().max()) < 1e-5
    assert float((y - x).abs().max()) < 1e-4
    with pytest.raises(ValueError, match="narrow"):
        sharded_stft(_sharded(x, sp_mesh), 2048, 512, sp_mesh)


def test_sharded_loudness_and_signal_mesh_methods_on_card(sp_mesh):
    """The sharded meter, which launches no kernel, equals the exact
    single-device meter (1e-5 LU) and, within the signal API's 1e-3 LU, the
    FIR meter of ``set_fast_meter(True)`` (through kernel C; it truncates
    each stage to 512 taps); the signal's ``mesh=`` methods equal their
    single-device ones (the JAX package's signal-API pins, 1e-3 LU and
    1e-4)."""
    from audiotools_tpu_torch import AudioSignal
    from audiotools_tpu_torch.parallel import shard_signal, sharded_loudness

    x = _long(seed=1).cuda()
    x[..., 100000:200000] *= 1e-3
    before = dict(HK.LAUNCHES)
    got = sharded_loudness(_sharded(x, sp_mesh), 44100, sp_mesh).to_local()
    torch.cuda.synchronize()
    assert HK.LAUNCHES == before
    assert float((got - PL.loudness(x, 44100, use_fir=False)).abs().max()) < 1e-5
    with meter(True):
        fir_meter = PL.loudness(x, 44100)
    assert HK.LAUNCHES["fir_causal"] == before["fir_causal"] + 1
    assert float((got - fir_meter).abs().max()) < 1e-3
    sig = shard_signal(AudioSignal(x.clone(), 44100), sp_mesh)
    ref = AudioSignal(x.clone(), 44100)
    assert float((sig.loudness(mesh=sp_mesh).to_local() - ref.loudness()).abs().max()) < 1e-3
    sig.resample(22050, mesh=sp_mesh)
    ref.resample(22050)
    assert float((sig.audio_data.to_local() - ref.audio_data).abs().max()) < 1e-4


def test_model_parallel_step_on_card_equals_unsharded(sp_mesh, tmp_path):
    """Phase 17's path at a small width on the one-rank nccl group: the tiny
    DAC and Discriminator through ``shard_params`` on a ``{"dp": 1, "tp":
    1}`` mesh (no data-axis hooks at one data rank), one reconstruction and
    one adversarial step inside ``strict_fp32`` against the unsharded steps
    from the same weights (the losses, and the parameters after the update
    within ``TRAIN_TOL``), only kernel G launched, once backward for every
    forward; and the sharded state of both nets and both optimizers through
    ``Checkpointer`` into fresh sharded models, bit for bit with its
    placements."""
    from audiotools_tpu_torch.ml.checkpoint import Checkpointer
    from audiotools_tpu_torch.models import DAC, Discriminator
    from audiotools_tpu_torch.models.adversarial import make_adversarial_train_step
    from audiotools_tpu_torch.models.train import make_train_step, shard_params
    from audiotools_tpu_torch.ops._fp32 import strict_fp32
    from audiotools_tpu_torch.parallel import make_mesh
    from audiotools_tpu_torch.parallel import tensor as PTT

    mesh = make_mesh({"dp": 1, "tp": 1})
    dev = torch.device("cuda", torch.cuda.current_device())
    x = _long(seconds=0.2, seed=4)[:, :1].to(dev)  # (1, 1, 8820)

    def adamw(m):
        return torch.optim.AdamW(m.parameters(), lr=1e-4, weight_decay=1e-4)

    def nets(seed=0, sharded=True):
        g = DAC(**SERVING_TINY, seed=seed).to(dev)
        d = Discriminator(periods=(2, 3), fft_sizes=(256, 128), mpd_channels=(4, 8),
                          mrd_channels=4, seed=seed + 1).to(dev)
        return (shard_params(g, mesh), shard_params(d, mesh)) if sharded else (g, d)

    with strict_fp32():
        losses, stepped = {}, {}
        for sharded in (True, False):
            before = dict(HK.LAUNCHES)
            g, d = nets(sharded=sharded)
            if sharded:
                assert sum(len(PTT.placement(m).handles) for m in (g, d)) == 0
            rec = make_train_step(g, adamw(g), 16000)(x)
            stepped[sharded] = [g]
            g, d = nets(sharded=sharded)
            adv = make_adversarial_train_step(g, d, adamw(g), adamw(d), 16000)(x)
            stepped[sharded] += [g, d]
            losses[sharded] = [float(rec["loss"]), float(adv["loss"]),
                               float(adv["loss/discriminator"])]
            launched = {k: HK.LAUNCHES[k] - before[k] for k in before}
            assert launched.pop("snake") == launched.pop("snake_backward") > 0
            assert not any(launched.values())
        np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)
        worst, share = _update_gap(stepped[True], stepped[False])
        assert worst <= 2.01 * LR and share <= TRAIN_TOL["update_share"]
        g, d = nets()
        opts = {"g": adamw(g), "d": adamw(d)}
        make_adversarial_train_step(g, d, opts["g"], opts["d"], 16000)(x)
        ck = Checkpointer(tmp_path / "ck")
        ck.save(1, {"g": g, "d": d}, opts)
        g2, d2 = nets(seed=5)
        opts2 = {"g": adamw(g2), "d": adamw(d2)}
        ck.restore(template={"params": {"g": g2, "d": d2}, "opt_state": opts2})
    for a, b in ((g, g2), (d, d2)):
        for p, q in zip(a.parameters(), b.parameters()):
            assert q.placements == p.placements and q.device == p.device
            assert torch.equal(p.full_tensor(), q.full_tensor())
    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    for k in opts:
        for s1, s2 in zip(opts[k].state.values(), opts2[k].state.values()):
            assert s1.keys() == s2.keys()
            assert all(torch.equal(full(s1[n]), full(s2[n])) for n in s1), k
            assert s2["exp_avg"].placements == s1["exp_avg"].placements


def test_codec_example_runs_on_card(cuda, tmp_path):
    """``examples/codec.py --toy`` compresses and decompresses 1 s on the
    card; the DAC's Snakes (kernel G) are the only kernel launched."""
    from audiotools_tpu_torch.examples import codec
    from audiotools_tpu_torch.io import read_wav, write_wav

    write_wav(tmp_path / "in.wav", _long(seconds=1.0)[0, :1].numpy(), 44100)
    before = dict(HK.LAUNCHES)
    art = codec.main(["compress", str(tmp_path / "in.wav"), str(tmp_path / "c.npz"), "--toy"])
    recon = codec.main(["decompress", str(tmp_path / "c.npz"), str(tmp_path / "out.wav"), "--toy"])
    torch.cuda.synchronize()
    assert recon.device.type == "cuda" and art["codes"].shape[:2] == (1, 4)
    data, sr = read_wav(tmp_path / "out.wav")
    assert sr == 44100 and data.shape == (1, 44100) and np.isfinite(data).all()
    launched = {k: HK.LAUNCHES[k] - before[k] for k in before}
    assert launched["snake"] > 0 and not any(v for k, v in launched.items() if k != "snake")


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


MP_WORKER = r"""
import datetime, json, sys, time
import torch
import torch.distributed as dist

rank, world, address, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dev = torch.device("cuda", rank)
torch.cuda.set_device(dev)
dist.init_process_group("nccl", init_method=address, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=300), device_id=dev)
from audiotools_tpu_torch.ml.checkpoint import Checkpointer
from audiotools_tpu_torch.models import DAC, Discriminator
from audiotools_tpu_torch.models.adversarial import make_adversarial_train_step
from audiotools_tpu_torch.models.train import make_train_step, shard_params
from audiotools_tpu_torch.ops._fp32 import strict_fp32
from audiotools_tpu_torch.parallel import make_mesh

# tests/parallel/test_sharded_training.py's models and batch, and the full width
TINY = (dict(encoder_dim=8, encoder_rates=(2, 2), latent_dim=16, decoder_dim=32, n_codebooks=2,
             codebook_size=32, codebook_dim=4, sample_rate=16000),
        dict(periods=(2, 3), fft_sizes=(256, 128), mpd_channels=(4, 8), mrd_channels=4))
FULL = ({}, {})


def audio(batch, t, seed):  # the same batch on every card
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(batch, 1, t, generator=g, device=dev) * 0.1


def adamw(m, lr):
    return torch.optim.AdamW(m.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def nets(cfg, mesh, seed=0):
    g, d = DAC(**cfg[0], seed=seed).to(dev), Discriminator(**cfg[1], seed=seed + 1).to(dev)
    if mesh is not None:
        shard_params(g, mesh)
        shard_params(d, mesh)
    return g, d


class Bytes:
    # bytes each rank receives through the layers' collectives (from the shapes)
    def __init__(self):
        self.n = {"all_gather": 0, "all_reduce": 0, "calls": 0}
        self.real = {k: getattr(dist, k) for k in ("all_gather", "all_reduce")}

        def gather(parts, t, group=None, **kw):
            self.n["all_gather"] += (len(parts) - 1) * t.numel() * t.element_size()
            self.n["calls"] += 1
            return self.real["all_gather"](parts, t, group=group, **kw)

        def reduce(t, op=dist.ReduceOp.SUM, group=None, **kw):
            n = dist.get_world_size(group)
            self.n["all_reduce"] += 2 * (n - 1) * t.numel() * t.element_size() // n
            self.n["calls"] += 1
            return self.real["all_reduce"](t, op=op, group=group, **kw)

        dist.all_gather, dist.all_reduce = gather, reduce


counts = Bytes()


def legs(cfg, x, mesh, sr, key):
    # dryrun_multichip's legs: a step, step 2 direct and after save/restore, adversarial
    g, _ = nets(cfg, mesh)
    opt = adamw(g, 1e-3)
    step = make_train_step(g, opt, sr)
    out = {"loss1": float(step(x)["loss"])}
    if mesh is not None:
        ck = Checkpointer(f"{tmp}/ck_{key}")
        ck.save(1, g, opt)
        out["direct"] = float(step(x)["loss"])
        g2, _ = nets(cfg, mesh, seed=5)
        opt2 = adamw(g2, 1e-3)
        ck.restore(template={"params": g2, "opt_state": opt2})
        out["restored"] = float(make_train_step(g2, opt2, sr)(x)["loss"])
    g, d = nets(cfg, mesh)
    m = make_adversarial_train_step(g, d, adamw(g, 1e-4), adamw(d, 1e-4), sr)(x)
    out["adv"] = [float(m["loss"]), float(m["loss/discriminator"])]
    return out


def device_split(step, x):
    # one more step under torch.profiler: device ms in NCCL's kernels and in all
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1000
    nccl = sum(e.self_device_time_total for e in kernels if "nccl" in e.key.lower()) / 1000
    return {"busy_ms": busy, "nccl_ms": nccl, "kernels": sum(e.count for e in kernels)}


def timed(label, cfg, x, mesh, n=4):
    g, d = nets(cfg, mesh)  # mesh None: one card, unsharded
    if label == "reconstruction":
        step = make_train_step(g, adamw(g, 1e-4), 44100)
    else:
        step = make_adversarial_train_step(g, d, adamw(g, 1e-4), adamw(d, 1e-4), 44100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(x)  # untimed
    torch.cuda.synchronize()
    dist.barrier()  # every rank starts its clock together
    before = dict(counts.n)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n - 1):
        m = step(x)
    end.record()
    end.synchronize()
    per = {k: (counts.n[k] - before[k]) / (n - 1) for k in before}
    return {"ms": start.elapsed_time(end) / (n - 1), "peak_gib": torch.cuda.max_memory_allocated()
            / 2**30, "loss": float(m["loss"]), "per_step": per, **device_split(step, x)}


res = {"rank": rank}
shapes = [(dp, world // dp) for dp in range(world, 0, -1) if world % dp == 0]
x = audio(8, 256, 0)
t0 = time.perf_counter()
with strict_fp32():
    if rank == 0:
        res["tiny one card"] = legs(TINY, x, None, 16000, "one")
    for dp, tp in shapes:
        mesh = make_mesh({"dp": dp, "tp": tp})
        mine = x.chunk(dp)[mesh.get_local_rank("dp")]
        res[f"tiny {dp}x{tp}"] = legs(TINY, mine, mesh, 16000, f"{dp}x{tp}")
x = audio(16, 33 * 512, 1)
with strict_fp32():
    if rank == 0:
        g, _ = nets(FULL, None)
        res["full one card"] = float(make_train_step(g, adamw(g, 1e-4), 44100)(x)["loss"])
        del g
for label in ("reconstruction", "adversarial"):  # every card alone, unsharded, at once
    res[f"one card {label}"] = timed(label, FULL, x, None)
    torch.cuda.empty_cache()
for dp, tp in [(dp, tp) for dp, tp in shapes if tp > 1 and dp <= 2]:
    mesh = make_mesh({"dp": dp, "tp": tp})
    mine = x.chunk(dp)[mesh.get_local_rank("dp")]
    with strict_fp32():
        g, _ = nets(FULL, mesh)
        loss = float(make_train_step(g, adamw(g, 1e-4), 44100)(mine)["loss"])
        del g
    res[f"full {dp}x{tp}"] = {"loss1": loss, **{label: timed(label, FULL, mine, mesh)
                                                for label in ("reconstruction", "adversarial")}}
    torch.cuda.empty_cache()
res["seconds"] = time.perf_counter() - t0
json.dump(res, open(f"{tmp}/{rank}.json", "w"))
dist.destroy_process_group()
"""


def test_model_parallel_over_every_card(cuda, tmp_path):
    """One nccl rank a card, ``dryrun_multichip``'s training legs on every
    mesh the card count allows ((4, 1), (2, 2), (1, 4) on four): the tiny
    DAC's (dp, tp) reconstruction step against one card (1e-5, strict fp32),
    step 2 equal directly and after save and restore, the adversarial step
    (2e-4); then ``DAC()`` + ``Discriminator()`` at 16 x 16,896 on the
    meshes with a tensor axis and at most two data ranks: the first step's
    loss against one card (1e-4, strict fp32), ms/step at default TF32 and
    the bytes each rank receives through the collectives a step, beside
    every card's unsharded step at the same time (printed).
    Needs two cards or more, and skips on one."""
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
    procs = [subprocess.Popen([sys.executable, "-c", MP_WORKER, str(r), str(world), address,
                               str(tmp_path)], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    got = [json.loads((tmp_path / f"{r}.json").read_text()) for r in range(world)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    for r in got:
        print(json.dumps(r))
    ref = got[0]["tiny one card"]
    for key in [k for k in got[0] if k.startswith("tiny ") and k != "tiny one card"]:
        for r in got:
            legs = r[key]
            assert abs(legs["loss1"] - ref["loss1"]) / ref["loss1"] < 1e-5, (key, legs)
            assert legs["direct"] == legs["restored"], (key, legs)
            np.testing.assert_allclose(legs["adv"], ref["adv"], rtol=2e-4)
    full = got[0]["full one card"]
    for key in [k for k in got[0] if k.startswith("full ") and k != "full one card"]:
        for r in got:
            assert abs(r[key]["loss1"] - full) / full < 1e-4, (key, r[key]["loss1"], full)
            assert all(np.isfinite(r[key][label]["ms"])
                       for label in ("reconstruction", "adversarial"))

