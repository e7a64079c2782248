"""The port's performance accounting (``audiotools_tpu_torch/ops/perf.py``)
against the JAX package's (``audiotools_tpu/ops/perf.py``) on the CPU.

The analytic counters are integer arithmetic and must return the JAX
package's integers exactly. ``FlopCounterMode`` over the port's modules
checks that they describe the modules: the generator and the MPD exactly;
the MRD's convolutions within 2% (the counter takes the summed band widths
as F, F/2, F/4, F/8, which approximates the real bands: 1.4% under the
count at 16,896 samples, the JAX package's convention). ``xla_cost`` counts
what a call dispatches; of a matmul it equals the JAX package's XLA count,
and a kernel wrapper counts as its registered work, whichever version runs.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores
from torch.utils.flop_counter import FlopCounterMode

from audiotools_tpu.ops import perf as JP
from audiotools_tpu_torch.models import DAC, Discriminator
from audiotools_tpu_torch.ops import fft as PF
from audiotools_tpu_torch.ops import hopper_kernels as HK
from audiotools_tpu_torch.ops import perf as PP
from audiotools_tpu_torch.ops import stretch as PS

# tests/test_perf_accounting.py's small generator
SMALL = dict(encoder_dim=16, encoder_rates=(2, 4, 8, 8), latent_dim=32, decoder_dim=128,
             n_codebooks=2, codebook_size=64, codebook_dim=4)
CONFIGS = {"default": {}, "small": SMALL}
LENGTHS = [4096, 16896, 44100]
# the ratio of the port's ceilings to the JAX package's (H100 over v5e)
RATIO_FLOPS = JP.PEAK_BF16_FLOPS / PP.PEAK_BF16_FLOPS
RATIO_BYTES = JP.HBM_BYTES_PER_S / PP.HBM_BYTES_PER_S


def _audio(*shape, seed=0):
    return torch.from_numpy((np.random.RandomState(seed).randn(*shape) * 0.1).astype(np.float32))


def _fft_macs(T, fft_sizes=(2048, 1024, 512)):
    """The MRD counter's STFT term (``mrd_macs``'s 5 N log2 N convention)."""
    return sum(int((T // (n // 4) + 1) * 5 * n * math.log2(n)) // 2 for n in fft_sizes)


# ---------------------------------------------------------------------------
# the analytic counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("T", LENGTHS)
def test_generator_macs_equal_jax(T, config):
    kw = CONFIGS[config]
    assert PP.dac_generator_macs(T, **kw) == JP.dac_generator_macs(T, **kw)
    assert PP.dac_train_step_flops(16, T, **kw) == JP.dac_train_step_flops(16, T, **kw)


@pytest.mark.parametrize("periods", [(2, 3, 5, 7, 11), (2,), (11,)])
@pytest.mark.parametrize("T", LENGTHS)
def test_mpd_macs_equal_jax(T, periods):
    assert PP.mpd_macs(T, periods=periods) == JP.mpd_macs(T, periods=periods)


@pytest.mark.parametrize("fft_sizes", [(2048, 1024, 512), (512,), (2048,)])
@pytest.mark.parametrize("T", LENGTHS)
def test_mrd_macs_equal_jax(T, fft_sizes):
    assert PP.mrd_macs(T, fft_sizes=fft_sizes) == JP.mrd_macs(T, fft_sizes=fft_sizes)


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("T", LENGTHS)
def test_adversarial_step_flops_equal_jax(T, batch):
    assert PP.adversarial_train_step_flops(batch, T) == JP.adversarial_train_step_flops(batch, T)


def test_conv_macs_equal_jax():
    for args in [(100, 1, 64, 7), (33, 1024, 512, 16), (1, 1, 1, 1)]:
        assert PP._conv_macs(*args) == JP._conv_macs(*args)
        assert PP._conv_transpose_macs(*args) == JP._conv_transpose_macs(*args)


def test_ceilings_are_the_h100s():
    """H100 SXM5 80GB: dense bf16 on the tensor cores, HBM3."""
    assert PP.PEAK_BF16_FLOPS == 989e12
    assert PP.HBM_BYTES_PER_S == 3.35e12


# ---------------------------------------------------------------------------
# the counters against the port's modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_generator_forward_flops_are_twice_the_macs(config):
    kw = CONFIGS[config]
    model = DAC(**kw).eval()
    audio = _audio(1, 1, 4096)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(audio)
    analytic = 2 * sum(PP.dac_generator_macs(4096, **kw).values())
    assert counter.get_total_flops() == analytic
    with torch.no_grad():
        assert PP.xla_cost(model, audio)["flops"] == analytic


@pytest.fixture(scope="module")
def discriminator():
    return Discriminator().eval()


@pytest.mark.parametrize("T", [4096, 16896])
def test_mpd_flops_are_twice_the_macs(discriminator, T):
    x = _audio(1, T, seed=1)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        for head in discriminator.mpd:
            head(x)
    assert counter.get_total_flops() == 2 * PP.mpd_macs(T)


@pytest.mark.parametrize("T", [4096, 16896])
def test_mrd_convolutions_within_two_percent_of_the_macs(discriminator, T):
    """The convolutions' count exceeds the analytic count without its FFT
    term by 1.4% (the band-width approximation); the STFT runs as a matmul
    (``bmm``), which the analytic count takes at the FFT's 5 N log2 N."""
    x = _audio(1, T, seed=2)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        for head in discriminator.mrd:
            head(x)
    counts = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    convs = counts.pop("aten.convolution")
    assert set(counts) == {"aten.bmm"}
    analytic = 2 * (PP.mrd_macs(T) - _fft_macs(T))
    assert 0.013 < convs / analytic - 1 < 0.02


# ---------------------------------------------------------------------------
# xla_cost
# ---------------------------------------------------------------------------


def test_xla_cost_of_a_matmul_equals_jax():
    rng = np.random.RandomState(3)
    a = rng.randn(64, 128).astype(np.float32)
    b = rng.randn(128, 32).astype(np.float32)
    want = JP.xla_cost(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    got = PP.xla_cost(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    assert got == want == {"flops": 2.0 * 64 * 128 * 32, "bytes": 4.0 * (64 * 128 + 128 * 32
                                                                         + 64 * 32)}


def test_xla_cost_of_the_small_generator_lies_in_the_jax_band():
    """tests/test_perf_accounting.py's band around the analytic core."""
    model = DAC(**SMALL).eval()
    analytic = 2 * sum(PP.dac_generator_macs(4096, **SMALL).values())
    with torch.no_grad():
        cost = PP.xla_cost(lambda a: model(a)["audio"], _audio(1, 1, 4096))
    assert 0.7 * analytic <= cost["flops"] <= 3.0 * analytic
    assert cost["bytes"] > 0


def test_xla_cost_of_a_training_step_covers_the_analytic_core():
    """Forward, both backward convolutions, the losses' matmul STFTs and
    AdamW: at least the analytic core, at most 3x it."""
    from audiotools_tpu_torch.models.train import make_train_step

    model = DAC(**SMALL)
    step = make_train_step(model, torch.optim.AdamW(model.parameters(), 1e-4), 44100)
    cost = PP.xla_cost(step, _audio(2, 1, 8192))
    analytic = PP.dac_train_step_flops(2, 8192, **SMALL)
    assert analytic <= cost["flops"] <= 3.0 * analytic


def test_xla_cost_counts_views_and_allocations_as_nothing():
    a = torch.ones(8, 16)
    assert PP.xla_cost(lambda x: (x.T, x[:, :4], x.reshape(16, 8), torch.empty(100)), a) == {
        "flops": 0.0, "bytes": 0.0}
    # an elementwise op reads its input and writes its output once; a
    # broadcast input is read once
    assert PP.xla_cost(lambda x: x * 2.0, a) == {"flops": 0.0, "bytes": 2 * 4.0 * 128}
    b = torch.ones(16)
    assert PP.xla_cost(lambda x, y: x + y.expand(8, 16), a, b)["bytes"] == 4.0 * (128 + 16 + 128)


def test_xla_cost_raises_where_the_jax_version_returned_zeros():
    def broken(x):
        raise RuntimeError("nothing to count")

    with pytest.raises(RuntimeError, match="nothing to count"):
        PP.xla_cost(broken, torch.ones(3))
    # the counting mode is gone afterwards
    assert PP._active_count() is None
    assert PP.xla_cost(lambda x: x + 1, torch.ones(3))["bytes"] == 24.0


def _kernel_cases():
    """Each wrapper with its plain version and small CPU inputs."""
    rng = np.random.RandomState(4)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    z = torch.from_numpy((rng.randn(2, 1, 65, 37) + 1j * rng.randn(2, 1, 65, 37))
                         .astype(np.complex64))
    ang, seed = rng.uniform(-3, 3, (5, 40)), rng.uniform(-3, 3, 5)
    planes = tuple(torch.from_numpy(np.asarray(p, np.float32))
                   for p in (np.cos(ang), np.sin(ang), np.cos(seed), np.sin(seed)))
    n_fft, hop, nt = 512, 128, 20
    spec = torch.from_numpy(((rng.randn(2, nt, n_fft // 2 + 1)
                              + 1j * rng.randn(2, nt, n_fft // 2 + 1)) * 0.1).astype(np.complex64))
    (w,) = PF._on_device(PF._synthesis_design, ("hann", n_fft, hop), "cpu")
    (env,) = PF._on_device(PF._inverse_envelope, ("hann", n_fft, hop, nt + 4), "cpu")
    return {
        "fir_causal_batch": (HK.fir_causal_batch, HK.fir_causal_batch_plain,
                             (randn(3, 1000), randn(3, 31, scale=0.05)), {}),
        "phase_vocoder_fused": (HK.phase_vocoder_fused, HK.phase_vocoder_fused_plain,
                                (z, *PS._pv_indices(37, 2 ** (-2 / 12))), {"with_phasor": True}),
        "fir_causal": (HK.fir_causal, HK.fir_causal_plain,
                       (randn(2, 3, 500), randn(63, scale=0.05)), {}),
        "rotation_cumprod": (HK.rotation_cumprod, HK.rotation_cumprod_plain, planes, {}),
        "istft_synthesis_fused": (HK.istft_synthesis_fused, HK.istft_synthesis_fused_plain,
                                  (spec, w, hop, env, 2), {}),
        "iir_block_scan": (HK.iir_block_scan, HK.iir_block_scan_plain,
                           (randn(3, 20, 4), randn(4, 4, scale=0.3)), {}),
        "snake": (HK.snake, HK.snake_plain, (randn(2, 3, 37), randn(1, 3, 1) ** 2), {}),
        "snake_backward": (HK.snake_backward, HK.snake_backward_plain,
                           (randn(2, 3, 37), randn(1, 3, 1) ** 2, randn(2, 3, 37)), {}),
    }


@pytest.mark.parametrize("name", sorted(HK.LAUNCHES))
def test_kernel_wrapper_counts_its_registered_work(name):
    """On the CPU a wrapper runs its plain version and counts as its
    function's own work, not as the plain version's operators."""
    wrapper, plain, args, kwargs = _kernel_cases()[name]
    work = wrapper.work(*args, **kwargs)
    assert PP.xla_cost(lambda *a: wrapper(*a, **kwargs), *args) == work
    assert PP.xla_cost(lambda *a: plain(*a, **kwargs), *args) != work
    assert work["flops"] > 0 and work["bytes"] > 0
    # nested in a larger program, the work is added once
    twice = PP.xla_cost(lambda *a: (wrapper(*a, **kwargs), wrapper(*a, **kwargs)), *args)
    assert twice == {k: 2 * v for k, v in work.items()}


def test_kernel_work_is_the_bound_of_the_main_path_shapes():
    """The work at the kernel table's shapes, from meta tensors (no data)."""
    meta = {"device": "meta"}
    x, h = torch.empty(64, 220500 + 640, **meta), torch.empty(64, 641, **meta)
    assert HK.fir_causal_batch.work(x, h) == {
        "flops": 2.0 * 64 * 221140 * 641, "bytes": 4.0 * 64 * (2 * 221140 + 641)}
    z = torch.empty(64, 1, 1025, 384, dtype=torch.complex64, **meta)
    rows, n = 64 * 1025, 432
    assert HK.phase_vocoder_fused.work(z, np.zeros(n), None, None) == {
        "flops": 31.0 * rows * n, "bytes": 8.0 * rows * (384 + n) + 12.0 * n}
    ur = torch.empty(rows, n, **meta)
    assert HK.rotation_cumprod.work(ur, ur, ur[:, 0], ur[:, 0]) == {
        "flops": 6.0 * rows * n, "bytes": 4.0 * rows * (4 * n + 2)}
    spec = torch.empty(64, 432, 1025, dtype=torch.complex64, **meta)
    w = torch.empty(2064, 4 * 512, dtype=torch.bfloat16, **meta)
    env = torch.empty(2048 + 512 * 431, **meta)
    assert HK.istft_synthesis_fused.work(spec, w, 512, env) == {
        "flops": 2.0 * 64 * 432 * 2 * 1025 * 2048,
        "bytes": 8.0 * 64 * 432 * 1025 + 2.0 * 2064 * 2048 + 4.0 * 65 * env.numel()}
    u = torch.empty(128, 431, 4, **meta)
    assert HK.iir_block_scan.work(u, torch.empty(4, 4, **meta)) == {
        "flops": 2.0 * 128 * 430 * 4 * 4, "bytes": 4.0 * (2 * 128 * 431 * 4 + 16)}
    # G at the decoder's last Snake of a 30 s codec request
    x, alpha = torch.empty(1, 96, 1_323_008, **meta), torch.empty(1, 96, 1, **meta)
    assert HK.snake.work(x, alpha) == {"flops": 5.0 * 96 * 1_323_008,
                                       "bytes": 4.0 * (2 * 96 * 1_323_008 + 96)}


# ---------------------------------------------------------------------------
# the roofline helpers
# ---------------------------------------------------------------------------


def test_roofline_helpers():
    """tests/test_perf_accounting.py's checks at the port's ceilings."""
    assert PP.mfu(PP.PEAK_BF16_FLOPS, 1.0) == pytest.approx(1.0)
    assert PP.hbm_roofline_frac(PP.HBM_BYTES_PER_S, 1.0) == pytest.approx(1.0)
    out = PP.summarize("x", 0.5, analytic_flops=PP.PEAK_BF16_FLOPS / 4,
                       cost={"flops": PP.PEAK_BF16_FLOPS / 2, "bytes": PP.HBM_BYTES_PER_S})
    assert out == {"mfu": 0.5, "mfu_xla": 1.0, "hbm_frac": 2.0}


@pytest.mark.parametrize("seconds,analytic,cost", [
    (0.158, 2.242e12, {"flops": 2.3e12, "bytes": 9.0e11}),
    (0.4, 5.779e12, {"flops": 5.9e12, "bytes": 0.0}),
    (0.05, None, {"flops": 2.5e10, "bytes": 4.0e9}),
    (0.05, 1e9, None),
])
def test_summarize_has_jax_keys_scaled_by_the_ceilings(seconds, analytic, cost):
    want, got = JP.summarize("x", seconds, analytic, cost), PP.summarize("x", seconds, analytic,
                                                                          cost)
    assert set(got) == set(want)
    if analytic:
        assert PP.mfu(analytic, seconds) == pytest.approx(JP.mfu(analytic, seconds) * RATIO_FLOPS)
    for key, ratio in (("mfu", RATIO_FLOPS), ("mfu_xla", RATIO_FLOPS), ("hbm_frac", RATIO_BYTES)):
        if key in want:
            assert got[key] == pytest.approx(want[key] * ratio, abs=1e-4)


def test_stage_roofline_has_jax_keys_scaled_by_the_ceilings(monkeypatch):
    """Both packages' rows of a matmul stage at one fixed time (each
    package's timer patched to 2 ms): the same keys, bytes and FLOPs, the
    fractions in the ratio of the ceilings."""
    import audiotools_tpu.ops.benchmark as JB
    import audiotools_tpu_torch.ops.benchmark as PB

    monkeypatch.setattr(JB, "device_time", lambda fn, arg, iters=5: 2e-3)
    monkeypatch.setattr(PB, "device_time", lambda fn, arg, iters=5: 2e-3)
    a = np.random.RandomState(5).randn(512, 512).astype(np.float32)
    want = JP.stage_roofline("mm", lambda x: x @ x, jnp.asarray(a))
    got = PP.stage_roofline("mm", lambda x: x @ x, torch.from_numpy(a))
    assert set(got) == set(want) == {"stage", "ms", "gbytes", "hbm_frac", "gflops", "mfu_xla"}
    for key in ("stage", "ms", "gbytes", "gflops"):
        assert got[key] == want[key]
    assert got["hbm_frac"] == pytest.approx(want["hbm_frac"] * RATIO_BYTES, abs=1e-3)
    assert got["mfu_xla"] == pytest.approx(want["mfu_xla"] * RATIO_FLOPS, abs=1e-4)
