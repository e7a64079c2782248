"""The port's device timers (``audiotools_tpu_torch/ops/benchmark.py``), the
counterparts of ``tests/test_benchmark_tools.py``'s timing tests, on the CPU.

The timed programs take milliseconds (a chain of 256 x 256 matmuls on one
host thread, ~3 ms), so the N / 2N difference (~50 ms at 20 calls) stands
well above the host clock's jitter under parallel test workers, and the
assertions read unrounded seconds. The call counts pin the two-point
contract: every call runs (eager PyTorch has nothing to eliminate), a warm
call, then N and 2N calls a pair.
"""
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu_torch.ops import benchmark as B
from audiotools_tpu_torch.ops import perf as PP


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, warmed: the host's first parallel region after
    start-up costs a one-time ~0.3 s that one warm call of a program does
    not always absorb on the CPU (the card's timers have no such pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _op(_matrix())
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _matrix(seed=1, n=256):
    return torch.from_numpy(np.random.RandomState(seed).randn(n, n).astype(np.float32))


def _op(a):
    for _ in range(8):
        a = torch.tanh(a @ a.T) * 0.1
    return a


def test_device_time_two_point_calibration():
    t = B.device_time(_op, _matrix(), iters=20)
    assert 1e-9 < t < 0.05


def test_device_time_accepts_any_output_structure():
    x = _matrix(2)
    t = B.device_time(lambda a: (torch.sum(a), _op(a), {"k": a + 1.0}), x, iters=10)
    assert t > 1e-9


def test_device_time_queued_matches_device_time():
    """The queued method includes each call's dispatch; on a compute-bound
    op the two agree within the JAX test's envelope."""
    x = _matrix(3)
    t_loop = B.device_time(_op, x, iters=20)
    t_q = B.device_time_queued(_op, x, iters=20)
    assert t_q > 1e-9
    assert t_q < t_loop * 5 + 5e-3
    assert t_loop < t_q * 5 + 5e-3


def test_device_time_stats_median_and_spread():
    st = B.device_time_stats(_op, _matrix(4), iters=3, repeats=3)
    assert set(st) == {"seconds", "min", "max", "spread"}
    assert st["min"] <= st["seconds"] <= st["max"]
    assert st["seconds"] >= 1e-9
    assert st["spread"] == round((st["max"] - st["min"]) / st["seconds"], 3) >= 0.0


def test_device_time_queued_default_and_custom_sync():
    x = _matrix(5)
    # default sync: every output tensor summed into the fetched scalar
    assert B.device_time_queued(lambda a: (_op(a), {"x": a + 1.0}), x, iters=2) >= 1e-9
    # custom sync: the extractor maps the output to the fetched scalar
    t = B.device_time_queued(lambda a: {"loss": torch.sum(_op(a)), "aux": a}, x, iters=2,
                             sync=lambda out: out["loss"])
    assert t >= 1e-9


def test_stage_roofline_row():
    x = _matrix(6)
    row = PP.stage_roofline("toy", _op, x, iters=2)
    assert set(row) == {"stage", "ms", "gbytes", "hbm_frac", "gflops", "mfu_xla"}
    assert row["stage"] == "toy" and row["ms"] >= 0.0
    cost = PP.xla_cost(_op, x)
    assert row["gflops"] == round(cost["flops"] / 1e9, 1) == round(8 * 2 * 256 ** 3 / 1e9, 1)
    assert row["gbytes"] == round(cost["bytes"] / 1e9, 3)


@pytest.mark.parametrize("warmup", [True, False])
def test_device_time_runs_every_call(warmup):
    calls = []
    B.device_time(lambda a: calls.append(a), torch.ones(3), iters=4, warmup=warmup)
    assert len(calls) == warmup + 4 + 8


def test_device_time_stats_runs_every_call():
    calls = []
    B.device_time_stats(lambda a: calls.append(a), torch.ones(3), iters=2, repeats=3)
    assert len(calls) == 1 + 3 * (2 + 4)


def test_device_time_queued_fetches_once_a_run():
    calls, fetched = [], []

    def step(a, b):
        calls.append(1)
        return {"loss": (a * b).sum()}

    def sync(out):
        fetched.append(out)
        return out["loss"]

    t = B.device_time_queued(step, torch.ones(3), torch.ones(3), iters=3, sync=sync)
    assert t >= 1e-9
    assert len(calls) == 2 + 3 + 6
    assert len(fetched) == 3


def test_the_clock_follows_the_argument():
    """CUDA events only for an argument on the card (checked on the card in
    tests/test_torch_cuda.py); host tensors, signals and plain values time
    on the host clock."""
    from audiotools_tpu_torch import AudioSignal

    cpu = torch.device("cpu")
    signal = AudioSignal(torch.zeros(1, 1, 100), 44100)
    assert B._device(torch.ones(2)) == cpu
    assert B._device({"signal": signal, "n": 3}) == cpu
    assert B._device((np.zeros(2), [1.0])) == cpu
    meta = torch.empty(2, device="meta")
    assert B._device((meta, torch.ones(1))) == cpu
