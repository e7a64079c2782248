"""Device timing (counterpart of ``audiotools_tpu/ops/benchmark.py``).

Every timer here is two-point: it runs a program N and then 2N times, each
run from an idle queue, and takes the difference over N. The fixed cost of
a run (the first call's launch while the device waits for the host, the
final synchronization) cancels, leaving the time per call in a full queue.
Eager PyTorch runs every call, so nothing needs chaining to stay alive.

The clock follows the device of the argument: CUDA events when a tensor of
it lies on the card (``torch.cuda.Event``), else ``time.perf_counter``.
"""
import time

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["device_time", "device_time_queued", "device_time_stats"]


def _device(arg) -> torch.device:
    """The first CUDA device among the tensors (or objects with a
    ``device``, such as an ``AudioSignal``) in ``arg``; else the CPU."""
    for leaf in tree_leaves(arg):
        device = getattr(leaf, "device", None)
        if isinstance(device, torch.device) and device.type == "cuda":
            return device
    return torch.device("cpu")


def _clock(device):
    """``run(n) -> seconds`` of ``n`` back-to-back calls on ``device``'s clock."""
    if device.type == "cuda":
        def elapsed(call, n):
            torch.cuda.synchronize(device)
            with torch.cuda.device(device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    call()
                end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:
        def elapsed(call, n):
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            return time.perf_counter() - t0
    return elapsed


def _pair(elapsed, call, iters):
    """Seconds per call from one N / 2N pair, floored at 1 ns so jitter on
    near-free ops cannot yield zero (callers divide by the result)."""
    t1 = elapsed(call, iters)
    t2 = elapsed(call, 2 * iters)
    return max((t2 - t1) / iters, 1e-9)


def device_time(fn, arg, iters: int = 10, warmup: bool = True) -> float:
    """Average seconds per evaluation of ``fn(arg)`` on ``arg``'s device:
    after a warm call, CUDA events (or the host clock on the CPU) bracket
    ``iters`` and then ``2 * iters`` back-to-back calls, and the difference
    over ``iters`` is the time per call with the first call's queue fill
    cancelled. ``fn`` may return any structure."""
    elapsed = _clock(_device(arg))

    def call():
        fn(arg)

    if warmup:
        elapsed(call, 1)
    return _pair(elapsed, call, iters)


def device_time_stats(
    fn, arg, iters: int = 10, repeats: int = 5
) -> dict:
    """Median of ``repeats`` two-point timings (:func:`device_time`) after
    one warm call, with ``spread = (max - min) / median`` so a reported
    line records its own credibility. Returns ``{"seconds", "min", "max",
    "spread"}``."""
    elapsed = _clock(_device(arg))

    def call():
        fn(arg)

    elapsed(call, 1)
    samples = sorted(_pair(elapsed, call, iters) for _ in range(repeats))
    med = samples[len(samples) // 2]
    return {
        "seconds": med,
        "min": samples[0],
        "max": samples[-1],
        "spread": round((samples[-1] - samples[0]) / med, 3),
    }


def device_time_queued(fn, *args, iters: int = 10, warmup: bool = True, sync=None) -> float:
    """Two-point timing by the host clock of ``fn(*args)`` with every call's
    dispatch included: N and then 2N calls are queued, and each run ends on
    the fetch of one scalar from the last call's output, which waits for
    everything queued before it. ``sync`` maps the output to that scalar
    (e.g. ``lambda out: out["loss"]`` of a training step, whose output is
    fetched after the optimizer's update was queued); by default it is the
    sum of every output tensor. The N / 2N difference cancels the final
    fetch and the first call's queue fill."""
    if sync is None:
        def sync(out):
            leaves = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            return sum(t.detach().real.float().sum() for t in leaves)

    def run(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn(*args)
        float(sync(out))
        return time.perf_counter() - t0

    if warmup:
        run(2)
    t1 = run(iters)
    t2 = run(2 * iters)
    return max((t2 - t1) / iters, 1e-9)
