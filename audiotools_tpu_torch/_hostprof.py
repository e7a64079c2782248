"""Host-pipeline cost accounting.

Counterpart of ``audiotools_tpu/_hostprof.py``. The data path's host
functions (file decode, the salient-excerpt meter, host resampling,
transform instantiation, collation and device staging) wrap themselves in
:func:`span`, which costs one global read until :func:`enable` is called.

Accounting is *exclusive* (self-time): a nested span subtracts its duration
from the span around it, so ``instantiate`` reports the parameter draws
only, not a decode they trigger, and the totals add up to the wall clock
instead of counting time twice.
"""
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

__all__ = ["enable", "disable", "reset", "totals", "span"]

_enabled = False
_lock = threading.Lock()
_totals: "defaultdict[str, float]" = defaultdict(float)
_local = threading.local()


def enable():
    """Start accumulating span timings (all threads)."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def reset():
    with _lock:
        _totals.clear()


def totals() -> dict:
    """Accumulated exclusive seconds per span name."""
    with _lock:
        return dict(_totals)


@contextmanager
def span(name: str):
    """Time a host-pipeline phase. No-op (one global read) when disabled."""
    if not _enabled:
        yield
        return
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    entry = [time.perf_counter(), 0.0]  # start, accumulated child time
    stack.append(entry)
    try:
        yield
    finally:
        dt = time.perf_counter() - entry[0]
        stack.pop()
        if stack:
            stack[-1][1] += dt  # credit the parent with our full duration
        with _lock:
            _totals[name] += dt - entry[1]  # record exclusive self-time
