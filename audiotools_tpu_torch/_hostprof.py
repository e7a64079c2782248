"""Host-pipeline cost accounting and the program's trace ranges.

Counterpart of ``audiotools_tpu/_hostprof.py``. The program marks its
phases with :func:`span`: the data path's host functions (file decode, the
salient-excerpt meter, host resampling, transform instantiation, collation
and device staging), each transform, the BS.1770 meter, the DAC's encoder,
quantizer and decoder, the adversarial step's generator, discriminator,
backward and optimizer phases, and the codec's ``compress`` and
``decompress``. A span has two sinks:

- after :func:`enable`, exclusive host totals (:func:`totals`);
- while ``torch.profiler`` records (``ml.profiling.trace`` or any
  ``profile()``), a ``record_function`` range named ``"audiotools." +
  name``, on the profiler's clock: nested spans nest, and the device work a
  span launches lies under it in the trace. The range's interval is also
  kept in memory (:func:`ranges`, the last 100,000), so a summary of a
  traced region need not parse the trace.

With neither sink on, a span costs one read of each switch and builds no
name.

Accounting is *exclusive* (self-time): a nested span subtracts its duration
from the span around it, so ``instantiate`` reports the parameter draws
only, not a decode they trigger, and the totals add up to the wall clock
instead of counting time twice.
"""
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager, nullcontext

import torch.autograd.profiler as _autograd_profiler

__all__ = ["enable", "disable", "reset", "totals", "span"]

_enabled = False
_lock = threading.Lock()
_totals: "defaultdict[str, float]" = defaultdict(float)
_local = threading.local()
_OFF = nullcontext()
_RANGE_PREFIX = "audiotools."
_ranges: deque = deque(maxlen=100_000)


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
    _ranges.clear()


def totals() -> dict:
    """Accumulated exclusive seconds per span name."""
    with _lock:
        return dict(_totals)


def ranges() -> list:
    """The spans made while ``torch.profiler`` recorded, oldest first, the
    last 100,000: ``(name, start_ns, end_ns, thread)``, the name
    without the ranges' ``"audiotools."``, the times on
    ``time.perf_counter_ns``, the thread ``threading.get_ident()``'s."""
    return list(_ranges)


def span(name: str, *parts: str):
    """Mark a phase of the program (context manager). Its name is ``name``
    and ``parts`` joined by dots, built only where a sink is on (module
    docstring)."""
    ranged = _autograd_profiler._is_profiler_enabled
    if not (_enabled or ranged):
        return _OFF
    return _span(".".join((name, *parts)) if parts else name, ranged)


@contextmanager
def _span(name: str, ranged: bool):
    if not ranged:
        with _totalled(name):
            yield
        return
    # the interval is read inside the range, as near its ends as it can be
    with _totalled(name), _autograd_profiler.record_function(_RANGE_PREFIX + name):
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            _ranges.append((name, start, time.perf_counter_ns(), threading.get_ident()))


@contextmanager
def _totalled(name: str):
    """Exclusive totals, where :func:`enable` has turned them on."""
    if not _enabled:
        yield
        return
    frames = getattr(_local, "stack", None)
    if frames is None:
        frames = _local.stack = []
    entry = [time.perf_counter(), 0.0]  # start, accumulated child time
    frames.append(entry)
    try:
        yield
    finally:
        dt = time.perf_counter() - entry[0]
        frames.pop()
        if frames:
            frames[-1][1] += dt  # credit the parent with our full duration
        with _lock:
            _totals[name] += dt - entry[1]  # record exclusive self-time
