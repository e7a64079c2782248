"""The benchmark's own spans around the calls into each layer.

A span is a host interval (``time.perf_counter`` seconds) with a name. In a
traced run each span is also a ``torch.profiler`` range named
``PREFIX + name``, so the trace reader can credit every device operation to
the spans open on the host when it was launched. The program's kernel entry
points are wrapped in spans of their own (``wrap_entry_points``), and each
call's argument shapes are kept, so the benchmark computes the kernels' work
from shapes with its own counts (``perfbench.work``).
"""
import contextlib
import functools
import time
from collections import defaultdict

PREFIX = "perfbench."
KERNEL = "kernel."


class Spans:
    """Spans of one run, kept in memory. ``traced``: each span is also a
    profiler range."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.records = []  # (name, start_s, end_s)
        self.calls = defaultdict(list)  # entry point -> [shapes of each call]

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.traced:
            from torch.profiler import record_function

            rf = record_function(PREFIX + name)
            rf.__enter__()
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.records.append((name, start, end))

    def total_s(self, name: str) -> float:
        return sum(end - start for n, start, end in self.records if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.records if n == name)


def _shape(value):
    """What a call's work depends on: a tensor's shape and dtype, a number
    or a sequence's length."""
    shape = getattr(value, "shape", None)
    if shape is not None:
        return (tuple(int(s) for s in shape), str(getattr(value, "dtype", "")))
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    try:
        return ("len", len(value))
    except TypeError:
        return type(value).__name__


def wrap_entry_points(module, names, spans: Spans):
    """Replace ``module.<name>`` by a wrapper that opens the span
    ``kernel.<name>`` and keeps the shapes of each call's arguments; returns
    a function that puts the originals back. Callers that look the entry
    point up on the module at call time go through the wrapper."""
    originals = {name: getattr(module, name) for name in names}

    def wrapped(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            spans.calls[name].append(([_shape(a) for a in args],
                                      {k: _shape(v) for k, v in kwargs.items()}))
            with spans.span(KERNEL + name):
                return fn(*args, **kwargs)

        return call

    for name, fn in originals.items():
        setattr(module, name, wrapped(name, fn))

    def restore():
        for name, fn in originals.items():
            setattr(module, name, fn)

    return restore
