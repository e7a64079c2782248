"""Arithmetic over the program's own spans in a traced window.

While ``torch.profiler`` records, the program makes each of its spans a
range named ``"audiotools." + name`` and keeps the span's interval
(``audiotools_tpu_torch._hostprof.ranges()``: name, start and end on
``time.perf_counter_ns``, thread), which the benchmark's trace reader
(``harness.trace``) does not keep. The benchmark's own spans are timed on
both clocks, in ``spans.records`` (``time.perf_counter``) and as the trace's
ranges (the profiler's clock), so their starts map the program's intervals
onto the trace's clock, where the device's operations are. A program that
keeps no such record gives ``None``.

Each function returns a window total a window iteration (batch, step or
request), over a set of span names, or ``None`` where the window holds none
of those spans.
"""
import statistics

from perfbench.harness.trace import WINDOW


def _merged(intervals):
    """Sorted, disjoint ``[start, end]`` lists covering ``intervals``."""
    out = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _overlap_ns(a, b):
    """Nanoseconds that two merged interval lists have in common."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _subtract(a, b):
    """The merged list ``a`` with the merged list ``b`` taken out."""
    out = []
    for start, end in a:
        for b_start, b_end in b:
            if b_end <= start or b_start >= end:
                continue
            if b_start > start:
                out.append([start, b_start])
            start = max(start, b_end)
        if end > start:
            out.append([start, end])
    return out


def _clock_offsets(context):
    """``(host ns, profiler ns minus host ns)`` at the start of each of the
    benchmark's spans in the window, sorted: a span's start is read on the
    host's counter just after its range opens on the profiler's clock, as the
    program's are. The window's own is left out: the profiler's first range
    of a run opens late, after its set-up."""
    by_name = {}
    for name, start, end in context["spans"].records:
        by_name.setdefault(name, []).append(start)
    traced = {}
    for name, start, end, _ in context["trace"].ranges:
        traced.setdefault(name, []).append(start)
    pairs = []
    for name, host in by_name.items():
        prof = traced.get(name, [])
        if name != WINDOW and len(prof) == len(host):
            pairs += [(h * 1e9, p - h * 1e9) for h, p in zip(sorted(host), sorted(prof))]
    return sorted(pairs)


def program_ranges(context):
    """The program's spans inside the traced window as ``(name, start_ns,
    end_ns)`` on the trace's clock; ``None`` where the program keeps no
    record of its spans. The two clocks can drift apart (2e-4 in a CPU run)
    and one offset can be late by milliseconds (a range whose opening the
    profiler delayed), so the offset is a line through the medians of the
    offsets at the benchmark's spans' starts, its slope from the medians of
    their earlier and later halves."""
    from audiotools_tpu_torch import _hostprof

    kept = getattr(_hostprof, "ranges", None)
    anchors = _clock_offsets(context)
    lo, hi = context["trace"].window_ns
    if kept is None or not anchors or hi <= lo:
        return None
    times, offsets = [t for t, _ in anchors], [d for _, d in anchors]
    half = len(anchors) // 2
    slope = 0.0
    if half >= 2 and times[-1] > times[0]:
        slope = ((statistics.median(offsets[half:]) - statistics.median(offsets[:half]))
                 / (statistics.median(times[half:]) - statistics.median(times[:half])))
    mid = statistics.median(times)
    offset = statistics.median(d - slope * (t - mid) for t, d in anchors)

    out = []
    for name, start, end, _ in kept():
        start, end = (t + offset + slope * (t - mid) for t in (start, end))
        if lo <= start and end <= hi:
            out.append((name, start, end))
    return out


def _opened(context, names, minus=()):
    """The merged intervals in which one of the spans ``names`` was open on
    the host, on any thread, and none of the spans ``minus``; ``None``
    where the window holds none of ``names`` or no iteration."""
    ranges = program_ranges(context)
    if not ranges or not context["window"]["iterations"]:
        return None

    def opened(which):
        return _merged((start, end) for name, start, end in ranges if name in which)

    inside = opened(set(names))
    return _subtract(inside, opened(set(minus))) if inside else None


def host_ms(context, names):
    """Host milliseconds a window iteration in which one of the spans
    ``names`` was open (the union of their intervals)."""
    host = _opened(context, names)
    if host is None:
        return None
    return sum(end - start for start, end in host) / 1e6 / context["window"]["iterations"]


def idle_ms(context, names, minus=()):
    """Milliseconds a window iteration in which the device ran nothing while
    one of the spans ``names`` was open on the host, and none of the spans
    ``minus``."""
    host = _opened(context, names, minus)
    if host is None:
        return None
    idle = sum(end - start for start, end in host) - _overlap_ns(
        host, context["trace"]._busy_intervals())
    return idle / 1e6 / context["window"]["iterations"]
