"""Reading a ``torch.profiler`` trace of the measured window.

``read(prof)`` turns the profiler's raw events into a ``Trace``: the device
operations (kernels, copies, sets) with their intervals, the benchmark's
ranges (``spans.PREFIX``), and for every range name the device time of the
operations launched while such a range was open on the launching thread. A
device operation is tied to its launch by the profiler's correlation ids:
the runtime call that launched it, whose start and thread place it inside
the benchmark's ranges. So an entry point's device time holds whatever it
launched, under any symbol, from native code (the program's ctypes
kernels) too.
"""
import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field

from .spans import PREFIX

WINDOW = "window"


@dataclass
class Trace:
    window_ns: tuple = (0, 0)
    device: list = field(default_factory=list)  # (start_ns, end_ns, name)
    ranges: list = field(default_factory=list)  # (name, start_ns, end_ns, tid)
    range_device_ns: dict = field(default_factory=dict)  # range name -> device ns
    range_count: dict = field(default_factory=dict)  # range name -> instances
    unlinked: int = 0  # device operations whose launch was not found

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran (the
        union of their intervals)."""
        return sum(b - a for a, b in self._busy_intervals()) / 1e9

    def _busy_intervals(self):
        lo, hi = self.window_ns
        merged = []
        for start, end, _ in sorted(self.device):
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    def device_ms(self, name: str) -> float:
        """Device milliseconds launched inside ranges called ``name``."""
        return self.range_device_ns.get(name, 0) / 1e6

    def top_device_ops(self, n: int = 10):
        """``[[name, seconds], ...]``: the operations that took the most
        device time in the window, summed by name."""
        lo, hi = self.window_ns
        total = defaultdict(int)
        for start, end, name in self.device:
            total[name] += max(0, min(end, hi) - max(start, lo))
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, n: int = 10):
        """``[[name, seconds], ...]``: the longest idle stretches of the
        device in the window, each named by the innermost benchmark range
        open on the host when it began ("none" outside every range)."""
        lo, hi = self.window_ns
        busy = self._busy_intervals()
        gaps, cursor = [], lo
        for start, end in busy:
            if start > cursor:
                gaps.append((cursor, start))
            cursor = max(cursor, end)
        if hi > cursor:
            gaps.append((cursor, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for start, end in gaps[:n]:
            open_ranges = [(r_start, name) for name, r_start, r_end, _ in self.ranges
                           if r_start <= start < r_end and name != WINDOW]
            label = max(open_ranges)[1] if open_ranges else "none"
            out.append([label, (end - start) / 1e9])
        return out


EVENT_KEYS = ("name", "activity", "on_device", "start_ns", "duration_ns", "correlation",
              "linked", "thread")


# the CUDA runtime's and driver's calls (cudaLaunchKernel, cuLaunchKernel, ...)
RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]")


def _activity(e, on_device):
    """The event's kind: the profiler's own word where it gives one (newer
    torch), else a user annotation for ranges, ``"cuda_runtime"`` for a call
    into the CUDA runtime or driver, ``"kernel"`` for other device work. A
    runtime call's correlation id is the device operation's it launched; an
    operator's id is another count, which may hold the same numbers."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    if annotation or e.name().startswith(PREFIX):
        return "gpu_user_annotation" if on_device else "user_annotation"
    if on_device:
        return "kernel"
    return "cuda_runtime" if RUNTIME_CALL.match(e.name()) else "cpu_op"


def events_of(prof):
    """The profiler's raw events as tuples of ``EVENT_KEYS``."""
    from torch.autograd import DeviceType

    events = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        events.append((e.name(), _activity(e, on_device), on_device, e.start_ns(),
                       e.duration_ns(), e.correlation_id(), e.linked_correlation_id(),
                       e.start_thread_id()))
    return events


def read(prof) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile``."""
    return from_events(events_of(prof))


def from_events(events) -> Trace:
    """A ``Trace`` of raw events (``events_of``). Device operations are
    kernels, copies and sets; the device's annotation ranges are left out.
    A device operation's launch is the runtime call of its correlation id
    where the trace holds one, else the operator or range it links to."""
    runtime, host = {}, {}
    device, ranges = [], []
    for name, activity, on_device, start, duration, corr, linked, thread in events:
        if on_device:
            if duration > 0 and "annotation" not in activity and not name.startswith(PREFIX):
                device.append((start, start + duration, name, corr, linked))
            continue
        if activity in ("cuda_runtime", "cuda_driver") or RUNTIME_CALL.match(name):
            runtime[corr] = (start, thread)
        elif corr and not linked:
            host[corr] = (start, thread)
        if name.startswith(PREFIX):
            ranges.append((name[len(PREFIX):], start, start + duration, thread))

    trace = Trace(device=[d[:3] for d in device], ranges=ranges)
    windows = [(s, t) for name, s, t, _ in ranges if name == WINDOW]
    if windows:
        trace.window_ns = (min(s for s, _ in windows), max(t for _, t in windows))
    elif device:
        trace.window_ns = (min(d[0] for d in device), max(d[1] for d in device))

    # launches, sorted by time on each thread, with their device ns
    launches = defaultdict(list)
    for start, end, _, corr, linked in device:
        origin = runtime.get(corr) or host.get(linked)
        if origin is None:
            trace.unlinked += 1
            continue
        launches[origin[1]].append((origin[0], end - start))
    prefix_ns = {}
    for tid, items in launches.items():
        items.sort()
        times = [t for t, _ in items]
        cumulative = [0]
        for _, ns in items:
            cumulative.append(cumulative[-1] + ns)
        prefix_ns[tid] = (times, cumulative)

    range_ns, count = defaultdict(int), defaultdict(int)
    for name, start, end, tid in ranges:
        count[name] += 1
        if tid not in prefix_ns:
            continue
        times, cumulative = prefix_ns[tid]
        i, j = bisect.bisect_left(times, start), bisect.bisect_right(times, end)
        range_ns[name] += cumulative[j] - cumulative[i]
    trace.range_device_ns, trace.range_count = dict(range_ns), dict(count)
    return trace
