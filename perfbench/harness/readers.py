"""Shared arithmetic of the per-layer metric readers
(``perfbench/metrics/<metric>.py``). Each reader's ``read(context)``
returns a number, or ``None`` where the run gave it nothing to read.
``context`` holds the run's ``trace`` (``harness.trace.Trace``), ``spans``
(``harness.spans.Spans``), ``window`` (the driver's window record),
``config``, ``mix``, ``cell`` and the driver's ``state``."""
from perfbench.harness.spans import KERNEL
from perfbench.work import kernels as work


def per_iteration_device_ms(context, span: str):
    """Device milliseconds launched inside ``span`` ranges, a window
    iteration (batch, step or request)."""
    n = context["window"]["iterations"]
    trace = context["trace"]
    if not n or span not in trace.range_count:
        return None
    return trace.device_ms(span) / n


def per_iteration_host_ms(context, span: str):
    """Host milliseconds inside ``span``, a window iteration."""
    spans = context["spans"]
    n = spans.count(span)
    return spans.total_s(span) * 1e3 / n if n else None


def roofline_percent(context, kernel: str):
    """The kernel's least time on the chip, summed over the window's calls
    of its entry point (``perfbench.work.kernels``), over the device time of
    everything those calls launched, in percent."""
    calls = context["spans"].calls.get(kernel)
    device_ms = context["trace"].device_ms(KERNEL + kernel)
    if not calls or device_ms <= 0:
        return None
    bound = sum(work.bound_s(work.of_call(kernel, args, kwargs)) for args, kwargs in calls)
    return 100.0 * bound * 1e3 / device_ms


def idle_percent(context):
    """The share of the traced window in which no device operation ran."""
    trace = context["trace"]
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def model_flops_percent(context, flops_key: str, peak: float = work.PEAK_BF16_FLOPS):
    """The window's analytic model FLOPs (the driver's ``window[flops_key]``)
    over the traced window's time, against ``peak``, in percent."""
    trace, window = context["trace"], context["window"]
    flops = window.get(flops_key)
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / trace.window_s / peak
