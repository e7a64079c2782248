"""Host milliseconds a batch in which the program's BS.1770 meter (its span
``loudness``: ``ops.loudness.loudness`` and ``integrated_loudness``) was
open, mapped onto the profiler's clock (``harness.program``)."""
from perfbench.harness.program import host_ms


def read(context):
    return host_ms(context, ["loudness"])
