"""As ``meter_host_ms.chain``, in the FIR-meter chain: host milliseconds a
batch in which the program's BS.1770 meter (its span ``loudness``) was
open."""
from perfbench.harness.program import host_ms


def read(context):
    return host_ms(context, ["loudness"])
