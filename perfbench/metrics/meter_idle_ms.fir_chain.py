"""As ``meter_idle_ms.chain``, in the FIR-meter chain: milliseconds a batch
in which the device ran nothing while the host was inside the program's
BS.1770 meter (its span ``loudness``)."""
from perfbench.harness.program import idle_ms


def read(context):
    return idle_ms(context, ["loudness"])
