"""Milliseconds a batch in which the device ran nothing while the host was
inside the program's BS.1770 meter (its span ``loudness``): the meter's
share of the chain's device idle time (device trace, ``harness.program``)."""
from perfbench.harness.program import idle_ms


def read(context):
    return idle_ms(context, ["loudness"])
