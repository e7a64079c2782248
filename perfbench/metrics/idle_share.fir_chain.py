"""The share of the traced window in which no operation ran on the device,
in percent (device trace)."""
from perfbench.harness.readers import idle_percent


def read(context):
    return idle_percent(context)
