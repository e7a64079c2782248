"""Kernel fir_causal's share of its roofline: its least time on the chip from
the benchmark's own work counts, over the device time of everything that
``ops.hopper_kernels.fir_causal`` launched in the traced window, in percent."""
from perfbench.harness.readers import roofline_percent


def read(context):
    return roofline_percent(context, "fir_causal")
