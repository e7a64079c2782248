"""Kernel phase_vocoder_fused's share of its roofline: its least time on the chip from
the benchmark's own work counts, over the device time of everything that
``ops.hopper_kernels.phase_vocoder_fused`` launched in the traced window, in percent."""
from perfbench.harness.readers import roofline_percent


def read(context):
    return roofline_percent(context, "phase_vocoder_fused")
