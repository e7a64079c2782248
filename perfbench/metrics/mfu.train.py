"""The window's analytic model FLOPs (``perfbench/work/dac.py`` at the
cell's widths, every step of the traced window)
over the traced window's time, against the H100's dense bf16 peak (989
TFLOP/s), in percent. An fp32 or TF32 program reads low by construction."""
from perfbench.harness.readers import model_flops_percent


def read(context):
    return model_flops_percent(context, "model_flops")
