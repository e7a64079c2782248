"""Device milliseconds a batch launched by the chain's pitch shift stage
(the benchmark's ``pitch_shift`` span), from the device trace."""
from perfbench.harness.readers import per_iteration_device_ms


def read(context):
    return per_iteration_device_ms(context, "pitch_shift")
