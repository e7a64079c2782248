"""Device milliseconds a batch launched by the chain's transforms stage
(the benchmark's ``transforms`` span), from the device trace."""
from perfbench.harness.readers import per_iteration_device_ms


def read(context):
    return per_iteration_device_ms(context, "transforms")
