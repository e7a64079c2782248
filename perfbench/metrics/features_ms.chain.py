"""Device milliseconds a batch launched by the chain's features stage
(the benchmark's ``features`` span), from the device trace."""
from perfbench.harness.readers import per_iteration_device_ms


def read(context):
    return per_iteration_device_ms(context, "features")
