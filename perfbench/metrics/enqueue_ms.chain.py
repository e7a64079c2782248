"""Host milliseconds to enqueue one batch of the chain (the benchmark's
``batch`` span, host clock): the chain's dispatch cost, which bounds the
batch rate where the device waits for the host."""
from perfbench.harness.readers import per_iteration_host_ms


def read(context):
    return per_iteration_host_ms(context, "batch")
