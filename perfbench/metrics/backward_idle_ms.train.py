"""Milliseconds a training step in which the device ran nothing while the
host was inside the two ``backward`` calls (the program's span
``backward``), whose launches come from autograd's own thread."""
from perfbench.harness.program import idle_ms


def read(context):
    return idle_ms(context, ["backward"])
