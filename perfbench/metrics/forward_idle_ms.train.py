"""Milliseconds a training step in which the device ran nothing while the
host was in the generator's forward and losses (the program's span
``generator``) or the discriminators' calls (``discriminator``)."""
from perfbench.harness.program import idle_ms


def read(context):
    return idle_ms(context, ["generator", "discriminator"])
