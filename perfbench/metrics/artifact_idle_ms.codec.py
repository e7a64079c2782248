"""Milliseconds a round trip in which the device ran nothing while the host
was inside ``compress`` or ``decompress`` (the program's spans of those
names) and outside the DAC's encoder, quantizer and decoder (``dac.*``): the
artifact's own host work, the codes' trip through the host included."""
from perfbench.harness.program import idle_ms

DAC = ["dac.encoder", "dac.quantizer", "dac.decoder"]


def read(context):
    return idle_ms(context, ["compress", "decompress"], minus=DAC)
