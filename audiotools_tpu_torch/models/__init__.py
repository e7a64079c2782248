"""Codec training: the DAC generator, the MPD + MRD discriminators, the
reconstruction and adversarial steps, and the weight converter from the
JAX package's parameter trees."""
from . import adversarial
from . import convert
from . import dac
from . import discriminators
from . import train
from .dac import DAC
from .discriminators import Discriminator
