"""Loudness meter class and the AudioSignal loudness mixin.

Counterpart of ``audiotools_tpu/core/loudness.py``: the math lives in
``ops/loudness.py``; ``Meter`` is the object API, ``LoudnessMixin``
caches a signal's measurement.
"""
from ..ops import loudness as loudness_ops


class Meter:
    """ITU-R BS.1770-4 meter (exact weighting cascade).

    Parameters
    ----------
    rate : int
        Sample rate in Hz.
    filter_class : str
        "K-weighting" (default), "Fenton/Lee 1", "Fenton/Lee 2" or "Dash et al.".
    block_size : float
        Gating block size in seconds.
    """

    def __init__(self, rate: int, filter_class: str = "K-weighting",
                 block_size: float = 0.400):
        self.rate = rate
        self.filter_class = filter_class
        self.block_size = block_size

    def integrated_loudness(self, data):
        """Integrated gated loudness of ``(nb, nt, nch)`` data."""
        out = loudness_ops.integrated_loudness(
            data, self.rate, filter_class=self.filter_class, block_size=self.block_size
        )
        return out[0] if out.shape == (1,) else out

    __call__ = integrated_loudness


class LoudnessMixin:
    _loudness = None
    MIN_LOUDNESS = loudness_ops.MIN_LOUDNESS

    def loudness(self, filter_class: str = "K-weighting", block_size: float = 0.400):
        """Integrated loudness per item ``(nb,)``, cached on the signal
        until its audio changes."""
        if self._loudness is None:
            self._loudness = loudness_ops.loudness(
                self.audio_data, self.sample_rate,
                filter_class=filter_class, block_size=block_size,
            )
        return self._loudness
