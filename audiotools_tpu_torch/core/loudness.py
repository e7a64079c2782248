"""Loudness meter class and the AudioSignal loudness mixin.

Counterpart of ``audiotools_tpu/core/loudness.py``: the math lives in
``ops/loudness.py``; ``Meter`` is the object API, ``LoudnessMixin``
caches a signal's measurement.
"""
from ..ops import loudness as loudness_ops


class Meter:
    """ITU-R BS.1770-4 meter.

    Parameters
    ----------
    rate : int
        Sample rate in Hz.
    filter_class : str
        "K-weighting" (default), "Fenton/Lee 1", "Fenton/Lee 2" or "Dash et al.".
    block_size : float
        Gating block size in seconds.
    zeros : int
        Taps of each stage's truncated FIR when ``use_fir``.
    use_fir : bool
        Weight with the truncated-FIR approximation (the original library's
        GPU meter) instead of the exact cascade.
    """

    def __init__(self, rate: int, filter_class: str = "K-weighting",
                 block_size: float = 0.400, zeros: int = 512, use_fir: bool = False):
        self.rate = rate
        self.filter_class = filter_class
        self.block_size = block_size
        self.zeros = zeros
        self.use_fir = use_fir

    @property
    def filters(self):
        """Per-stage ``(b, a, passband_gain)`` coefficients."""
        return [(b, a, g) for (b, a), g in loudness_ops.design_filters(self.rate, self.filter_class)]

    def apply_filter(self, data):
        """Apply the weighting filters to ``(nb, nt, nch)`` data."""
        if data.ndim == 2:
            data = data[None]
        out = loudness_ops.apply_k_weighting(
            data.transpose(-1, -2), self.rate, self.filter_class, self.use_fir, self.zeros
        )
        return out.transpose(-1, -2)

    # the original library's names for its two meters
    apply_filter_gpu = apply_filter
    apply_filter_cpu = apply_filter

    def integrated_loudness(self, data):
        """Integrated gated loudness of ``(nb, nt, nch)`` data."""
        out = loudness_ops.integrated_loudness(
            data, self.rate, filter_class=self.filter_class, block_size=self.block_size,
            use_fir=self.use_fir, zeros=self.zeros,
        )
        return out[0] if out.shape == (1,) else out

    __call__ = integrated_loudness


class LoudnessMixin:
    _loudness = None
    MIN_LOUDNESS = loudness_ops.MIN_LOUDNESS

    def loudness(self, filter_class: str = "K-weighting", block_size: float = 0.400,
                 **kwargs):
        """Integrated loudness per item ``(nb,)``, cached on the signal
        until its audio changes. Keyword arguments (``use_fir``, ``zeros``,
        ``conv_method``) pass to ``ops.loudness.loudness``."""
        if self._loudness is None:
            self._loudness = loudness_ops.loudness(
                self.audio_data, self.sample_rate,
                filter_class=filter_class, block_size=block_size, **kwargs,
            )
        return self._loudness
