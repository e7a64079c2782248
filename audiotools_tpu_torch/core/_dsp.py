"""DSP on AudioSignals: windowing and overlap-add, the windowed-sinc low-
and high-pass, SpecAug frequency and time masks, low-magnitude masking,
phase shifts and corruption, and pre-emphasis.

Counterpart of ``audiotools_tpu/core/_dsp.py``. Every method is batched,
takes per-item parameters and runs on the signal's device.
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import util
from ..ops import fft as _fft
from ..ops import filters as _filters


@functools.lru_cache(maxsize=64)
def _grid(stop: float, num: int):
    """The masks' bin grid from 0 to ``stop``, bit-equal to the JAX
    package's ``jnp.linspace(0, stop, num)``: XLA folds its ``i / (num - 1)``
    into a product with the reciprocal and the two scalars into one
    factor, so value ``i`` is ``i * (stop * (1 / (num - 1)))`` in fp32, and
    the last is ``stop``. (``torch.linspace`` computes its upper half from
    the end point; either way single values move by an ulp, which flips a
    bin that lies on a mask's edge.)"""
    stop = np.float32(stop)
    if num < 2:
        return (np.zeros(num, np.float32),)
    factor = stop * (np.float32(1) / np.float32(num - 1))
    return (np.append(np.arange(num - 1, dtype=np.float32) * factor, stop).astype(np.float32),)


def _polar(magnitude, phase):
    """``magnitude * exp(1j * phase)`` as the JAX package evaluates it:
    ``magnitude * cos(phase)`` and ``magnitude * sin(phase)``."""
    return torch.complex(magnitude * torch.cos(phase), magnitude * torch.sin(phase))


class DSPMixin:
    _original_batch_size = None
    _original_num_channels = None
    _padded_signal_length = None

    def _preprocess_signal_for_windowing(self, window_duration, hop_duration):
        """Cut the window to a multiple of the hop, pad a hop of zeros at
        each end, and remember the layout for :meth:`overlap_and_add`."""
        self._original_batch_size = self.batch_size
        self._original_num_channels = self.num_channels
        hop_length = int(hop_duration * self.sample_rate)
        window_length = int(window_duration * self.sample_rate)
        window_length -= window_length % hop_length
        self.zero_pad(hop_length, hop_length)
        self._padded_signal_length = self.signal_length
        return window_length, hop_length

    def _windowing_lengths(self, window_duration, hop_duration, preprocess):
        if preprocess:
            return self._preprocess_signal_for_windowing(window_duration, hop_duration)
        return int(window_duration * self.sample_rate), int(hop_duration * self.sample_rate)

    def windows(self, window_duration: float, hop_duration: float, preprocess: bool = True):
        """Yield the windows of every channel of every item in turn, each a
        signal ``(1, 1, window_length)`` (with ``preprocess``, as
        :meth:`collect_windows` cuts them)."""
        window_length, hop_length = self._windowing_lengths(window_duration, hop_duration,
                                                            preprocess)
        self.audio_data = self.audio_data.reshape(-1, 1, self.signal_length)
        n_frames = max(1 + (self.signal_length - window_length) // hop_length, 0)
        for b in range(self.batch_size):
            for i in range(n_frames):
                start = i * hop_length
                yield self[b, ..., start:start + window_length]

    def collect_windows(self, window_duration: float, hop_duration: float,
                        preprocess: bool = True):
        """Reshape into overlapping windows along the batch: ``(B C n_frames,
        1, window_length)``, item by item and channel by channel."""
        window_length, hop_length = self._windowing_lengths(window_duration, hop_duration,
                                                            preprocess)
        flat = self.audio_data.reshape(-1, self.signal_length)
        frames = flat.unfold(-1, window_length, hop_length)  # (B C, n_frames, window)
        self.audio_data = frames.reshape(-1, 1, window_length)
        return self

    def overlap_and_add(self, hop_duration: float):
        """Overlap-add the windows of :meth:`collect_windows` back into
        signals, dividing each sample by the number of windows over it, and
        trim the padding."""
        hop_length = int(hop_duration * self.sample_rate)
        window_length = self.signal_length
        nb, nch = self._original_batch_size, self._original_num_channels
        out_len = self._padded_signal_length
        stacked = self.audio_data.reshape(nb * nch, -1, window_length).transpose(1, 2)
        fold = dict(output_size=(1, out_len), kernel_size=(1, window_length),
                    stride=(1, hop_length))
        folded = F.fold(stacked, **fold)  # (nb nch, 1, 1, out_len)
        coverage = F.fold(torch.ones_like(stacked[:1]), **fold)
        self.audio_data = (folded / coverage).reshape(nb, nch, out_len)
        self.trim(hop_length, hop_length)
        return self

    def low_pass(self, cutoffs, zeros: int = 51, min_cutoff_hz: float = None,
                 block_size="auto"):
        """Low-pass with per-item cutoffs in Hz (``ops.filters.low_pass``);
        ``min_cutoff_hz`` is the least cutoff the caller will pass. Drops the
        cached STFT."""
        cutoffs = util.ensure_tensor(cutoffs, 2, self.batch_size)
        kw = {} if min_cutoff_hz is None else {"min_cutoff_hz": min_cutoff_hz}
        self.audio_data = _filters.low_pass(self.audio_data, cutoffs.reshape(-1),
                                            self.sample_rate, zeros, block_size=block_size, **kw)
        self.stft_data = None
        return self

    def high_pass(self, cutoffs, zeros: int = 51, min_cutoff_hz: float = None,
                  block_size="auto"):
        """High-pass with per-item cutoffs in Hz (``ops.filters.high_pass``).
        Drops the cached STFT."""
        cutoffs = util.ensure_tensor(cutoffs, 2, self.batch_size)
        kw = {} if min_cutoff_hz is None else {"min_cutoff_hz": min_cutoff_hz}
        self.audio_data = _filters.high_pass(self.audio_data, cutoffs.reshape(-1),
                                             self.sample_rate, zeros, block_size=block_size, **kw)
        self.stft_data = None
        return self

    def _cells(self, low, high, stop: float, axis: int):
        """The STFT cells whose bin (``axis=-2``, on a grid from 0 to
        ``stop`` Hz) or frame (``axis=-1``, from 0 to ``stop`` s) lies in
        ``[low, high)``, per item; computes the STFT if none is cached."""
        if self.stft_data is None:
            self.stft()
        shape, device = self.stft_data.shape, self.stft_data.device
        low = util.ensure_tensor(low, ndim=len(shape), device=device)
        high = util.ensure_tensor(high, ndim=len(shape), device=device)
        (grid,) = _fft._on_device(_grid, (stop, shape[axis]), device)
        grid = grid[:, None] if axis == -2 else grid
        return (low <= grid) & (grid < high)

    def _mask_cells(self, cells, val):
        """Set magnitude and phase to ``val`` in ``cells``."""
        mag = torch.where(cells, val, self.magnitude)
        phase = torch.where(cells, val, self.phase)
        self.stft_data = _polar(mag, phase)
        return self

    def mask_frequencies(self, fmin_hz, fmax_hz, val: float = 0.0):
        """SpecAug frequency mask: the bins in ``[fmin_hz, fmax_hz)`` (per
        item) on a grid from 0 to Nyquist."""
        return self._mask_cells(self._cells(fmin_hz, fmax_hz, self.sample_rate / 2, -2), val)

    def mask_timesteps(self, tmin_s, tmax_s, val: float = 0.0):
        """SpecAug time mask: the frames in ``[tmin_s, tmax_s)`` (per item)
        on a grid from 0 to the signal's duration."""
        return self._mask_cells(self._cells(tmin_s, tmax_s, self.signal_duration, -1), val)

    def mask_low_magnitudes(self, db_cutoff, val: float = 0.0):
        """Set the magnitude of cells below ``db_cutoff`` dB (per item) to
        ``val``, keeping their phase."""
        mag = self.magnitude
        log_mag = self.log_magnitude()
        db_cutoff = util.ensure_tensor(db_cutoff, ndim=mag.ndim, device=mag.device)
        self.magnitude = torch.where(log_mag < db_cutoff, val, mag)
        return self

    def shift_phase(self, shift):
        """Add ``shift`` to the phase: one value per item, or a full ``(C, F,
        T)`` plane broadcast over the batch, or a ``(B, C, F, T)`` one."""
        phase = self.phase
        shift = util.ensure_tensor(shift, device=phase.device)
        if shift.ndim == phase.ndim - 1 and shift.shape == phase.shape[1:]:
            shift = shift[None]
        else:
            shift = util.ensure_tensor(shift, ndim=phase.ndim)
        self.phase = phase + shift
        return self

    def corrupt_phase(self, scale, state):
        """Add Gaussian noise of standard deviation ``scale`` (per item) to
        the phase. ``state`` is a ``torch.Generator`` (noise drawn on its
        device) or a numpy ``RandomState`` (noise drawn on the host);
        nothing is drawn from a global generator."""
        phase = self.phase
        scale = util.ensure_tensor(scale, ndim=phase.ndim, device=phase.device)
        if isinstance(state, torch.Generator):
            noise = torch.randn(phase.shape, generator=state, device=state.device)
        elif isinstance(state, np.random.RandomState):
            noise = torch.from_numpy(state.randn(*phase.shape).astype(np.float32))
        else:
            raise ValueError("corrupt_phase needs a torch.Generator or a numpy RandomState, "
                             f"got {state!r}")
        self.phase = phase + scale * noise.to(phase.device)
        return self

    def preemphasis(self, coef: float = 0.85):
        """Pre-emphasis ``y[n] = x[n - 1] - coef x[n]`` (``ops.filters``)."""
        self.audio_data = _filters.preemphasis(self.audio_data, coef)
        return self
