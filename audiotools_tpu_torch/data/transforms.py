"""Augmentation transforms.

Counterpart of ``audiotools_tpu/data/transforms.py``: the framework
(``BaseTransform``, ``Identity``, ``SpectralTransform``, ``Compose``,
``Choose``, ``Repeat``, ``RepeatUpTo``) and every leaf transform.
``instantiate(state, signal)`` draws parameters on the host with a numpy
``RandomState`` in the JAX package's order (a transform of probability
below 1 draws its Bernoulli mask after its parameters; one of probability
1 draws none), so one seed gives identical parameters in both packages.
Signals and noise planes drawn at instantiate time are built on the host
and reach the card with the batch (``util.prepare_batch``).
``transform(signal, **kwargs)`` applies the effect to the items whose mask
is true. Masks stay host numpy bools, so an all-true mask is seen on the
host and costs no device synchronization.
"""
import copy
from contextlib import contextmanager
from inspect import signature
from typing import List

import numpy as np
import torch

from .._hostprof import span
from ..core import AudioSignal
from ..core import util
from ..core._dsp import _polar
from .datasets import AudioLoader


def tt(x):
    """A host value as numpy (float64 becomes float32); tensors pass through."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == np.float64 else x


class BaseTransform:
    """Base class: the names of ``_transform``'s parameters are the keys its
    instantiated parameters carry, plus ``"mask"``.

    Parameters
    ----------
    keys : list, optional
        Extra keys expected in the transform kwargs.
    name : str, optional
        Name of this transform in instantiated dicts.
    prob : float
        Probability of applying the transform to an item.
    """

    # set by Choose on its children: their masks are rewritten after they
    # are drawn, so the all-true shortcut of ``transform`` is not taken
    _force_masked = False

    def __init__(self, keys: list = None, name: str = None, prob: float = 1.0):
        drawn = [k for k in signature(self._transform).parameters
                 if k not in ("signal", "kwargs")]
        self.keys = list(keys or []) + drawn + ["mask"]
        self.prob = prob
        self.name = self.__class__.__name__ if name is None else name

    def _prepare(self, batch: dict):
        sub_batch = batch[self.name]
        missing = [k for k in self.keys if k not in sub_batch]
        if missing:
            raise KeyError(f"transform '{self.name}' expected key(s) {missing} in its "
                           f"instantiated kwargs, got {sorted(sub_batch)}")
        return sub_batch

    def _transform(self, signal):
        return signal

    def _instantiate(self, state, signal: AudioSignal = None):
        return {}

    @staticmethod
    def apply_mask(batch: dict, mask):
        """The items of ``batch`` where ``mask`` is true: signals, tensors and
        arrays are indexed, other values pass through. A 0-d true mask
        keeps the batch as it is."""
        mask = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
        if mask.ndim == 0 and bool(mask):
            return batch

        def pick(v):
            if isinstance(v, (AudioSignal, np.ndarray)):
                return v[mask]
            if isinstance(v, torch.Tensor):
                return v[torch.from_numpy(mask).to(v.device)]
            return v

        return util.unflatten({k: pick(v) for k, v in util.flatten(batch).items()})

    def transform(self, signal: AudioSignal, **kwargs):
        """Apply the transform where the mask is true: directly when the
        mask is a host array that is all true (and the transform is not a
        child of ``Choose``), else by computing all items and selecting per
        item. Both paths are the span ``transform.<class name>``."""
        with span("transform", type(self).__name__):
            tfm_kwargs = dict(self._prepare(kwargs))
            mask = tfm_kwargs.pop("mask")
            if not self._force_masked and not isinstance(mask, torch.Tensor) and np.all(mask):
                return self._transform(signal, **tfm_kwargs)
            original = signal.clone()
            transformed = self._transform(signal, **tfm_kwargs)
            return AudioSignal.where(mask, transformed, original)

    def __call__(self, *args, **kwargs):
        return self.transform(*args, **kwargs)

    def instantiate(self, state=None, signal: AudioSignal = None):
        """Draw this transform's parameters, then (for ``prob < 1``) its mask."""
        state = util.random_state(state)
        with span("instantiate"):
            if "signal" in signature(self._instantiate).parameters:
                params = self._instantiate(state, signal=signal)
            else:
                params = self._instantiate(state)
        params = {k: v if isinstance(v, (AudioSignal, torch.Tensor, dict)) else tt(v)
                  for k, v in params.items()}
        if self.prob >= 1.0:
            params["mask"] = np.True_
        else:
            params["mask"] = tt(bool(state.rand() <= self.prob))
        return {self.name: params}

    def batch_instantiate(self, states: list = None, signal: AudioSignal = None):
        """Instantiate once per state and collate the items."""
        return util.collate([self.instantiate(s, signal) for s in states])


class Identity(BaseTransform):
    """Returns the signal as it is."""


class SpectralTransform(BaseTransform):
    """A transform of the STFT: computes it before and inverts it after."""

    def transform(self, signal, **kwargs):
        signal.stft()
        out = super().transform(signal, **kwargs)
        out.istft()
        return out


class Compose(BaseTransform):
    """Applies transforms in sequence; children are addressed as
    ``"{position}.{name}"``."""

    def __init__(self, *transforms, name: str = None, prob: float = 1.0):
        if isinstance(transforms[0], list):
            transforms = transforms[0]
        for position, tfm in enumerate(transforms):
            tfm.name = f"{position}.{tfm.name}"
        self.transforms = list(transforms)
        self.transforms_to_apply = [tfm.name for tfm in self.transforms]
        super().__init__(keys=list(self.transforms_to_apply), name=name, prob=prob)

    @contextmanager
    def filter(self, *names):
        """Within the context, run only the children whose name contains
        one of ``names``."""
        previous = self.transforms_to_apply
        self.transforms_to_apply = names
        try:
            yield
        finally:
            self.transforms_to_apply = previous

    def _transform(self, signal, **kwargs):
        for tfm in self.transforms:
            if any(token in tfm.name for token in self.transforms_to_apply):
                signal = tfm(signal, **kwargs)
        return signal

    def _instantiate(self, state, signal: AudioSignal = None):
        drawn = {}
        for tfm in self.transforms:
            drawn.update(tfm.instantiate(state, signal=signal))
        return drawn

    def __getitem__(self, idx):
        return self.transforms[idx]

    def __len__(self):
        return len(self.transforms)

    def __iter__(self):
        return iter(self.transforms)


class Choose(Compose):
    """Applies one child per item, drawn by ``weights`` after the children's
    own parameters; a child whose own mask is false stays off."""

    def __init__(self, *transforms, weights: list = None, name: str = None,
                 prob: float = 1.0):
        super().__init__(*transforms, name=name, prob=prob)
        for tfm in self.transforms:
            tfm._force_masked = True
        n = len(self.transforms)
        self.weights = np.full(n, 1.0 / n) if weights is None else np.array(weights)

    def _instantiate(self, state, signal: AudioSignal = None):
        kwargs = super()._instantiate(state, signal)
        chosen = state.choice(list(range(len(self.transforms))), p=self.weights)
        one_hot = []
        for position, tfm in enumerate(self.transforms):
            mask = kwargs[tfm.name]["mask"]
            if bool(np.asarray(mask)):
                mask = tt(position == chosen)
                kwargs[tfm.name]["mask"] = mask
            one_hot.append(mask)
        kwargs["one_hot"] = one_hot
        return kwargs


class Repeat(Compose):
    """Applies a transform ``n_repeat`` times, each time with its own draws."""

    def __init__(self, transform, n_repeat: int = 1, name: str = None, prob: float = 1.0):
        super().__init__([copy.copy(transform) for _ in range(n_repeat)], name=name, prob=prob)
        self.n_repeat = n_repeat


class RepeatUpTo(Choose):
    """Applies a transform between 1 and ``max_repeat - 1`` times."""

    def __init__(self, transform, max_repeat: int = 5, weights: list = None,
                 name: str = None, prob: float = 1.0):
        super().__init__([Repeat(transform, n_repeat=n) for n in range(1, max_repeat)],
                         name=name, prob=prob, weights=weights)
        self.max_repeat = max_repeat


def _draw_eq(state, eq_amount, n_bands):
    """Per-band attenuations: the amount first, then one uniform per band."""
    amount = util.sample_from_dist(eq_amount, state)
    return (-amount * state.rand(n_bands)).astype("float32")


class Equalizer(BaseTransform):
    """Random mel-spaced EQ curve."""

    def __init__(self, eq_amount: tuple = ("const", 1.0), n_bands: int = 6,
                 name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.eq_amount = eq_amount
        self.n_bands = n_bands

    def _instantiate(self, state):
        return {"eq": _draw_eq(state, self.eq_amount, self.n_bands)}

    def _transform(self, signal, eq):
        return signal.equalizer(eq)


class BackgroundNoise(BaseTransform):
    """Mixes in EQ-ed background noise from ``sources`` at a random SNR."""

    def __init__(self, snr: tuple = ("uniform", 10.0, 30.0), sources: List[str] = None,
                 weights: List[float] = None, eq_amount: tuple = ("const", 1.0),
                 n_bands: int = 3, name: str = None, prob: float = 1.0,
                 loudness_cutoff: float = None):
        super().__init__(name=name, prob=prob)
        self.snr = snr
        self.eq_amount = eq_amount
        self.n_bands = n_bands
        self.loader = AudioLoader(sources, weights)
        self.loudness_cutoff = loudness_cutoff

    def _instantiate(self, state, signal: AudioSignal):
        # draw order: eq amount, per-band eq, snr, then the loader's draws
        eq = _draw_eq(state, self.eq_amount, self.n_bands)
        snr = util.sample_from_dist(self.snr, state)
        loaded = self.loader(
            state, signal.sample_rate, duration=signal.signal_duration,
            loudness_cutoff=self.loudness_cutoff, num_channels=signal.num_channels,
        )
        return {"eq": eq, "bg_signal": loaded["signal"], "snr": snr}

    def _transform(self, signal, bg_signal, snr, eq):
        return signal.mix(bg_signal.clone(), snr, eq)


class RoomImpulseResponse(BaseTransform):
    """Reverb: convolution with an EQ-ed impulse response from ``sources``
    at a random direct-to-reverberant ratio."""

    def __init__(self, drr: tuple = ("uniform", 0.0, 30.0), sources: List[str] = None,
                 weights: List[float] = None, eq_amount: tuple = ("const", 1.0),
                 n_bands: int = 6, name: str = None, prob: float = 1.0,
                 use_original_phase: bool = False, offset: float = 0.0,
                 duration: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.loader = AudioLoader(sources, weights)
        self.offset, self.duration = offset, duration
        self.drr = drr
        self.eq_amount = eq_amount
        self.n_bands = n_bands
        self.use_original_phase = use_original_phase

    def _instantiate(self, state, signal: AudioSignal = None):
        # draw order: eq amount, per-band eq, drr, then the loader's draws
        eq = _draw_eq(state, self.eq_amount, self.n_bands)
        drr = util.sample_from_dist(self.drr, state)
        ir_signal = self.loader(
            state, signal.sample_rate, offset=self.offset, duration=self.duration,
            loudness_cutoff=None, num_channels=signal.num_channels,
        )["signal"]
        ir_signal.zero_pad_to(signal.sample_rate)
        return {"eq": eq, "ir_signal": ir_signal, "drr": drr}

    def _transform(self, signal, ir_signal, drr, eq):
        return signal.apply_ir(ir_signal.clone(), drr, eq,
                               use_original_phase=self.use_original_phase)


class VolumeNorm(BaseTransform):
    """Normalizes loudness to ``db`` LUFS."""

    def __init__(self, db: tuple = ("const", -24), name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.db = db

    def _instantiate(self, state):
        return {"db": util.sample_from_dist(self.db, state)}

    def _transform(self, signal, db):
        return signal.normalize(db)


class ClippingDistortion(BaseTransform):
    """Clips each item at a random percentile of its samples."""

    def __init__(self, perc: tuple = ("uniform", 0.0, 0.1), name: str = None,
                 prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.perc = perc

    def _instantiate(self, state):
        return {"perc": util.sample_from_dist(self.perc, state)}

    def _transform(self, signal, perc):
        return signal.clip_distortion(perc)


class Quantization(BaseTransform):
    """Uniform quantization to a random number of levels."""

    def __init__(self, channels: tuple = ("choice", [8, 32, 128, 256, 1024]),
                 name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.channels = channels

    def _instantiate(self, state):
        return {"channels": util.sample_from_dist(self.channels, state)}

    def _transform(self, signal, channels):
        return signal.quantization(channels)


class MuLawQuantization(BaseTransform):
    """Mu-law quantization to a random number of levels."""

    def __init__(self, channels: tuple = ("choice", [8, 32, 128, 256, 1024]),
                 name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.channels = channels

    def _instantiate(self, state):
        return {"channels": util.sample_from_dist(self.channels, state)}

    def _transform(self, signal, channels):
        return signal.mulaw_quantization(channels)


class NoiseFloor(BaseTransform):
    """Adds white noise at ``db`` LUFS (drawn and metered on the host)."""

    def __init__(self, db: tuple = ("const", -50.0), name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.db = db

    def _instantiate(self, state, signal: AudioSignal):
        db = util.sample_from_dist(self.db, state)
        noise = state.randn(signal.num_channels, signal.signal_length)
        nz_signal = AudioSignal(noise.astype("float32"), signal.sample_rate, device="cpu")
        return {"nz_signal": nz_signal.normalize(db)}

    def _transform(self, signal, nz_signal):
        return signal + nz_signal


class CrossTalk(BaseTransform):
    """Mixes in a speaker from ``sources`` at a random SNR, then restores the
    dry signal's loudness."""

    def __init__(self, snr: tuple = ("uniform", 0.0, 10.0), sources: List[str] = None,
                 weights: List[float] = None, name: str = None, prob: float = 1.0,
                 loudness_cutoff: float = -40):
        super().__init__(name=name, prob=prob)
        self.snr = snr
        self.loader = AudioLoader(sources, weights)
        self.loudness_cutoff = loudness_cutoff

    def _instantiate(self, state, signal: AudioSignal):
        snr = util.sample_from_dist(self.snr, state)
        loaded = self.loader(
            state, signal.sample_rate, duration=signal.signal_duration,
            loudness_cutoff=self.loudness_cutoff, num_channels=signal.num_channels,
        )
        return {"crosstalk_signal": loaded["signal"], "snr": snr}

    def _transform(self, signal, crosstalk_signal, snr):
        level = signal.loudness()
        return signal.mix(crosstalk_signal.clone(), snr).normalize(level)


class VolumeChange(BaseTransform):
    """Changes the level by a random number of dB."""

    def __init__(self, db: tuple = ("uniform", -12.0, 0.0), name: str = None,
                 prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.db = db

    def _instantiate(self, state):
        return {"db": util.sample_from_dist(self.db, state)}

    def _transform(self, signal, db):
        return signal.volume_change(db)


class GlobalVolumeNorm(BaseTransform):
    """Normalizes by the source file's loudness (the ``loudness`` entry of
    the signal's metadata, as a manifest column gives it) instead of the
    excerpt's, so quiet excerpts of loud files stay quiet. Without that
    entry the level is left as it is."""

    def __init__(self, db: tuple = ("const", -24), name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.db = db

    def _instantiate(self, state, signal: AudioSignal):
        source_db = signal.metadata.get("loudness")
        if source_db is None or float(source_db) == float("-inf"):
            return {"db": 0.0}
        return {"db": util.sample_from_dist(self.db, state) - float(source_db)}

    def _transform(self, signal, db):
        return signal.volume_change(db)


class Silence(BaseTransform):
    """Zeros the signal, keeping its loudness and STFT parameters."""

    def __init__(self, name: str = None, prob: float = 0.1):
        super().__init__(name=name, prob=prob)

    def _transform(self, signal):
        silent = AudioSignal(torch.zeros_like(signal.audio_data), sample_rate=signal.sample_rate,
                             stft_params=signal.stft_params)
        # later SNR-relative mixes dose their noise against the level before
        silent._loudness = signal._loudness
        return silent


class LowPass(BaseTransform):
    """Windowed-sinc low-pass at a random cutoff; the least cutoff the
    distribution can give sizes the sinc support."""

    def __init__(self, cutoff: tuple = ("choice", [4000, 8000, 16000]), zeros: int = 51,
                 name: str = None, prob: float = 1):
        super().__init__(name=name, prob=prob)
        self.cutoff = cutoff
        self.zeros = zeros
        self._min_cutoff = util.dist_lower_bound(cutoff, default=40.0)

    def _instantiate(self, state):
        return {"cutoff": util.sample_from_dist(self.cutoff, state)}

    def _transform(self, signal, cutoff):
        return signal.low_pass(cutoff, zeros=self.zeros, min_cutoff_hz=self._min_cutoff)


class HighPass(BaseTransform):
    """Windowed-sinc high-pass at a random cutoff; the least cutoff the
    distribution can give sizes the sinc support."""

    def __init__(self, cutoff: tuple = ("choice", [50, 100, 250, 500, 1000]), zeros: int = 51,
                 name: str = None, prob: float = 1):
        super().__init__(name=name, prob=prob)
        self.cutoff = cutoff
        self.zeros = zeros
        self._min_cutoff = util.dist_lower_bound(cutoff, default=40.0)

    def _instantiate(self, state):
        return {"cutoff": util.sample_from_dist(self.cutoff, state)}

    def _transform(self, signal, cutoff):
        return signal.high_pass(cutoff, zeros=self.zeros, min_cutoff_hz=self._min_cutoff)


class RescaleAudio(BaseTransform):
    """Scales down items whose peak exceeds ``val``."""

    def __init__(self, val: float = 1.0, name: str = None, prob: float = 1):
        super().__init__(name=name, prob=prob)
        self.val = val

    def _transform(self, signal):
        return signal.ensure_max_of_audio(self.val)


class ShiftPhase(SpectralTransform):
    """Adds a random constant to the phase."""

    def __init__(self, shift: tuple = ("uniform", -np.pi, np.pi), name: str = None,
                 prob: float = 1):
        super().__init__(name=name, prob=prob)
        self.shift = shift

    def _instantiate(self, state):
        return {"shift": util.sample_from_dist(self.shift, state)}

    def _transform(self, signal, shift):
        return signal.shift_phase(shift)


class InvertPhase(ShiftPhase):
    """Shifts the phase by pi."""

    def __init__(self, name: str = None, prob: float = 1):
        super().__init__(("const", np.pi), name=name, prob=prob)


class CorruptPhase(SpectralTransform):
    """Adds Gaussian noise of a random scale to the phase of every cell
    (the noise plane drawn on the host at instantiate time)."""

    def __init__(self, scale: tuple = ("uniform", 0, np.pi), name: str = None,
                 prob: float = 1):
        super().__init__(name=name, prob=prob)
        self.scale = scale

    def _instantiate(self, state, signal: AudioSignal = None):
        scale = util.sample_from_dist(self.scale, state)
        corruption = state.normal(scale=scale, size=signal.phase.shape[1:])
        return {"corruption": corruption.astype("float32")}

    def _transform(self, signal, corruption):
        return signal.shift_phase(shift=corruption)


class FrequencyMask(SpectralTransform):
    """SpecAug frequency mask: a band of random center and width, as
    fractions of Nyquist."""

    def __init__(self, f_center: tuple = ("uniform", 0.0, 1.0),
                 f_width: tuple = ("const", 0.1), name: str = None, prob: float = 1):
        super().__init__(name=name, prob=prob)
        self.f_center = f_center
        self.f_width = f_width

    def _instantiate(self, state, signal: AudioSignal):
        center = util.sample_from_dist(self.f_center, state)
        width = util.sample_from_dist(self.f_width, state)
        nyquist = signal.sample_rate / 2
        return {"fmin_hz": nyquist * max(center - width / 2, 0.0),
                "fmax_hz": nyquist * min(center + width / 2, 1.0)}

    def _transform(self, signal, fmin_hz: float, fmax_hz: float):
        return signal.mask_frequencies(fmin_hz=fmin_hz, fmax_hz=fmax_hz)


class TimeMask(SpectralTransform):
    """SpecAug time mask: a span of random center and width, as fractions
    of the duration."""

    def __init__(self, t_center: tuple = ("uniform", 0.0, 1.0),
                 t_width: tuple = ("const", 0.025), name: str = None, prob: float = 1):
        super().__init__(name=name, prob=prob)
        self.t_center = t_center
        self.t_width = t_width

    def _instantiate(self, state, signal: AudioSignal):
        center = util.sample_from_dist(self.t_center, state)
        width = util.sample_from_dist(self.t_width, state)
        dur = signal.signal_duration
        return {"tmin_s": dur * max(center - width / 2, 0.0),
                "tmax_s": dur * min(center + width / 2, 1.0)}

    def _transform(self, signal, tmin_s: float, tmax_s: float):
        return signal.mask_timesteps(tmin_s=tmin_s, tmax_s=tmax_s)


class MaskLowMagnitudes(SpectralTransform):
    """Zeros the cells below a random level in dB."""

    def __init__(self, db_cutoff: tuple = ("uniform", -10, 10), name: str = None,
                 prob: float = 1):
        super().__init__(name=name, prob=prob)
        self.db_cutoff = db_cutoff

    def _instantiate(self, state, signal: AudioSignal = None):
        return {"db_cutoff": util.sample_from_dist(self.db_cutoff, state)}

    def _transform(self, signal, db_cutoff: float):
        return signal.mask_low_magnitudes(db_cutoff)


class Smoothing(BaseTransform):
    """Circular convolution with a random window, rescaled to the input's
    peak."""

    def __init__(self, window_type: tuple = ("const", "average"),
                 window_length: tuple = ("choice", [8, 16, 32, 64, 128, 256, 512]),
                 name: str = None, prob: float = 1):
        super().__init__(name=name, prob=prob)
        self.window_type = window_type
        self.window_length = window_length

    def _instantiate(self, state, signal: AudioSignal = None):
        window = signal.get_window(
            window_type=util.sample_from_dist(self.window_type, state),
            window_length=util.sample_from_dist(self.window_length, state),
        )
        return {"window": AudioSignal(window, signal.sample_rate, device="cpu")}

    @staticmethod
    def _peak(x):
        peak = torch.abs(x).amax(dim=-1, keepdim=True)
        return torch.where(peak == 0.0, 1.0, peak)

    def _transform(self, signal, window):
        in_peak = self._peak(signal.audio_data)
        out = signal.convolve(window)
        return out * (in_peak / self._peak(out.audio_data))


def _draw_bin_noise(state, signal: AudioSignal) -> dict:
    """Magnitude, then phase noise planes shaped like one item's STFT."""
    shape = signal.phase.shape[1:]
    return {"mag_noise": state.randn(*shape).astype("float32"),
            "phase_noise": state.randn(*shape).astype("float32")}


def _refill_masked_bins(signal, mag_noise, phase_noise):
    """Replace the cells a mask zeroed (magnitude and phase both 0) with the
    noise planes.

    As in the JAX package (and the original library), a cell that was
    exactly zero before the mask (in a frame of digital silence) is filled
    too: ``AudioSignal.phase`` reads 0 at every exactly-zero cell, whatever
    sign the FFT gave its zeros, so the CPU and the card fill the cells the
    JAX package fills. They can differ only where one device's FFT cancels
    to an exact zero and the other's leaves a rounding residue."""
    mag, phase = signal.magnitude, signal.phase
    hole = (mag == 0.0) & (phase == 0.0)
    mag_noise = util.ensure_tensor(mag_noise, device=mag.device)
    phase_noise = util.ensure_tensor(phase_noise, device=mag.device)
    signal.stft_data = _polar(torch.where(hole, mag_noise, mag),
                              torch.where(hole, phase_noise, phase))
    return signal


class TimeNoise(TimeMask):
    """Replaces a random span of frames with noise drawn at instantiate
    time."""

    def _instantiate(self, state, signal: AudioSignal):
        kwargs = super()._instantiate(state, signal)
        kwargs.update(_draw_bin_noise(state, signal))
        return kwargs

    def _transform(self, signal, tmin_s, tmax_s, mag_noise, phase_noise):
        signal = signal.mask_timesteps(tmin_s=tmin_s, tmax_s=tmax_s, val=0.0)
        return _refill_masked_bins(signal, mag_noise, phase_noise)


class FrequencyNoise(FrequencyMask):
    """Replaces a random band of bins with noise drawn at instantiate
    time."""

    def _instantiate(self, state, signal: AudioSignal):
        kwargs = super()._instantiate(state, signal)
        kwargs.update(_draw_bin_noise(state, signal))
        return kwargs

    def _transform(self, signal, fmin_hz, fmax_hz, mag_noise, phase_noise):
        signal = signal.mask_frequencies(fmin_hz=fmin_hz, fmax_hz=fmax_hz)
        return _refill_masked_bins(signal, mag_noise, phase_noise)


class SpectralDenoising(Equalizer):
    """Spectral-gate denoising against a white noise (drawn on the host)
    that is normalized to ``nz_volume`` LUFS and EQ-ed."""

    def __init__(self, eq_amount: tuple = ("const", 1.0),
                 denoise_amount: tuple = ("uniform", 0.8, 1.0), nz_volume: float = -40,
                 n_bands: int = 6, n_freq: int = 3, n_time: int = 5, name: str = None,
                 prob: float = 1):
        super().__init__(eq_amount=eq_amount, n_bands=n_bands, name=name, prob=prob)
        from ..ml.layers import SpectralGate

        self.nz_volume = nz_volume
        self.denoise_amount = denoise_amount
        self.spectral_gate = SpectralGate(n_freq, n_time)

    def _instantiate(self, state):
        kwargs = super()._instantiate(state)
        kwargs["denoise_amount"] = util.sample_from_dist(self.denoise_amount, state)
        kwargs["nz"] = AudioSignal(state.randn(22050).astype("float32"), 44100, device="cpu")
        return kwargs

    def _transform(self, signal, nz, eq, denoise_amount):
        # on a clone: the effects change their signal, and ``nz`` belongs to
        # the caller's arguments, which a second application must find as drawn
        nz = nz.clone().normalize(self.nz_volume).equalizer(eq)
        return self.spectral_gate(signal, nz, denoise_amount)
