"""Augmentation transforms of the main path.

Counterpart of ``audiotools_tpu/data/transforms.py`` for ``Compose``,
``Equalizer``, ``BackgroundNoise``, ``RoomImpulseResponse`` and
``VolumeNorm``. ``instantiate(state, signal)`` draws parameters on the
host with a numpy ``RandomState`` in the JAX package's order (a transform
of probability below 1 draws its Bernoulli mask after its parameters; one
of probability 1 draws none). ``transform(signal, **kwargs)`` applies the
effect to the items whose mask is true. Masks stay host numpy bools, so an
all-true mask is seen on the host and costs no device synchronization.
"""
from inspect import signature
from typing import List

import numpy as np
import torch

from ..core import AudioSignal
from ..core import util
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

    def transform(self, signal: AudioSignal, **kwargs):
        """Apply the transform where the mask is true: directly when the
        mask is a host array that is all true, else by computing all items
        and selecting per item."""
        tfm_kwargs = dict(self._prepare(kwargs))
        mask = tfm_kwargs.pop("mask")
        if not isinstance(mask, torch.Tensor) and np.all(mask):
            return self._transform(signal, **tfm_kwargs)
        original = signal.clone()
        transformed = self._transform(signal, **tfm_kwargs)
        return AudioSignal.where(mask, transformed, original)

    def __call__(self, *args, **kwargs):
        return self.transform(*args, **kwargs)

    def instantiate(self, state=None, signal: AudioSignal = None):
        """Draw this transform's parameters, then (for ``prob < 1``) its mask."""
        state = util.random_state(state)
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


class Compose(BaseTransform):
    """Applies transforms in sequence; children are addressed as
    ``"{position}.{name}"``."""

    def __init__(self, *transforms, name: str = None, prob: float = 1.0):
        if isinstance(transforms[0], list):
            transforms = transforms[0]
        for position, tfm in enumerate(transforms):
            tfm.name = f"{position}.{tfm.name}"
        self.transforms = list(transforms)
        super().__init__(keys=[tfm.name for tfm in self.transforms], name=name, prob=prob)

    def _transform(self, signal, **kwargs):
        for tfm in self.transforms:
            signal = tfm(signal, **kwargs)
        return signal

    def _instantiate(self, state, signal: AudioSignal = None):
        drawn = {}
        for tfm in self.transforms:
            drawn.update(tfm.instantiate(state, signal=signal))
        return drawn


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
