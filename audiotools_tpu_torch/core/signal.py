"""AudioSignal: a batch of audio as one ``(B, C, T)`` tensor.

Counterpart of the augmentation-path subset of
``audiotools_tpu/core/signal.py``. The class holds tensors and host
metadata and no parameters, so it is a plain class (not an
``nn.Module``). Signals read from files hold CPU tensors until the loader
moves the collated batch to the device.
"""
import copy
import pathlib

import numpy as np
import torch
import torch.nn.functional as F

from . import util
from ._effects import EffectMixin, ImpulseResponseMixin
from .loudness import LoudnessMixin
from ..ops import resample as _resample


class AudioSignal(EffectMixin, LoudnessMixin, ImpulseResponseMixin):
    """Batched audio with its sample rate.

    >>> signal = AudioSignal(np.zeros(44100, np.float32), 44100)
    >>> signal = AudioSignal("speech.wav", offset=1.0, duration=5.0)
    """

    def __init__(self, audio_path_or_array, sample_rate: int = None,
                 offset: float = 0, duration: float = None, device=None):
        self.path_to_file = None
        self._audio_data = None
        self._loudness = None
        self.original_signal_length = None
        source = audio_path_or_array
        if isinstance(source, (list, tuple)):
            source = np.asarray(source)
        if isinstance(source, (str, pathlib.Path)):
            self.load_from_file(source, offset=offset, duration=duration, device=device)
        elif isinstance(source, (np.ndarray, torch.Tensor)):
            if sample_rate is None:
                raise ValueError("sample_rate is required when constructing from an array")
            self.load_from_array(source, sample_rate, device=device)
        else:
            raise ValueError(
                f"Cannot build an AudioSignal from {type(source).__name__}: expected "
                "a path, a numpy array, a tensor, or a list of samples."
            )
        self.metadata = {"offset": offset, "duration": duration}

    # -- constructors ---------------------------------------------------

    @classmethod
    def excerpt(cls, audio_path, offset=None, duration=None, state=None, **kwargs):
        """``duration`` seconds from a start drawn uniformly in
        ``[offset or 0, file_duration - duration]``."""
        total = util.info(audio_path).duration
        state = util.random_state(state)
        offset = state.uniform(offset or 0, max(total - duration, 0))
        signal = cls(audio_path, offset=offset, duration=duration, **kwargs)
        signal.metadata.update(offset=offset, duration=duration)
        return signal

    @classmethod
    def salient_excerpt(cls, audio_path, loudness_cutoff=None, num_tries=8,
                        state=None, **kwargs):
        """An excerpt louder than ``loudness_cutoff`` LUFS, metered on the
        host: the first draw alone, then (if it misses) the remaining
        ``num_tries - 1`` draws in one batched meter call, taking the first
        that passes (or the last). ``num_tries=None`` retries until one passes."""
        from ..ops.loudness import host_loudness

        state = util.random_state(state)
        excerpt = cls.excerpt(audio_path, state=state, **kwargs)
        if loudness_cutoff is None:
            return excerpt
        loudness = host_loudness(excerpt.audio_data.numpy(), excerpt.sample_rate,
                                 dtype=np.float32)
        while np.max(loudness) <= loudness_cutoff:
            n_rest = 7 if num_tries is None else max(int(num_tries) - 1, 0)
            if n_rest == 0:
                break
            cands = [cls.excerpt(audio_path, state=state, **kwargs) for _ in range(n_rest)]
            louds = np.atleast_1d(host_loudness(
                np.concatenate([c.audio_data.numpy() for c in cands], axis=0),
                cands[0].sample_rate, dtype=np.float32,
            ))
            passing = np.flatnonzero(louds > loudness_cutoff)
            pick = int(passing[0]) if passing.size else n_rest - 1
            excerpt, loudness = cands[pick], louds[pick]
            if num_tries is not None:
                break
        excerpt._loudness = torch.as_tensor(np.asarray(loudness, dtype=np.float32))
        return excerpt

    @classmethod
    def zeros(cls, duration, sample_rate, num_channels=1, batch_size=1, **kwargs):
        """All-zero signal of ``duration`` seconds."""
        n_samples = int(duration * sample_rate)
        return cls(np.zeros((batch_size, num_channels, n_samples), np.float32),
                   sample_rate, **kwargs)

    @classmethod
    def batch(cls, audio_signals: list, pad_signals: bool = False,
              truncate_signals: bool = False, resample: bool = False, dim: int = 0):
        """Concatenate signals along ``dim``; mixed sample rates or lengths
        must be reconciled by ``resample`` / ``pad_signals`` /
        ``truncate_signals``."""
        rates = {x.sample_rate for x in audio_signals}
        if len(rates) > 1:
            if not resample:
                raise RuntimeError(f"Cannot batch signals with mixed sample rates "
                                   f"{sorted(rates)}; pass resample=True.")
            for x in audio_signals:
                x.resample(audio_signals[0].sample_rate)
        lengths = [x.signal_length for x in audio_signals]
        if len(set(lengths)) > 1:
            if pad_signals:
                for x in audio_signals:
                    x.zero_pad(0, max(lengths) - x.signal_length)
            elif truncate_signals:
                for x in audio_signals:
                    x.truncate_samples(min(lengths))
            else:
                raise RuntimeError(f"Cannot batch signals of lengths {lengths}; pass "
                                   "pad_signals=True or truncate_signals=True.")
        stacked = cls(torch.cat([x.audio_data for x in audio_signals], dim=dim),
                      sample_rate=audio_signals[0].sample_rate)
        stacked.path_to_file = [x.path_to_file for x in audio_signals]
        return stacked

    def load_from_file(self, audio_path, offset, duration, device=None):
        """Decode a file on the host into a CPU tensor."""
        from ..io import load_audio

        data, sample_rate = load_audio(audio_path, offset=offset, duration=duration)
        if data.shape[-1] == 0:
            raise RuntimeError(f"Audio file {audio_path} with offset {offset} and "
                               f"duration {duration} is empty!")
        self.sample_rate = sample_rate
        self.path_to_file = audio_path
        self.audio_data = torch.from_numpy(np.ascontiguousarray(data, np.float32))
        self.original_signal_length = self.signal_length
        return self.to(device)

    def load_from_array(self, audio_array, sample_rate, device=None):
        """Wrap an array as ``(B, C, T)`` (a numpy array shares its memory)."""
        data = audio_array
        if isinstance(data, np.ndarray):
            data = torch.from_numpy(np.ascontiguousarray(data))
        if data.dtype == torch.float64:
            data = data.float()
        self.sample_rate = sample_rate
        self.audio_data = data
        self.original_signal_length = self.signal_length
        return self.to(device)

    def clone(self):
        """Copy holding the same (immutable by convention) tensors."""
        clone = type(self)(self.audio_data, self.sample_rate)
        clone._loudness = self._loudness
        clone.path_to_file = copy.deepcopy(self.path_to_file)
        clone.metadata = copy.deepcopy(self.metadata)
        clone.original_signal_length = self.original_signal_length
        return clone

    # -- signal ops -----------------------------------------------------

    def to_mono(self):
        self.audio_data = self.audio_data.mean(dim=1, keepdim=True)
        return self

    def resample(self, sample_rate: int):
        """Polyphase resample to ``sample_rate`` (host numpy for CPU audio)."""
        if sample_rate == self.sample_rate:
            return self
        data = self.audio_data
        if data.device.type == "cpu":
            data = torch.from_numpy(_resample.resample(data.numpy(), self.sample_rate, sample_rate))
        else:
            data = _resample.resample(data, self.sample_rate, sample_rate)
        self.audio_data = data
        self.sample_rate = sample_rate
        return self

    def to(self, device=None):
        """Move the audio (and a cached loudness) to ``device``."""
        if device is None:
            return self
        self._audio_data = self._audio_data.to(device)
        if self._loudness is not None:
            self._loudness = self._loudness.to(device)
        return self

    def zero_pad(self, before: int, after: int):
        self.audio_data = F.pad(self.audio_data, (before, after))
        return self

    def zero_pad_to(self, length: int, mode: str = "after"):
        shortfall = max(length - self.signal_length, 0)
        return self.zero_pad(shortfall, 0) if mode == "before" else self.zero_pad(0, shortfall)

    def truncate_samples(self, length_in_samples: int):
        self.audio_data = self.audio_data[..., :length_in_samples]
        return self

    # -- properties -----------------------------------------------------

    @property
    def audio_data(self):
        """``(B, C, T)`` samples; setting them drops the cached loudness."""
        return self._audio_data

    @audio_data.setter
    def audio_data(self, data):
        if data is not None:
            while data.ndim < 3:
                data = data[None]
            if data.ndim != 3:
                raise ValueError(f"audio_data must be (B, C, T), got {tuple(data.shape)}")
        self._audio_data = data
        self._loudness = None

    @property
    def device(self):
        return self._audio_data.device

    @property
    def shape(self):
        return self.audio_data.shape

    @property
    def batch_size(self):
        return self.shape[0]

    @property
    def num_channels(self):
        return self.shape[1]

    @property
    def signal_length(self):
        return self.shape[-1]

    @property
    def signal_duration(self):
        return self.signal_length / self.sample_rate

    length = signal_length
    duration = signal_duration

    # -- indexing and selection -----------------------------------------

    def __getitem__(self, key):
        """Index the batch (int, slice, index list or bool mask), keeping a
        cached loudness aligned."""
        if isinstance(key, np.ndarray):
            key = torch.from_numpy(key)
        if isinstance(key, torch.Tensor):
            key = key.to(self.audio_data.device)
        out = type(self)(self.audio_data[key], self.sample_rate)
        if self._loudness is not None:
            out._loudness = torch.atleast_1d(self._loudness[key])
        out.original_signal_length = self.original_signal_length
        return out

    @classmethod
    def where(cls, mask, if_true: "AudioSignal", if_false: "AudioSignal"):
        """Per-item select between two signals of one shape."""
        mask = torch.as_tensor(np.asarray(mask) if not isinstance(mask, torch.Tensor) else mask)
        mask = mask.to(if_true.audio_data.device).reshape(-1)
        out = if_true.clone()
        out.audio_data = torch.where(mask[:, None, None], if_true.audio_data,
                                     if_false.audio_data)
        if if_true._loudness is not None and if_false._loudness is not None:
            out._loudness = torch.where(mask, if_true._loudness, if_false._loudness)
        return out
