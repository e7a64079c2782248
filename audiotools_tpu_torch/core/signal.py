"""AudioSignal: a batch of audio as one ``(B, C, T)`` tensor.

Counterpart of ``audiotools_tpu/core/signal.py`` without its JAX pytree
plumbing. The class holds tensors and host metadata and no parameters,
so it is a plain class (not an ``nn.Module``). A signal built from a path or an array goes to the card
unless it is given ``device="cpu"``; the data loader decodes on the host
and moves each collated batch to the card.
"""
import copy
import hashlib
import pathlib
import tempfile
import warnings
from collections import namedtuple

import numpy as np
import torch
import torch.nn.functional as F

from . import util
from ._dsp import DSPMixin, _polar
from ._effects import EffectMixin, ImpulseResponseMixin
from .display import DisplayMixin
from .ffmpeg import FFMPEGMixin
from .loudness import LoudnessMixin
from .playback import PlayMixin
from .whisper import WhisperMixin
from ..ops import fft as _fft
from ..ops import resample as _resample
from ..ops._fp32 import strict_fp32

STFTParams = namedtuple(
    "STFTParams",
    ["window_length", "hop_length", "window_type", "match_stride", "padding_type"],
)
"""STFT parameters of a signal; a field left ``None`` is inferred from the
signal's sample rate (``AudioSignal.stft_params``)."""
STFTParams.__new__.__defaults__ = (None, None, None, None, None)


def _value(other):
    """The samples of an AudioSignal; any other operand as it is."""
    return other.audio_data if isinstance(other, AudioSignal) else other


class AudioSignal(EffectMixin, LoudnessMixin, PlayMixin, ImpulseResponseMixin, DSPMixin,
                  DisplayMixin, FFMPEGMixin, WhisperMixin):
    """Batched audio with its sample rate.

    >>> signal = AudioSignal(np.zeros(44100, np.float32), 44100)  # on the card
    >>> signal = AudioSignal("speech.wav", offset=1.0, duration=5.0, device="cpu")

    A signal built from a tensor holds that tensor itself, so losses over
    its STFT stay on the autograd graph of whatever produced it.
    """

    # the valid-frame count kept by stft(mesh=...) for istft(mesh=...)
    _stft_valid_frames = None

    def __init__(self, audio_path_or_array, sample_rate: int = None,
                 stft_params: STFTParams = None, offset: float = 0,
                 duration: float = None, device=None):
        self.path_to_file = None
        self._audio_data = None
        self._stft_data = None
        self._loudness = None
        self.original_signal_length = None
        source = audio_path_or_array
        if isinstance(source, (list, tuple)):
            source = np.asarray(source)
        if isinstance(source, (str, pathlib.Path)):
            self.load_from_file(source, offset=offset, duration=duration,
                                device=device or util.default_device())
        elif isinstance(source, (np.ndarray, torch.Tensor)):
            if sample_rate is None:
                raise ValueError("sample_rate is required when constructing from an array")
            if device is None and isinstance(source, np.ndarray):
                device = util.default_device()  # a tensor stays where it is
            self.load_from_array(source, sample_rate, device=device)
        else:
            raise ValueError(
                f"Cannot build an AudioSignal from {type(source).__name__}: expected "
                "a path, a numpy array, a tensor, or a list of samples."
            )
        self.stft_params = stft_params
        self.metadata = {"offset": offset, "duration": duration}

    @property
    def path_to_input_file(self):
        """The file the signal was read from (alias of ``path_to_file``)."""
        return self.path_to_file

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
        that passes (or the last). ``num_tries=None`` retries until one passes.
        The chosen excerpt, and its loudness, then go to ``device`` (the card
        unless told otherwise)."""
        from ..ops.loudness import host_loudness

        device = kwargs.pop("device", None)
        state = util.random_state(state)
        excerpt = cls.excerpt(audio_path, state=state, device="cpu", **kwargs)
        if loudness_cutoff is None:
            return excerpt.to(device or util.default_device())
        loudness = host_loudness(excerpt.audio_data.numpy(), excerpt.sample_rate,
                                 dtype=np.float32)
        while np.max(loudness) <= loudness_cutoff:
            n_rest = 7 if num_tries is None else max(int(num_tries) - 1, 0)
            if n_rest == 0:
                break
            cands = [cls.excerpt(audio_path, state=state, device="cpu", **kwargs)
                     for _ in range(n_rest)]
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
        return excerpt.to(device or util.default_device())

    @classmethod
    def zeros(cls, duration, sample_rate, num_channels=1, batch_size=1, **kwargs):
        """All-zero signal of ``duration`` seconds."""
        n_samples = int(duration * sample_rate)
        return cls(np.zeros((batch_size, num_channels, n_samples), np.float32),
                   sample_rate, **kwargs)

    @classmethod
    def wave(cls, frequency, duration, sample_rate, num_channels=1, shape="sine", **kwargs):
        """A ``"sine"``, ``"square"``, ``"sawtooth"`` or ``"triangle"`` wave of
        ``frequency`` Hz and ``duration`` seconds, drawn on the host in
        float64 and stored as float32 (``kwargs``, e.g. ``device``, go to the
        constructor)."""
        import scipy.signal as sps

        t = np.linspace(0, duration, int(duration * sample_rate))
        generators = {
            "sawtooth": lambda ph: sps.sawtooth(ph, 0.5),
            "square": sps.square,
            "sine": np.sin,
            # folding by abs() halves the period: drive it at half the phase
            "triangle": lambda ph: 1.0 - 2.0 * np.abs(sps.sawtooth(ph / 2, 0.5)),
        }
        if shape not in generators:
            raise ValueError(f"Invalid shape {shape}")
        wave_data = generators[shape](2 * np.pi * frequency * t).astype(np.float32)
        return cls(np.tile(wave_data[None, None, :], (1, num_channels, 1)), sample_rate, **kwargs)

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
        """Decode a file on the host, then move it to ``device``."""
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
        """Wrap an array as ``(B, C, T)`` on ``device`` (a numpy array kept
        on the host shares its memory)."""
        data = audio_array
        if isinstance(data, np.ndarray):
            data = torch.from_numpy(np.ascontiguousarray(data))
        if data.dtype == torch.float64:
            data = data.float()
        self.sample_rate = sample_rate
        self.audio_data = data
        self.original_signal_length = self.signal_length
        return self.to(device)

    def write(self, audio_path, subtype: str = "PCM_16"):
        """Write the first item to ``audio_path`` (``io.save_audio``), warning
        when samples beyond [-1, 1] are clipped, and remember the path."""
        from ..io import save_audio

        data = self.audio_data[0].detach().cpu().numpy()
        if np.abs(data).max() > 1:
            warnings.warn("Audio amplitude > 1 clipped when saving")
        save_audio(str(audio_path), data, self.sample_rate, subtype=subtype)
        self.path_to_file = audio_path
        return self

    def copy(self):
        """Shallow copy: the same tensors and metadata objects."""
        return copy.copy(self)

    def deepcopy(self):
        """Deep copy: tensors and metadata copied."""
        return copy.deepcopy(self)

    def clone(self):
        """Copy holding the same (immutable by convention) tensors, the
        cached STFT included."""
        clone = type(self)(self.audio_data, self.sample_rate, stft_params=self.stft_params)
        clone._stft_data = self._stft_data
        clone._loudness = self._loudness
        clone.path_to_file = copy.deepcopy(self.path_to_file)
        clone.metadata = copy.deepcopy(self.metadata)
        clone.original_signal_length = self.original_signal_length
        return clone

    def detach(self):
        """Cut the audio, the cached STFT and loudness from the autograd graph."""
        if self._loudness is not None:
            self._loudness = self._loudness.detach()
        if self._stft_data is not None:
            self._stft_data = self._stft_data.detach()
        self._audio_data = self._audio_data.detach()
        return self

    def hash(self):
        """SHA-256 of the first item written as a 16-bit WAV."""
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            self.write(f.name)
            h = hashlib.sha256()
            with open(f.name, "rb") as g:
                for block in iter(lambda: g.read(128 * 1024), b""):
                    h.update(block)
        return h.hexdigest()

    # -- signal ops -----------------------------------------------------

    def to_mono(self):
        self.audio_data = self.audio_data.mean(dim=1, keepdim=True)
        return self

    def resample(self, sample_rate: int, mesh=None, axis_name: str = "sp"):
        """Polyphase resample to ``sample_rate`` (host numpy for CPU audio).

        ``mesh``: a ``DeviceMesh`` routes audio time-sharded over
        ``mesh[axis_name]`` (``parallel.shard_signal``) through the
        sequence-parallel resampler (``parallel.timeshard.sharded_resample``).
        """
        if sample_rate == self.sample_rate:
            return self
        data = self.audio_data
        if mesh is not None:
            from ..parallel.timeshard import sharded_resample

            data = sharded_resample(data, self.sample_rate, sample_rate, mesh,
                                    axis_name=axis_name)
        elif data.device.type == "cpu":
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
        if self._stft_data is not None:
            self._stft_data = self._stft_data.to(device)
        if self._loudness is not None:
            self._loudness = self._loudness.to(device)
        return self

    def cpu(self):
        return self.to("cpu")

    def cuda(self):
        """Move to the card (raising without one)."""
        return self.to(util.default_device())

    def float(self):
        """Cast the audio to float32."""
        self.audio_data = self.audio_data.float()
        return self

    def numpy(self):
        """The audio as a host numpy array, cut from the autograd graph."""
        return self.audio_data.detach().cpu().numpy()

    def quantize_wire(self, dtype: str = "int16"):
        """Quantize the audio for the host-to-card copy: ``round(32768 x)``
        clipped to int16, half the bytes of float32 at an error of at most
        2**-16 (1.53e-5). Audio that is int16 already stays as it is, so a second call
        changes nothing. The cached loudness is kept. Undone by
        :meth:`dequantize_wire`."""
        if dtype != "int16":
            raise ValueError(f"unsupported wire dtype {dtype!r}")
        x = self._audio_data
        if x.dtype != torch.int16:
            self._audio_data = torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int16)
        return self

    def dequantize_wire(self):
        """Undo :meth:`quantize_wire`; float audio is left as it is."""
        if self._audio_data.dtype == torch.int16:
            self._audio_data = self._audio_data.float() / 32768.0
        return self

    def zero_pad(self, before: int, after: int):
        self.audio_data = F.pad(self.audio_data, (before, after))
        return self

    def zero_pad_to(self, length: int, mode: str = "after"):
        shortfall = max(length - self.signal_length, 0)
        return self.zero_pad(shortfall, 0) if mode == "before" else self.zero_pad(0, shortfall)

    def trim(self, before: int, after: int):
        """Drop ``before`` samples at the start and ``after`` at the end."""
        self.audio_data = self.audio_data[..., before:self.signal_length - after]
        return self

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

    samples = audio_data

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

    # -- STFT -----------------------------------------------------------

    @property
    def stft_data(self):
        """``(B, C, F, T)`` complex spectrogram cached by :meth:`stft`."""
        return self._stft_data

    @stft_data.setter
    def stft_data(self, data):
        if data is not None:
            data = torch.as_tensor(data)
            if not data.is_complex():
                raise ValueError(f"stft_data must be complex, got {data.dtype}")
            if self._stft_data is not None and self._stft_data.shape != data.shape:
                warnings.warn("stft_data changed shape")
        self._stft_data = data

    @staticmethod
    def get_window(window_type: str, window_length: int, device=None):
        """Periodic window ``(window_length,)`` (``ops.fft.get_window``, with
        ``"average"`` and ``"sqrt_hann"``) on ``device``, the CPU by default."""
        return torch.from_numpy(_fft.get_window(window_type, window_length).copy()).to(device)

    @property
    def stft_params(self):
        """STFT parameters, with unspecified fields inferred from the sample
        rate: a window of ``2 ** ceil(log2(0.032 sr))``, a quarter of it as
        hop, Hann, no stride matching, reflect padding."""
        return self._stft_params

    @stft_params.setter
    def stft_params(self, value: STFTParams):
        default_win_len = _fft.default_win_length(self.sample_rate)
        defaults = STFTParams(window_length=default_win_len, hop_length=default_win_len // 4,
                              window_type="hann", match_stride=False,
                              padding_type="reflect")._asdict()
        value = value._asdict() if value else defaults
        for key in defaults:
            if value[key] is None:
                value[key] = defaults[key]
        self._stft_params = STFTParams(**value)
        self._stft_data = None

    def compute_stft_padding(self, window_length: int, hop_length: int, match_stride: bool):
        """``(right_pad, pad)`` around the audio before the STFT."""
        return _fft.compute_stft_padding(self.signal_length, window_length, hop_length,
                                         match_stride)

    def _fill_stft_args(self, window_length, hop_length, window_type, match_stride,
                        padding_type=None):
        """Unspecified STFT arguments from ``self.stft_params``."""
        p = self.stft_params
        return (
            p.window_length if window_length is None else int(window_length),
            p.hop_length if hop_length is None else int(hop_length),
            p.window_type if window_type is None else window_type,
            p.match_stride if match_stride is None else match_stride,
            p.padding_type if padding_type is None else padding_type,
        )

    def stft(self, window_length: int = None, hop_length: int = None,
             window_type: str = None, match_stride: bool = None,
             padding_type: str = None, method: str = "fft", mesh=None,
             axis_name: str = "sp"):
        """Compute the STFT ``(B, C, F, T)`` (``ops.fft.stft``, ``method``
        ``"fft"`` or ``"matmul"``), cache it in ``stft_data`` and return it.

        ``mesh``: a ``DeviceMesh`` routes audio time-sharded over
        ``mesh[axis_name]`` through the sequence-parallel STFT
        (``parallel.timeshard.sharded_stft``): the frames come back sharded
        along the frame axis, padded to the same count on every shard, and
        the valid count is kept for ``istft(mesh=...)``. It takes
        ``match_stride=False`` and reflect padding only.
        """
        (window_length, hop_length, window_type, match_stride,
         padding_type) = self._fill_stft_args(window_length, hop_length, window_type,
                                              match_stride, padding_type)
        if mesh is not None:
            if match_stride:
                raise ValueError("the sequence-parallel STFT implements "
                                 "match_stride=False (torch.stft center=True) only")
            if padding_type not in (None, "reflect"):
                raise ValueError("the sequence-parallel STFT implements reflect "
                                 f"center padding only, got {padding_type!r}")
            from ..parallel.timeshard import sharded_stft

            self._stft_data, self._stft_valid_frames = sharded_stft(
                self.audio_data, window_length, hop_length, mesh, window_type=window_type,
                axis_name=axis_name, method=method)
            return self._stft_data
        self._stft_data = _fft.stft(self.audio_data, window_length, hop_length, window_type,
                                    match_stride, padding_type, method=method)
        self._stft_valid_frames = None
        return self._stft_data

    def istft(self, window_length: int = None, hop_length: int = None,
              window_type: str = None, match_stride: bool = None, length: int = None,
              mesh=None, axis_name: str = "sp"):
        """Inverse STFT of ``stft_data`` into ``audio_data`` (fp32), cut to
        ``length`` or to the original signal length.

        ``mesh``: inverts a spectrogram made by ``stft(mesh=...)`` with the
        sequence-parallel overlap-add (``parallel.timeshard.sharded_istft``)
        and the valid-frame count that call kept; the audio comes back
        time-sharded, all of it (``length``, if given, must be that length).
        """
        if self.stft_data is None:
            raise RuntimeError("Cannot do inverse STFT without self.stft_data!")
        window_length, hop_length, window_type, match_stride, _ = self._fill_stft_args(
            window_length, hop_length, window_type, match_stride)
        if mesh is not None:
            if match_stride:
                raise ValueError("the sequence-parallel ISTFT implements "
                                 "match_stride=False only")
            from ..parallel.timeshard import sharded_istft

            audio = sharded_istft(self.stft_data, window_length, hop_length, mesh,
                                  window_type=window_type, axis_name=axis_name,
                                  n_valid=self._stft_valid_frames)
            if length is not None and length != audio.shape[-1]:
                raise ValueError(f"the sequence-parallel ISTFT returns all "
                                 f"{audio.shape[-1]} samples, not length={length}")
            self.audio_data = audio
            return self
        self.audio_data = _fft.istft(
            self.stft_data, window_length, hop_length, window_type, match_stride,
            length=length,
            original_length=self.original_signal_length if length is None else None,
        )
        return self

    @staticmethod
    def get_mel_filters(sr, n_fft, n_mels, fmin=0.0, fmax=None):
        """Mel filterbank ``(n_mels, 1 + n_fft // 2)`` as a CPU tensor."""
        return torch.from_numpy(_fft.mel_filters(sr, n_fft, n_mels, fmin, fmax))

    def mel_spectrogram(self, n_mels=80, mel_fmin=0.0, mel_fmax=None, **kwargs):
        """Mel spectrogram ``(B, C, n_mels, T)``: ``|STFT|`` (``kwargs`` as
        :meth:`stft` takes them) projected on the mel basis in full fp32."""
        magnitude = self.stft(**kwargs).abs()
        n_fft = 2 * (magnitude.shape[2] - 1)
        (basis,) = _fft._on_device(
            _fft._mel_design, (self.sample_rate, n_fft, n_mels, mel_fmin, mel_fmax),
            magnitude.device,
        )
        with strict_fp32():
            return basis @ magnitude

    @staticmethod
    def get_dct(n_mfcc, n_mels, norm="ortho", device=None):
        """DCT-II matrix ``(n_mels, n_mfcc)`` (``ops.fft.dct_matrix``) on
        ``device``, the CPU by default."""
        return torch.from_numpy(_fft.dct_matrix(n_mfcc, n_mels, norm).copy()).to(device)

    def mfcc(self, n_mfcc=40, n_mels=80, log_offset=1e-6, **kwargs):
        """MFCCs ``(B, C, n_mfcc, T)``: the DCT of the log mel spectrogram
        (``kwargs`` as :meth:`mel_spectrogram` takes them), in full fp32."""
        log_mel = torch.log(self.mel_spectrogram(n_mels, **kwargs) + log_offset)
        (dct_t,) = _fft._on_device(_fft._dct_design, (n_mfcc, n_mels, "ortho"), log_mel.device)
        with strict_fp32():
            return dct_t @ log_mel

    @property
    def magnitude(self):
        """``|STFT|``, computing the STFT first if none is cached; setting
        it keeps the phase."""
        if self.stft_data is None:
            self.stft()
        return self.stft_data.abs()

    @magnitude.setter
    def magnitude(self, value):
        self.stft_data = _polar(value, self.phase)

    def log_magnitude(self, ref_value=1.0, amin=1e-5, top_db=80.0):
        """``|STFT|`` in dB (``ops.fft.log_magnitude``)."""
        return _fft.log_magnitude(self.magnitude, ref_value, amin, top_db)

    @property
    def phase(self):
        """STFT phase, computing the STFT first if none is cached; setting
        it keeps the magnitude."""
        if self.stft_data is None:
            self.stft()
        return self.stft_data.angle()

    @phase.setter
    def phase(self, value):
        self.stft_data = _polar(self.magnitude, value)

    # -- operators ------------------------------------------------------

    def __add__(self, other):
        out = self.clone()
        out.audio_data = out.audio_data + _value(other)
        return out

    def __iadd__(self, other):
        self.audio_data = self.audio_data + _value(other)
        return self

    def __radd__(self, other):
        return self + other

    def __sub__(self, other):
        out = self.clone()
        out.audio_data = out.audio_data - _value(other)
        return out

    def __isub__(self, other):
        self.audio_data = self.audio_data - _value(other)
        return self

    def __mul__(self, other):
        out = self.clone()
        out.audio_data = out.audio_data * _value(other)
        return out

    def __imul__(self, other):
        self.audio_data = self.audio_data * _value(other)
        return self

    def __rmul__(self, other):
        return self * other

    # -- text -----------------------------------------------------------

    def _info(self):
        dur = f"{self.signal_duration:0.3f}" if self.signal_duration else "[unknown]"
        return {
            "duration": f"{dur} seconds",
            "batch_size": self.batch_size,
            "path": self.path_to_file or "path unknown",
            "sample_rate": self.sample_rate,
            "num_channels": self.num_channels or "[unknown]",
            "audio_data.shape": tuple(self.audio_data.shape),
            "stft_params": self.stft_params,
            "device": self.device,
        }

    def markdown(self):
        """The signal's description as a markdown table."""
        rows = "".join(f"| {k} | {v} |\n" for k, v in self._info().items())
        return "| Key | Value \n|---|--- \n" + rows

    def __str__(self):
        return "".join(f"{k}: {v}\n" for k, v in self._info().items())

    def __rich__(self):
        from rich.table import Table

        table = Table(title=f"{self.__class__.__name__}")
        table.add_column("Key", style="green")
        table.add_column("Value", style="cyan")
        for key, value in self._info().items():
            table.add_row(key, str(value))
        return table

    # -- comparison -----------------------------------------------------

    def __eq__(self, other):
        """Whether every tensor the two signals hold (audio, cached STFT and
        loudness) agrees within 1e-6; prints the largest difference of the
        first that does not."""
        for k, v in list(self.__dict__.items()):
            if isinstance(v, torch.Tensor):
                ov = getattr(other, "__dict__", {}).get(k)
                if ov is None or not torch.allclose(v.detach().cpu(), ov.detach().cpu(),
                                                    atol=1e-6):
                    err = (float("inf") if ov is None
                           else float((v.detach().cpu() - ov.detach().cpu()).abs().max()))
                    print(f"Max abs error for {k}: {err}")
                    return False
        return True

    def __ne__(self, other):
        return not self == other

    # -- indexing and selection -----------------------------------------

    def __getitem__(self, key):
        """Index the batch, keeping the STFT parameters and co-indexing a
        cached STFT and loudness. ``key``: an int, slice, list, tuple, a
        bool or int array of at most one dimension, or a 0-d True (a
        signal of batch 1 as it is). A tuple that also indexes channels or
        samples drops the cached STFT and loudness."""
        if isinstance(key, (list, np.generic)):
            key = np.asarray(key)
        is_array = isinstance(key, (np.ndarray, torch.Tensor))
        if key is True or (is_array and key.ndim == 0 and key.dtype in (np.bool_, torch.bool)
                           and bool(key)):
            if self.batch_size != 1:
                raise ValueError(f"a 0-d True indexes a signal of batch 1, not {self.batch_size}")
            audio_data, loudness, stft_data = self.audio_data, self._loudness, self._stft_data
        elif isinstance(key, (int, slice, tuple)) or (is_array and key.ndim <= 1):
            if isinstance(key, np.ndarray):
                key = torch.from_numpy(key)
            if isinstance(key, torch.Tensor):
                key = key.to(self.audio_data.device)
            audio_data = self.audio_data[key]
            batch_key = key
            if isinstance(key, tuple):
                batch_key = key[0] if len(key) == 1 else None
            loudness = stft_data = None
            if batch_key is not None:
                if self._loudness is not None:
                    loudness = torch.atleast_1d(self._loudness[batch_key])
                if self._stft_data is not None:
                    stft_data = self._stft_data[batch_key]
                    while stft_data.ndim < 4:
                        stft_data = stft_data[None]
        else:
            raise ValueError(f"Unsupported key type: {type(key).__name__}")
        out = type(self)(audio_data, self.sample_rate, stft_params=self.stft_params)
        out._loudness = loudness
        out._stft_data = stft_data
        out.original_signal_length = self.original_signal_length
        return out

    def __setitem__(self, key, value):
        """Assign into the batch: a signal's audio (and its cached STFT and
        loudness, where both sides hold them) or samples to the items
        ``key`` selects. The tensors are replaced by updated copies, so
        signals that share them (clones) are not changed."""
        if isinstance(key, (list, np.generic)):
            key = np.asarray(key)
        if isinstance(key, np.ndarray):
            key = torch.from_numpy(key)
        if isinstance(key, torch.Tensor):
            key = key.to(self.audio_data.device)

        def assign(dst, src, reshape=False):
            out = dst.clone()
            src = torch.as_tensor(src, dtype=dst.dtype).to(dst.device)
            out[key] = src.reshape(out[key].shape) if reshape else src
            return out

        if not isinstance(value, type(self)):
            self._audio_data = assign(self.audio_data, value)
            return
        if (isinstance(key, torch.Tensor) and key.ndim == 0 and key.dtype == torch.bool
                and bool(key)) or key is True:
            if self.batch_size != 1:
                raise ValueError(f"a 0-d True indexes a signal of batch 1, not {self.batch_size}")
            self._audio_data = value.audio_data
            self._loudness = value._loudness
            self._stft_data = value._stft_data
            return
        self._audio_data = assign(self.audio_data, value.audio_data, reshape=True)
        if self._loudness is not None and value._loudness is not None:
            self._loudness = assign(self._loudness, value._loudness, reshape=True)
        if self._stft_data is not None and value._stft_data is not None:
            self._stft_data = assign(self._stft_data, value._stft_data, reshape=True)

    @classmethod
    def where(cls, mask, if_true: "AudioSignal", if_false: "AudioSignal"):
        """Per-item select between two signals of one shape: the audio, and
        the cached STFT and loudness where both sides hold one of equal
        shape (else the result holds none)."""
        mask = torch.as_tensor(np.asarray(mask) if not isinstance(mask, torch.Tensor) else mask)
        mask = mask.to(if_true.audio_data.device).reshape(-1)
        out = if_true.clone()
        out.audio_data = torch.where(mask[:, None, None], if_true.audio_data,
                                     if_false.audio_data)
        t, f = if_true._stft_data, if_false._stft_data
        out._stft_data = None
        if t is not None and f is not None and t.shape == f.shape:
            out._stft_data = torch.where(mask.reshape((-1,) + (1,) * (t.ndim - 1)), t, f)
        if if_true._loudness is not None and if_false._loudness is not None:
            out._loudness = torch.where(mask, if_true._loudness, if_false._loudness)
        return out
