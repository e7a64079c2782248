"""Host-side audio I/O.

Counterpart of ``audiotools_tpu/io/__init__.py``. WAV is decoded by the
native reader (``native.read_wav``), which hands the encodings it refuses
(A-law, mu-law) to the numpy codec (``wav.py``); FLAC by the native FLAC
codec (``native/flacio.cpp``); MP3 and Ogg through the system codec
libraries (``codecs.py``). Anything else (mp4/m4a/webm/mkv/aac/opus,
including the audio tracks of video containers) goes through the libav
shim (``native/avio.cpp``) where the system libavformat/libavcodec exist.
Decoding is host code; callers move the result to the device.
"""
from pathlib import Path

import numpy as np

from .._hostprof import span as _span
from .wav import WavInfo, read_wav, wav_info, write_wav

__all__ = ["load_audio", "save_audio", "audio_info", "WavInfo", "read_wav",
           "wav_info", "write_wav"]


def _unsupported(path, what="support"):
    return ValueError(
        f"Unsupported audio format '{Path(path).suffix}'. "
        f"Native {what}: .wav, .flac, .mp3, .ogg; other containers "
        "need the system libavformat/libavcodec libraries."
    )


def _info(sample_rate, num_frames, num_channels, bits):
    return WavInfo(sample_rate=sample_rate, num_frames=num_frames, num_channels=num_channels,
                   bits_per_sample=bits, format_tag=0, data_offset=0, data_size=0)


def audio_info(path):
    """File metadata (sample_rate, num_frames, duration) without decoding
    (mp3/ogg require a decode pass for an exact frame count)."""
    from .. import native

    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        return wav_info(path)
    if suffix == ".flac":
        sr, frames, ch, bits = native.flac_info(path)
        return _info(sr, frames, ch, bits)
    if suffix in (".mp3", ".ogg"):
        data, sr = load_audio(path)
        return _info(sr, data.shape[-1], data.shape[0], 16)
    if native.av_available():
        sr, frames, ch, _codec = native.av_info(path)
        return _info(sr, frames, ch, 16)
    raise _unsupported(path)


def load_audio(path, offset: float = 0.0, duration: float = None):
    """Decode audio as ``(C, T)`` float32 in [-1, 1] plus its sample rate."""
    with _span("decode"):
        return _load_audio(path, offset, duration)


def _load_audio(path, offset: float = 0.0, duration: float = None):
    from .. import native
    from . import codecs

    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        try:
            return native.read_wav(path, offset=offset, duration=duration)
        except ValueError:
            pass  # an encoding the native reader refuses (A-law, mu-law)
        return read_wav(path, offset=offset, duration=duration)
    if suffix == ".flac":
        return native.read_flac(path, offset=offset, duration=duration)
    if suffix == ".mp3":
        return codecs.read_mp3(path, offset=offset, duration=duration)
    if suffix == ".ogg":
        return codecs.read_ogg(path, offset=offset, duration=duration)
    if native.av_available():
        return native.read_av(path, offset=offset, duration=duration)
    raise _unsupported(path)


def save_audio(path, data: np.ndarray, sample_rate: int, subtype: str = "PCM_16"):
    """Encode ``(C, T)`` float audio to disk: WAV (``subtype`` as
    ``write_wav`` takes it), FLAC (16-bit, or 24 with ``"PCM_24"``), MP3,
    Ogg/Vorbis, or a libav container chosen by the extension."""
    from .. import native
    from . import codecs

    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        return write_wav(path, data, sample_rate, subtype=subtype)
    if suffix == ".flac":
        bits = 24 if subtype == "PCM_24" else 16
        return native.write_flac(path, data, sample_rate, bits=bits)
    if suffix == ".mp3":
        return codecs.write_mp3(path, data, sample_rate)
    if suffix == ".ogg":
        return codecs.write_ogg(path, data, sample_rate)
    if native.av_available():
        return native.write_av(path, data, sample_rate)
    raise _unsupported(path, "write support")
