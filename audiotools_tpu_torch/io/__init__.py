"""Host-side audio I/O: the WAV subset of ``audiotools_tpu.io``."""
from pathlib import Path

from .._hostprof import span
from .wav import WavInfo, read_wav, wav_info, write_wav

__all__ = ["load_audio", "audio_info", "save_audio", "write_wav", "read_wav", "wav_info",
           "WavInfo"]


def _require_wav(path):
    if Path(path).suffix.lower() != ".wav":
        raise ValueError(f"unsupported audio format {Path(path).suffix!r}: only .wav")


def audio_info(path) -> WavInfo:
    """File metadata (sample rate, frame count, duration) without decoding."""
    _require_wav(path)
    return wav_info(path)


def load_audio(path, offset: float = 0.0, duration: float = None):
    """Decode audio as ``(C, T)`` float32 in [-1, 1] plus its sample rate."""
    _require_wav(path)
    with span("decode"):
        return read_wav(path, offset=offset, duration=duration)


def save_audio(path, data, sample_rate: int, subtype: str = "PCM_16"):
    """Encode ``(C, T)`` float audio to a ``.wav`` file (``subtype``
    ``"PCM_16"`` or ``"FLOAT"``). Other containers (FLAC, MP3, Ogg) need a
    host codec layer this package does not have, and raise ``ValueError``."""
    path = Path(path)
    if path.suffix.lower() != ".wav":
        raise ValueError(
            f"Unsupported audio format '{path.suffix}'. "
            "Native write support: .wav; .flac, .mp3 and .ogg need a host "
            "codec layer this package does not have yet."
        )
    return write_wav(path, data, sample_rate, subtype=subtype)
