"""RIFF/WAVE reading and writing on numpy.

Counterpart of ``audiotools_tpu/io/wav.py`` for the formats the
augmentation path reads and writes: integer PCM (8/16/24/32 bit) and
IEEE float (32/64 bit). Partial reads seek to the requested frames, so
an excerpt of a long file costs only the excerpt's bytes.
"""
import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["WavInfo", "wav_info", "read_wav", "write_wav"]

_PCM = 0x0001
_IEEE_FLOAT = 0x0003
_EXTENSIBLE = 0xFFFE


@dataclass
class WavInfo:
    sample_rate: int
    num_frames: int
    num_channels: int
    bits_per_sample: int
    format_tag: int
    data_offset: int

    @property
    def duration(self) -> float:
        return self.num_frames / self.sample_rate


def _parse_header(f) -> WavInfo:
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    data = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = struct.unpack("<4sI", hdr)
        if cid == b"fmt ":
            if size > (1 << 20):
                raise ValueError(f"malformed WAV: fmt chunk size {size}")
            body = f.read(size + (size & 1))
            if len(body) < 16:
                raise ValueError("malformed WAV: fmt chunk too small")
            tag, nch, sr, _rate, align, bits = struct.unpack("<HHIIHH", body[:16])
            if tag == _EXTENSIBLE and size >= 40:
                tag = struct.unpack("<H", body[24:26])[0]
            fmt = (tag, nch, sr, align or nch * (bits // 8), bits)
        elif cid == b"data":
            data = (f.tell(), size)
            f.seek(size + (size & 1), 1)
        else:
            f.seek(size + (size & 1), 1)
    if fmt is None or data is None:
        raise ValueError("malformed WAV: missing fmt or data chunk")
    tag, nch, sr, align, bits = fmt
    if nch == 0 or sr == 0:
        raise ValueError("malformed WAV: zero channels or sample rate")
    return WavInfo(sr, data[1] // align, nch, bits, tag, data[0])


def wav_info(path) -> WavInfo:
    """Header-only inspection."""
    with open(path, "rb") as f:
        return _parse_header(f)


def _decode(raw: bytes, tag: int, bits: int) -> np.ndarray:
    if tag == _PCM and bits == 8:
        return (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    if tag == _PCM and bits == 16:
        return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    if tag == _PCM and bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        return v.astype(np.float32) / float(1 << 23)
    if tag == _PCM and bits == 32:
        return np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
    if tag == _IEEE_FLOAT and bits in (32, 64):
        return np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
    raise ValueError(f"unsupported WAV encoding: tag 0x{tag:04x}, {bits} bits")


def read_wav(path, offset: float = 0.0, duration: float = None, dtype=np.float32):
    """Read ``(C, T)`` audio in [-1, 1] as ``dtype`` and its sample rate,
    optionally ``duration`` seconds starting ``offset`` seconds in."""
    with open(path, "rb") as f:
        info = _parse_header(f)
        frame_bytes = info.num_channels * (info.bits_per_sample // 8)
        if frame_bytes == 0:
            raise ValueError(f"unsupported sample width {info.bits_per_sample}")
        start = int(round(offset * info.sample_rate)) if offset else 0
        start = min(start, info.num_frames)
        count = info.num_frames - start
        if duration is not None:
            count = min(int(round(duration * info.sample_rate)), count)
        f.seek(info.data_offset + start * frame_bytes)
        raw = f.read(max(count, 0) * frame_bytes)
    n = len(raw) // frame_bytes
    data = _decode(raw[: n * frame_bytes], info.format_tag, info.bits_per_sample)
    data = data.reshape(n, info.num_channels).T
    return np.ascontiguousarray(data.astype(dtype, copy=False)), info.sample_rate


def write_wav(path, data: np.ndarray, sample_rate: int, subtype: str = "PCM_16"):
    """Write ``(C, T)`` or ``(T,)`` float audio as 16-bit PCM
    (``subtype="PCM_16"``) or 32-bit float (``"FLOAT"``)."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None, :]
    if data.ndim != 2:
        raise ValueError(f"expected (C, T) audio, got shape {data.shape}")
    C, T = data.shape
    frames = np.ascontiguousarray(data.T)
    if subtype == "PCM_16":
        tag, bits = _PCM, 16
        payload = np.clip(np.round(frames * 32768.0), -32768, 32767).astype("<i2")
        extra = b""
    elif subtype == "FLOAT":
        tag, bits = _IEEE_FLOAT, 32
        payload = frames.astype("<f4")
        extra = struct.pack("<4sII", b"fact", 4, T)
    else:
        raise ValueError(f"unsupported subtype {subtype!r}")
    payload = payload.tobytes()
    align = C * bits // 8
    fmt = struct.pack("<4sIHHIIHH", b"fmt ", 16, tag, C, sample_rate,
                      sample_rate * align, align, bits)
    pad = b"\x00" if len(payload) & 1 else b""
    body = fmt + extra + struct.pack("<4sI", b"data", len(payload)) + payload + pad
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 4 + len(body), b"WAVE"))
        f.write(body)
    return path
