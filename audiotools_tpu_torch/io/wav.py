"""WAV codec on numpy: header parsing, partial (seeked) reads, and writing.

Counterpart of ``audiotools_tpu/io/wav.py``, copied. The original
audiotools library delegates file I/O to librosa/soundfile
(audiotools/core/audio_signal.py:499-507,602); this is a RIFF/WAVE
implementation on numpy that needs neither. ``io.load_audio`` reads WAV
through the native reader (``native.read_wav``) and comes here for the
encodings that reader refuses (A-law, mu-law). Partial reads seek directly to the requested byte range, so loading
a 2 s excerpt from a 2 h file costs only the excerpt bytes (the
``salient_excerpt`` hot path, audio_signal.py:227-286).

Supported encodings: PCM u8/16/24/32, IEEE float32/64, and
WAVE_FORMAT_EXTENSIBLE wrappers of both; A-law/mu-law decode.
"""
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["WavInfo", "wav_info", "read_wav", "write_wav"]

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class WavInfo:
    sample_rate: int
    num_frames: int
    num_channels: int
    bits_per_sample: int
    format_tag: int
    data_offset: int
    data_size: int

    @property
    def duration(self) -> float:
        return self.num_frames / self.sample_rate


def _parse_header(f) -> WavInfo:
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] not in (b"RIFF", b"RF64") or riff[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    rf64_data_size = None
    fmt = None
    data_offset = None
    data_size = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = struct.unpack("<4sI", hdr)
        # cap metadata chunks before buffering them: a hostile size field
        # must not make f.read() swallow the rest of a multi-GB file
        # (mirrors the 1 MB cap in native/wavio.cpp::parse_header)
        if cid in (b"ds64", b"fmt ") and size > (1 << 20):
            raise ValueError(f"Malformed WAV: {cid.decode()} chunk size {size}")
        if cid == b"ds64":
            body = f.read(size + (size & 1))
            if len(body) < 16:
                raise ValueError("Malformed WAV: truncated ds64 chunk")
            rf64_data_size = struct.unpack("<Q", body[8:16])[0]
        elif cid == b"fmt ":
            body = f.read(size + (size & 1))
            if len(body) < 16:
                raise ValueError("Malformed WAV: fmt chunk too small")
            (tag, nch, sr, _byte_rate, block_align, bits) = struct.unpack(
                "<HHIIHH", body[:16]
            )
            if tag == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                # sub-format GUID: first two bytes are the real format tag
                tag = struct.unpack("<H", body[24:26])[0]
            fmt = (tag, nch, sr, block_align, bits)
        elif cid == b"data":
            data_offset = f.tell()
            data_size = size if size != 0xFFFFFFFF else rf64_data_size
            # don't read the data; skip past (may fail on pipes, fine)
            f.seek(size + (size & 1), 1)
        else:
            f.seek(size + (size & 1), 1)
    if fmt is None or data_offset is None:
        raise ValueError("Malformed WAV: missing fmt or data chunk")
    if data_size is None:  # RF64 data chunk without a ds64 size
        raise ValueError("Malformed WAV: RF64 data size missing")
    tag, nch, sr, block_align, bits = fmt
    if nch == 0 or sr == 0:
        raise ValueError("Malformed WAV: zero channels or sample rate")
    if block_align == 0:
        block_align = nch * (bits // 8)
    num_frames = data_size // block_align if block_align else 0
    return WavInfo(
        sample_rate=sr,
        num_frames=num_frames,
        num_channels=nch,
        bits_per_sample=bits,
        format_tag=tag,
        data_offset=data_offset,
        data_size=data_size,
    )


def wav_info(path) -> WavInfo:
    """Header-only inspection (the reference's ``util.info`` shim,
    audiotools/core/util.py:21-53)."""
    with open(path, "rb") as f:
        return _parse_header(f)


# mu-law / A-law decode tables (ITU G.711)
def _mulaw_decode_table():
    u = np.arange(256, dtype=np.uint8)
    u = ~u
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    sample = ((mantissa.astype(np.int32) << 3) + 0x84) << exponent
    sample = sample - 0x84
    return np.where(sign, -sample, sample).astype(np.float32) / 32768.0


def _alaw_decode_table():
    a = np.arange(256, dtype=np.uint8) ^ 0x55
    # G.711 A-law: a SET sign bit (after the 0x55 toggle) marks a
    # POSITIVE sample — opposite of mu-law (pinned against the stdlib
    # audioop oracle in tests/test_wav_codec_edges.py, which caught this
    # table shipping with the convention inverted)
    positive = a & 0x80
    exponent = (a >> 4) & 0x07
    mantissa = (a & 0x0F).astype(np.int32)
    sample = np.where(
        exponent > 0,
        ((mantissa << 4) + 0x108) << (exponent - 1),
        (mantissa << 4) + 8,
    )
    return np.where(positive, sample, -sample).astype(np.float32) / 32768.0


def read_wav(path, offset: float = 0.0, duration: float = None, dtype=np.float32):
    """Read a WAV file (optionally a seeked slice) as ``(C, T)`` float array
    in [-1, 1], plus the sample rate.

    Parameters
    ----------
    offset : float
        Seconds to skip from the start.
    duration : float, optional
        Seconds to read (None = to the end).
    """
    path = Path(path)
    with open(path, "rb") as f:
        info = _parse_header(f)
        bytes_per_samp = info.bits_per_sample // 8
        frame_bytes = bytes_per_samp * info.num_channels
        if frame_bytes == 0:
            raise ValueError(
                f"Unsupported sub-byte sample width: {info.bits_per_sample}"
            )

        start_frame = int(round(offset * info.sample_rate)) if offset else 0
        start_frame = min(start_frame, info.num_frames)
        if duration is None:
            n_frames = info.num_frames - start_frame
        else:
            n_frames = min(
                int(round(duration * info.sample_rate)),
                info.num_frames - start_frame,
            )
        f.seek(info.data_offset + start_frame * frame_bytes)
        raw = f.read(n_frames * frame_bytes)
    n_frames = len(raw) // frame_bytes
    raw = raw[: n_frames * frame_bytes]

    tag, bits = info.format_tag, info.bits_per_sample
    if tag == WAVE_FORMAT_PCM:
        if bits == 8:
            data = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
            data = (data - 128.0) / 128.0
        elif bits == 16:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            data = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    elif tag == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            data = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            data = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"Unsupported float bit depth: {bits}")
    elif tag == WAVE_FORMAT_MULAW:
        data = _mulaw_decode_table()[np.frombuffer(raw, dtype=np.uint8)]
    elif tag == WAVE_FORMAT_ALAW:
        data = _alaw_decode_table()[np.frombuffer(raw, dtype=np.uint8)]
    else:
        raise ValueError(f"Unsupported WAV format tag: 0x{tag:04x}")

    data = data.reshape(n_frames, info.num_channels).T  # (C, T)
    return np.ascontiguousarray(data.astype(dtype)), info.sample_rate


def write_wav(path, data: np.ndarray, sample_rate: int, subtype: str = "PCM_16"):
    """Write ``(C, T)`` or ``(T,)`` float audio to a WAV file.

    ``subtype`` is one of ``PCM_16``, ``PCM_24``, ``PCM_32``, ``FLOAT``
    (soundfile-compatible names; the reference writes via
    ``soundfile.write``, audio_signal.py:602, whose wav default is PCM_16).
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None, :]
    assert data.ndim == 2, "expected (C, T) audio"
    C, T = data.shape
    interleaved = np.ascontiguousarray(data.T)  # (T, C)

    if subtype == "PCM_16":
        tag, bits = WAVE_FORMAT_PCM, 16
        scaled = np.clip(np.round(interleaved * 32768.0), -32768, 32767)
        payload = scaled.astype("<i2").tobytes()
    elif subtype == "PCM_24":
        tag, bits = WAVE_FORMAT_PCM, 24
        scaled = np.clip(
            np.round(interleaved * float(1 << 23)), -(1 << 23), (1 << 23) - 1
        ).astype(np.int32)
        b = np.empty((T * C, 3), dtype=np.uint8)
        flat = scaled.reshape(-1)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        payload = b.tobytes()
    elif subtype == "PCM_32":
        tag, bits = WAVE_FORMAT_PCM, 32
        scaled = np.clip(
            np.round(interleaved.astype(np.float64) * float(1 << 31)),
            -(1 << 31),
            (1 << 31) - 1,
        )
        payload = scaled.astype("<i4").tobytes()
    elif subtype in ("FLOAT", "FLOAT_32"):
        tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
        payload = interleaved.astype("<f4").tobytes()
    elif subtype in ("DOUBLE", "FLOAT_64"):
        tag, bits = WAVE_FORMAT_IEEE_FLOAT, 64
        payload = interleaved.astype("<f8").tobytes()
    else:
        raise ValueError(f"Unsupported subtype: {subtype}")

    block_align = C * (bits // 8)
    byte_rate = sample_rate * block_align
    fmt_chunk = struct.pack(
        "<4sIHHIIHH", b"fmt ", 16, tag, C, sample_rate, byte_rate, block_align, bits
    )
    extra = b""
    if tag == WAVE_FORMAT_IEEE_FLOAT:
        # fact chunk is required for non-PCM
        extra = struct.pack("<4sII", b"fact", 4, T)
    data_hdr = struct.pack("<4sI", b"data", len(payload))
    pad = b"\x00" if len(payload) & 1 else b""
    riff_size = 4 + len(fmt_chunk) + len(extra) + len(data_hdr) + len(payload) + len(pad)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", riff_size, b"WAVE"))
        f.write(fmt_chunk)
        f.write(extra)
        f.write(data_hdr)
        f.write(payload)
        f.write(pad)
    return path
