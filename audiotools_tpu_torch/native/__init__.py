"""Native (C++) host I/O: the WAV, FLAC and libav readers and writers.

Counterpart of ``audiotools_tpu/native/__init__.py`` over copies of its
sources. Each ``<name>.cpp`` beside this file is built with ``g++`` at
first use into the package's ``_build/`` (``_build.host_library``, cached
under a hash of the source and the flags) and bound with ``ctypes``. A
failed build of the WAV or FLAC library raises with g++'s output. The
libav shim links the system libavformat/libavcodec/libavutil: where those
are missing, ``av_available()`` is false, as in the JAX package; where
they are present, a failed build raises too.
"""
import ctypes
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .. import _build

_lock = threading.Lock()
_bound = {}
_av_missing = None  # why libav cannot be linked here, once probed


def _bind(name, signatures):
    """Build (if needed), load and type the library ``name``."""
    with _lock:
        if name not in _bound:
            lib = _build.host_library(name)
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _bound[name] = lib
        return _bound[name]


_P = ctypes.POINTER
_BATCH = ([_P(ctypes.c_char_p), ctypes.c_int32, _P(ctypes.c_int64), _P(ctypes.c_int64),
           _P(_P(ctypes.c_float)), _P(ctypes.c_int32), ctypes.c_int32], ctypes.c_int)
_READ = ([ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _P(ctypes.c_float), ctypes.c_int32],
         ctypes.c_int64)


def get_library():
    """The native WAV library (``wavio.cpp``), built if needed."""
    return _bind("wavio", {
        "at_wav_info": ([ctypes.c_char_p, _P(ctypes.c_int32), _P(ctypes.c_int64),
                         _P(ctypes.c_int32)], ctypes.c_int),
        "at_wav_read": _READ,
        "at_wav_read_batch": _BATCH,
    })


def available() -> bool:
    """True once the WAV library is built and loaded; a failed build raises."""
    return get_library() is not None


def wav_info(path):
    """(sample_rate, num_frames, channels) via the native parser."""
    lib = get_library()
    sr = ctypes.c_int32()
    frames = ctypes.c_int64()
    ch = ctypes.c_int32()
    rc = lib.at_wav_info(str(path).encode(), ctypes.byref(sr), ctypes.byref(frames),
                         ctypes.byref(ch))
    if rc != 0:
        raise ValueError(f"could not parse WAV: {path}")
    return sr.value, frames.value, ch.value


def read_wav(path, offset: float = 0.0, duration: float = None):
    """Native seeked decode -> ((C, T) float32, sample_rate)."""
    sr, total, ch = wav_info(path)
    start = int(round(offset * sr)) if offset else 0
    start = min(max(start, 0), total)
    if duration is None:
        count = total - start
    else:
        count = min(int(round(duration * sr)), total - start)
    # a negative count must never reach the C side: at_wav_read treats
    # n_frames < 0 as read-to-end and would decode into the 0-byte buffer
    count = max(count, 0)
    out = np.empty((ch, count), dtype=np.float32)
    got = 0
    if count:
        got = get_library().at_wav_read(
            str(path).encode(), start, count,
            out.ctypes.data_as(_P(ctypes.c_float)), ch,
        )
        if got < 0:
            raise ValueError(f"native decode failed for {path}")
    return out[:, :got], sr


def _run_batch(batch_fn, paths, starts, counts, outs, chans, n_threads):
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_starts = (ctypes.c_int64 * n)(*starts)
    c_counts = (ctypes.c_int64 * n)(*counts)
    c_chans = (ctypes.c_int32 * n)(*chans)
    c_outs = (_P(ctypes.c_float) * n)(*[o.ctypes.data_as(_P(ctypes.c_float)) for o in outs])
    rc = batch_fn(c_paths, n, c_starts, c_counts, c_outs, c_chans, n_threads)
    if rc != 0:
        raise ValueError(f"native batch decode failed at item {-rc - 1}")


def read_batch(paths, offsets, durations, n_threads: int = 0):
    """Decode a batch of excerpts in parallel (C threads, no GIL).

    Dispatches per extension: WAV through the wavio batch decoder, FLAC
    through the flacio one (mixed batches fine). Returns a list of
    (C, T) float32 arrays, zero-padded to the requested duration, plus
    the list of sample rates.
    """
    suffixes = [Path(str(p)).suffix.lower() for p in paths]
    infos = [flac_info(p)[:3] if sfx == ".flac" else wav_info(p)
             for p, sfx in zip(paths, suffixes)]
    starts, counts, outs, chans = [], [], [], []
    for (sr, total, ch), off, dur in zip(infos, offsets, durations):
        starts.append(min(max(int(round(off * sr)), 0), total))
        count = max(int(round(dur * sr)), 0)
        counts.append(count)
        chans.append(ch)
        # no zero fill: the C side pads short reads itself
        outs.append(np.empty((ch, count), dtype=np.float32))

    groups = {}
    for i, sfx in enumerate(suffixes):
        groups.setdefault(".flac" if sfx == ".flac" else ".wav", []).append(i)
    for sfx, idxs in groups.items():
        fn = (get_flac_library().at_flac_read_batch if sfx == ".flac"
              else get_library().at_wav_read_batch)
        _run_batch(fn, *([seq[i] for i in idxs] for seq in (paths, starts, counts, outs, chans)),
                   n_threads)
    return outs, [i[0] for i in infos]


# ---------------------------------------------------------------------------
# FLAC codec (flacio.cpp): the format from its specification, no libFLAC
# ---------------------------------------------------------------------------


def get_flac_library():
    """The native FLAC codec (``flacio.cpp``), built if needed."""
    return _bind("flacio", {
        "at_flac_info": ([ctypes.c_char_p, _P(ctypes.c_int32), _P(ctypes.c_int64),
                          _P(ctypes.c_int32), _P(ctypes.c_int32)], ctypes.c_int),
        "at_flac_read": _READ,
        "at_flac_write": ([ctypes.c_char_p, _P(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
                           ctypes.c_int32, ctypes.c_int32], ctypes.c_int),
        "at_flac_read_batch": _BATCH,
    })


def flac_available() -> bool:
    """True once the FLAC library is built and loaded; a failed build raises."""
    return get_flac_library() is not None


def flac_info(path):
    """(sample_rate, num_frames, channels, bits) from STREAMINFO."""
    lib = get_flac_library()
    sr = ctypes.c_int32()
    frames = ctypes.c_int64()
    ch = ctypes.c_int32()
    bits = ctypes.c_int32()
    rc = lib.at_flac_info(str(path).encode(), ctypes.byref(sr), ctypes.byref(frames),
                          ctypes.byref(ch), ctypes.byref(bits))
    if rc != 0:
        raise ValueError(f"could not parse FLAC: {path}")
    return sr.value, frames.value, ch.value, bits.value


def read_flac(path, offset: float = 0.0, duration: float = None):
    """Decode a FLAC file -> ((C, T) float32 in [-1, 1], sample_rate)."""
    sr, total, ch, _bits = flac_info(path)
    start = min(int(round(offset * sr)), total) if offset else 0
    if duration is None:
        count = total - start
    else:
        count = min(int(round(duration * sr)), total - start)
    count = max(count, 0)
    out = np.zeros((ch, count), dtype=np.float32)
    if count:
        got = get_flac_library().at_flac_read(
            str(path).encode(), start, count, out.ctypes.data_as(_P(ctypes.c_float)), ch,
        )
        if got < 0:
            raise ValueError(f"FLAC decode failed for {path}")
    return out, sr


def write_flac(path, data, sample_rate: int, bits: int = 16):
    """Encode ``(C, T)`` float audio (in [-1, 1]) to a FLAC file."""
    lib = get_flac_library()
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[None, :]
    C, T = data.shape
    scale = float(1 << (bits - 1))
    q = np.clip(np.rint(data * scale), -scale, scale - 1).astype(np.int32)
    q = np.ascontiguousarray(q)
    rc = lib.at_flac_write(str(path).encode(), q.ctypes.data_as(_P(ctypes.c_int32)),
                           T, C, int(sample_rate), int(bits))
    if rc != 0:
        raise ValueError(f"FLAC encode failed for {path}")
    return path


# ---------------------------------------------------------------------------
# libav container decode and encode (avio.cpp): mp4/m4a/webm/mkv/aac/opus/...
# through the system libavformat/libavcodec shared libraries, which many
# hosts have without the ffmpeg binary
# ---------------------------------------------------------------------------

_AV_PROBE = """extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/avutil.h>
}
int main() { return avformat_version() && avcodec_version() && avutil_version() ? 0 : 1; }
"""


def _libav_missing():
    """None when a program including libav's headers links against its
    libraries here, else why not (g++'s output)."""
    global _av_missing
    if _av_missing is None:
        with tempfile.TemporaryDirectory() as d:
            src = Path(d) / "probe.cpp"
            src.write_text(_AV_PROBE)
            proc = subprocess.run([_build.gxx(), str(src), "-o", str(Path(d) / "probe"),
                                   *_build.HOST_LIBS["avio"]], capture_output=True, text=True)
        _av_missing = (proc.stdout + proc.stderr) if proc.returncode else ""
    return _av_missing or None


def get_av_library():
    """The libav shim (``avio.cpp``), built if needed; None where libav's
    headers or shared libraries are absent. A build that fails where libav
    links raises with g++'s output."""
    if "avio" not in _bound and not _build.host_library_path("avio").exists():
        if _libav_missing():
            return None
    return _bind("avio", {
        "at_av_info": ([ctypes.c_char_p, _P(ctypes.c_int32), _P(ctypes.c_int64),
                        _P(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int32], ctypes.c_int),
        "at_av_read": ([ctypes.c_char_p, ctypes.c_double, ctypes.c_double,
                        _P(_P(ctypes.c_float)), _P(ctypes.c_int32), _P(ctypes.c_int32)],
                       ctypes.c_int64),
        "at_av_free": ([_P(ctypes.c_float)], None),
        "at_av_write": ([ctypes.c_char_p, _P(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
                         ctypes.c_int32, ctypes.c_int64], ctypes.c_int),
    })


def av_available() -> bool:
    return get_av_library() is not None


def _require_av():
    lib = get_av_library()
    if lib is None:
        raise RuntimeError(f"libav shim unavailable:\n{_libav_missing()}")
    return lib


def av_info(path):
    """(sample_rate, num_frames, channels, codec_name) of the best audio
    stream in any libav-readable container (frame count from the
    container duration, authoritative only after a decode)."""
    lib = _require_av()
    sr = ctypes.c_int32()
    frames = ctypes.c_int64()
    ch = ctypes.c_int32()
    codec = ctypes.create_string_buffer(32)
    rc = lib.at_av_info(str(path).encode(), ctypes.byref(sr), ctypes.byref(frames),
                        ctypes.byref(ch), codec, len(codec))
    if rc != 0:
        raise ValueError(f"libav could not open an audio stream in: {path}")
    return sr.value, frames.value, ch.value, codec.value.decode()


def read_av(path, offset: float = 0.0, duration: float = None):
    """Decode any libav-readable container -> ((C, T) float32, rate).

    No resampling or remixing happens here: the stream's own rate and
    channel count come back; rate conversion is the polyphase resampler's
    job, on the device.
    """
    lib = _require_av()
    out = _P(ctypes.c_float)()
    ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    n = lib.at_av_read(str(path).encode(), float(offset or 0.0),
                       -1.0 if duration is None else float(duration),
                       ctypes.byref(out), ctypes.byref(ch), ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"libav decode failed ({n}) for: {path}")
    try:
        if n == 0:
            data = np.zeros((ch.value or 1, 0), dtype=np.float32)
        else:
            flat = np.ctypeslib.as_array(out, shape=(int(n) * ch.value,))
            data = np.ascontiguousarray(flat.reshape(int(n), ch.value).T.astype(np.float32))
    finally:
        lib.at_av_free(out)
    return data, sr.value


def write_av(path, data, sample_rate: int, bit_rate: int = 128000):
    """Encode ``(C, T)`` float audio into a container chosen from the
    path's extension, using the container's default audio codec
    (``.m4a``/``.mp4`` -> AAC via FFmpeg's native encoder)."""
    lib = _require_av()
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[None, :]
    C, T = data.shape
    inter = np.ascontiguousarray(data.T.reshape(-1))
    rc = lib.at_av_write(str(path).encode(), inter.ctypes.data_as(_P(ctypes.c_float)),
                         T, C, int(sample_rate), int(bit_rate))
    if rc != 0:
        raise ValueError(f"libav encode failed ({rc}) for: {path}")
    return path
