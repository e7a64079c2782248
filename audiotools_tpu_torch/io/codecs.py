"""Compressed-audio codecs via system libraries (ctypes, no subprocesses).

Counterpart of ``audiotools_tpu/io/codecs.py``, copied: the ctypes
structures are the libraries' ABI layouts. The original audiotools
library shells out to ffmpeg/sox for codec work
(audiotools/core/effects.py:311-384, core/ffmpeg.py); this module binds
the codec *libraries* instead, which need no binaries:

* MP3 decode — libmpg123
* MP3 encode — libmp3lame
* Ogg/Vorbis decode — libvorbisfile
* Ogg/Vorbis encode — libvorbisenc + libvorbis + libogg
* GSM 06.10 full-rate encode/decode — libgsm

Each is bound lazily; the ``*_available()`` functions report which
libraries the host has.
"""
import ctypes
import ctypes.util
from pathlib import Path

import numpy as np

__all__ = [
    "mp3_available",
    "vorbis_available",
    "vorbis_encode_available",
    "gsm_available",
    "read_mp3",
    "write_mp3",
    "read_ogg",
    "write_ogg",
    "gsm_roundtrip",
]

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_ENC_SIGNED_16 = 0xD0


def _load(name):
    try:
        return ctypes.CDLL(name)
    except OSError:
        return None


_mpg123 = None
_mpg123_ready = False


def _get_mpg123():
    global _mpg123, _mpg123_ready
    if _mpg123 is None:
        _mpg123 = _load("libmpg123.so.0")
        if _mpg123 is not None and not _mpg123_ready:
            _mpg123.mpg123_init()
            _mpg123.mpg123_new.restype = ctypes.c_void_p
            _mpg123.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
            _mpg123.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            _mpg123.mpg123_getformat.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            _mpg123.mpg123_format_none.argtypes = [ctypes.c_void_p]
            _mpg123.mpg123_format.argtypes = [
                ctypes.c_void_p,
                ctypes.c_long,
                ctypes.c_int,
                ctypes.c_int,
            ]
            _mpg123.mpg123_read.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
            ]
            _mpg123.mpg123_close.argtypes = [ctypes.c_void_p]
            _mpg123.mpg123_delete.argtypes = [ctypes.c_void_p]
            _mpg123_ready = True
    return _mpg123


_lame = None


def _get_lame():
    global _lame
    if _lame is None:
        _lame = _load("libmp3lame.so.0")
        if _lame is not None:
            _lame.lame_init.restype = ctypes.c_void_p
            for fn in (
                "lame_set_in_samplerate",
                "lame_set_num_channels",
                "lame_set_quality",
                "lame_set_brate",
            ):
                getattr(_lame, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
            _lame.lame_init_params.argtypes = [ctypes.c_void_p]
            _lame.lame_encode_buffer_ieee_float.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
                ctypes.c_char_p,
                ctypes.c_int,
            ]
            _lame.lame_encode_flush.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_int,
            ]
            _lame.lame_close.argtypes = [ctypes.c_void_p]
    return _lame


def mp3_available() -> bool:
    return _get_mpg123() is not None and _get_lame() is not None


def read_mp3(path, offset: float = 0.0, duration: float = None):
    """Decode an MP3 to ``(C, T)`` float32 in [-1, 1] plus sample rate."""
    lib = _get_mpg123()
    if lib is None:
        raise RuntimeError("libmpg123 not available")
    err = ctypes.c_int()
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError("mpg123_new failed")
    try:
        if lib.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            raise ValueError(f"could not open mp3: {path}")
        rate = ctypes.c_long()
        ch = ctypes.c_int()
        enc = ctypes.c_int()
        rc = lib.mpg123_getformat(
            h, ctypes.byref(rate), ctypes.byref(ch), ctypes.byref(enc)
        )
        # hostile/corrupt streams can fail format detection or report
        # zero channels/rate (fuzz-found: ZeroDivisionError below)
        if rc != _MPG123_OK or ch.value <= 0 or rate.value <= 0:
            raise ValueError(f"mp3 has no decodable format: {path}")
        # lock to signed 16-bit output
        lib.mpg123_format_none(h)
        lib.mpg123_format(h, rate.value, ch.value, _MPG123_ENC_SIGNED_16)

        chunks = []
        buf = (ctypes.c_char * (64 * 1024))()
        done = ctypes.c_size_t()
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK,):
                if not chunks:
                    raise ValueError(f"mp3 decode error {rc}: {path}")
                break
        raw = b"".join(chunks)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)

    data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    n = len(data) // ch.value
    data = data[: n * ch.value].reshape(n, ch.value).T  # (C, T)
    sr = int(rate.value)
    start = int(round(offset * sr)) if offset else 0
    end = None if duration is None else start + int(round(duration * sr))
    return np.ascontiguousarray(data[:, start:end]), sr


def write_mp3(
    path,
    data: np.ndarray,
    sample_rate: int,
    bitrate: int = 192,
    vbr_quality: int = None,
):
    """Encode ``(C, T)`` float audio to MP3 (mono or stereo).

    ``vbr_quality`` (0 best .. 9 worst) switches LAME to VBR mode and
    overrides ``bitrate`` — the knob sox exposes as a negative
    compression factor, which the "MP3" codec preset relies on for its
    heavy-artifact simulation (reference effects.py:14-25).
    """
    lib = _get_lame()
    if lib is None:
        raise RuntimeError("libmp3lame not available")
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[None, :]
    C, T = data.shape
    if C > 2:
        raise ValueError("mp3 supports at most 2 channels")

    gf = ctypes.c_void_p(lib.lame_init())
    try:
        lib.lame_set_in_samplerate(gf, sample_rate)
        # pin the output rate (sox does the same): at low VBR quality
        # LAME otherwise auto-downsamples (q9 @ 44.1k silently emits a
        # 22.05k stream), changing the decoded length and rate
        lib.lame_set_out_samplerate(gf, sample_rate)
        lib.lame_set_num_channels(gf, C)
        lib.lame_set_quality(gf, 2)
        if vbr_quality is not None:
            lib.lame_set_VBR(gf, 4)  # vbr_mtrh, LAME's default VBR mode
            lib.lame_set_VBR_q(gf, int(np.clip(vbr_quality, 0, 9)))
        else:
            lib.lame_set_brate(gf, bitrate)
        if lib.lame_init_params(gf) < 0:
            raise RuntimeError("lame_init_params failed")

        left = np.ascontiguousarray(data[0])
        right = np.ascontiguousarray(data[1] if C == 2 else data[0])
        out_size = int(1.25 * T + 7200)
        out = ctypes.create_string_buffer(out_size)
        n = lib.lame_encode_buffer_ieee_float(
            gf,
            left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            T,
            out,
            out_size,
        )
        if n < 0:
            raise RuntimeError(f"lame encode failed: {n}")
        tail = ctypes.create_string_buffer(7200)
        m = lib.lame_encode_flush(gf, tail, 7200)
        with open(path, "wb") as f:
            f.write(out.raw[:n])
            f.write(tail.raw[:m])
    finally:
        lib.lame_close(gf)
    return path


# ---------------------------------------------------------------------------
# Ogg/Vorbis decode (libvorbisfile)
# ---------------------------------------------------------------------------

_vorbis = None


def _get_vorbisfile():
    global _vorbis
    if _vorbis is None:
        _vorbis = _load("libvorbisfile.so.3")
        if _vorbis is not None:
            _vorbis.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
            _vorbis.ov_info.restype = ctypes.POINTER(_VorbisInfo)
            _vorbis.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
            _vorbis.ov_pcm_total.restype = ctypes.c_int64
            _vorbis.ov_pcm_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
            _vorbis.ov_read.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            _vorbis.ov_clear.argtypes = [ctypes.c_void_p]
    return _vorbis


class _VorbisInfo(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
    ]


def vorbis_available() -> bool:
    return _get_vorbisfile() is not None


# ---------------------------------------------------------------------------
# Ogg/Vorbis encode (libvorbisenc + libvorbis + libogg)
# ---------------------------------------------------------------------------


class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", ctypes.c_long),
        ("b_o_s", ctypes.c_long),
        ("e_o_s", ctypes.c_long),
        ("granulepos", ctypes.c_int64),
        ("packetno", ctypes.c_int64),
    ]


class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", ctypes.POINTER(ctypes.c_ubyte)),
        ("header_len", ctypes.c_long),
        ("body", ctypes.POINTER(ctypes.c_ubyte)),
        ("body_len", ctypes.c_long),
    ]


_venc_libs = None


def _get_vorbisenc():
    """Load (libogg, libvorbis, libvorbisenc) and declare signatures."""
    global _venc_libs
    if _venc_libs is None:
        ogg = _load("libogg.so.0")
        vb = _load("libvorbis.so.0")
        enc = _load("libvorbisenc.so.2")
        if not (ogg and vb and enc):
            _venc_libs = (None, None, None)
            return _venc_libs
        P = ctypes.c_void_p
        ogg.ogg_stream_init.argtypes = [P, ctypes.c_int]
        ogg.ogg_stream_packetin.argtypes = [P, ctypes.POINTER(_OggPacket)]
        ogg.ogg_stream_flush.argtypes = [P, ctypes.POINTER(_OggPage)]
        ogg.ogg_stream_pageout.argtypes = [P, ctypes.POINTER(_OggPage)]
        ogg.ogg_stream_clear.argtypes = [P]
        vb.vorbis_info_init.argtypes = [P]
        vb.vorbis_info_clear.argtypes = [P]
        vb.vorbis_comment_init.argtypes = [P]
        vb.vorbis_comment_clear.argtypes = [P]
        vb.vorbis_analysis_init.argtypes = [P, P]
        vb.vorbis_block_init.argtypes = [P, P]
        vb.vorbis_analysis_headerout.argtypes = [
            P, P,
            ctypes.POINTER(_OggPacket),
            ctypes.POINTER(_OggPacket),
            ctypes.POINTER(_OggPacket),
        ]
        vb.vorbis_analysis_buffer.restype = ctypes.POINTER(
            ctypes.POINTER(ctypes.c_float)
        )
        vb.vorbis_analysis_buffer.argtypes = [P, ctypes.c_int]
        vb.vorbis_analysis_wrote.argtypes = [P, ctypes.c_int]
        vb.vorbis_analysis_blockout.argtypes = [P, P]
        vb.vorbis_analysis.argtypes = [P, P]
        vb.vorbis_bitrate_addblock.argtypes = [P]
        vb.vorbis_bitrate_flushpacket.argtypes = [P, ctypes.POINTER(_OggPacket)]
        vb.vorbis_block_clear.argtypes = [P]
        vb.vorbis_dsp_clear.argtypes = [P]
        enc.vorbis_encode_init_vbr.argtypes = [
            P, ctypes.c_long, ctypes.c_long, ctypes.c_float
        ]
        _venc_libs = (ogg, vb, enc)
    return _venc_libs


def vorbis_encode_available() -> bool:
    return _get_vorbisenc()[0] is not None


def write_ogg(path, data: np.ndarray, sample_rate: int, quality: float = 0.3):
    """Encode ``(C, T)`` float audio to an Ogg/Vorbis file (VBR).

    ``quality`` is the libvorbisenc VBR knob in [-0.1, 1.0]; 0.3 ≈ ~112 kbps
    stereo. The reference reaches Vorbis through torchaudio/sox
    (audiotools/core/effects.py:366-376); here the ogg
    stream framing and vorbis analysis are driven directly via ctypes.
    """
    ogg, vb, enc = _get_vorbisenc()
    if ogg is None:
        raise RuntimeError("vorbis encoder libraries not available")
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[None, :]
    C, T = data.shape

    # Opaque libvorbis/libogg state structs — allocated oversized; every
    # access goes through the library, only ogg_page/ogg_packet are read.
    vi = ctypes.create_string_buffer(256)    # vorbis_info
    vc = ctypes.create_string_buffer(64)     # vorbis_comment
    vd = ctypes.create_string_buffer(4096)   # vorbis_dsp_state
    vblk = ctypes.create_string_buffer(1024)  # vorbis_block
    osb = ctypes.create_string_buffer(1024)  # ogg_stream_state
    og = _OggPage()
    op = _OggPacket()

    vb.vorbis_info_init(vi)
    try:
        if enc.vorbis_encode_init_vbr(vi, C, sample_rate, quality) != 0:
            raise RuntimeError("vorbis_encode_init_vbr failed")
        vb.vorbis_comment_init(vc)
        vb.vorbis_analysis_init(vd, vi)
        vb.vorbis_block_init(vd, vblk)
        ogg.ogg_stream_init(osb, 1)

        out = bytearray()

        def _pages(flush=False):
            fn = ogg.ogg_stream_flush if flush else ogg.ogg_stream_pageout
            while fn(osb, ctypes.byref(og)) != 0:
                out.extend(ctypes.string_at(og.header, og.header_len))
                out.extend(ctypes.string_at(og.body, og.body_len))

        # the three mandatory header packets, flushed onto their own page(s)
        h1, h2, h3 = _OggPacket(), _OggPacket(), _OggPacket()
        vb.vorbis_analysis_headerout(
            vd, vc, ctypes.byref(h1), ctypes.byref(h2), ctypes.byref(h3)
        )
        for h in (h1, h2, h3):
            ogg.ogg_stream_packetin(osb, ctypes.byref(h))
        _pages(flush=True)

        def _drain():
            while vb.vorbis_analysis_blockout(vd, vblk) == 1:
                vb.vorbis_analysis(vblk, None)
                vb.vorbis_bitrate_addblock(vblk)
                while vb.vorbis_bitrate_flushpacket(vd, ctypes.byref(op)) == 1:
                    ogg.ogg_stream_packetin(osb, ctypes.byref(op))
                    _pages()

        CHUNK = 4096
        for start in range(0, T, CHUNK):
            n = min(CHUNK, T - start)
            buf = vb.vorbis_analysis_buffer(vd, n)
            for c in range(C):
                ctypes.memmove(
                    buf[c],
                    np.ascontiguousarray(data[c, start : start + n]).ctypes.data,
                    n * 4,
                )
            vb.vorbis_analysis_wrote(vd, n)
            _drain()
        vb.vorbis_analysis_wrote(vd, 0)  # end of stream
        _drain()
        _pages(flush=True)

        with open(path, "wb") as f:
            f.write(bytes(out))
    finally:
        ogg.ogg_stream_clear(osb)
        vb.vorbis_block_clear(vblk)
        vb.vorbis_dsp_clear(vd)
        vb.vorbis_comment_clear(vc)
        vb.vorbis_info_clear(vi)
    return path


def read_ogg(path, offset: float = 0.0, duration: float = None):
    """Decode an Ogg/Vorbis file to ``(C, T)`` float32 plus sample rate."""
    lib = _get_vorbisfile()
    if lib is None:
        raise RuntimeError("libvorbisfile not available")
    vf = ctypes.create_string_buffer(2048)  # opaque OggVorbis_File
    if lib.ov_fopen(str(path).encode(), vf) != 0:
        raise ValueError(f"could not open ogg: {path}")
    try:
        info = lib.ov_info(vf, -1).contents
        sr, ch = int(info.rate), int(info.channels)
        chunks = []
        buf = ctypes.create_string_buffer(64 * 1024)
        bitstream = ctypes.c_int()
        while True:
            n = lib.ov_read(vf, buf, len(buf), 0, 2, 1, ctypes.byref(bitstream))
            if n <= 0:
                break
            chunks.append(buf.raw[:n])
        raw = b"".join(chunks)
    finally:
        lib.ov_clear(vf)
    data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    nfr = len(data) // ch
    data = data[: nfr * ch].reshape(nfr, ch).T
    start = int(round(offset * sr)) if offset else 0
    end = None if duration is None else start + int(round(duration * sr))
    return np.ascontiguousarray(data[:, start:end]), sr


# ---------------------------------------------------------------------------
# GSM 06.10 full-rate (libgsm)
# ---------------------------------------------------------------------------

_GSM_FRAME = 160  # samples per GSM frame (20 ms at 8 kHz)
_GSM_BYTES = 33  # encoded bytes per frame

_gsm = None


def _get_gsm():
    global _gsm
    if _gsm is None:
        _gsm = _load("libgsm.so.1")
        if _gsm is not None:
            _gsm.gsm_create.restype = ctypes.c_void_p
            _gsm.gsm_destroy.argtypes = [ctypes.c_void_p]
            _gsm.gsm_encode.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_ubyte),
            ]
            _gsm.gsm_decode.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.POINTER(ctypes.c_int16),
            ]
    return _gsm


def gsm_available() -> bool:
    return _get_gsm() is not None


def gsm_roundtrip(data: np.ndarray) -> np.ndarray:
    """Encode+decode ``(C, T)`` float32 8 kHz audio through GSM 06.10.

    The GSM full-rate codec is mono, 8 kHz, 160-sample frames; each
    channel is coded independently and the tail is zero-padded to a whole
    frame then trimmed. Used by ``apply_codec(preset="GSM-FR")``
    (reference effects.py:14-25 / torchaudio sox path :370-384) — the
    caller is responsible for resampling to/from 8 kHz.
    """
    lib = _get_gsm()
    if lib is None:
        raise RuntimeError("libgsm not available")
    data = np.asarray(data, dtype=np.float32)
    squeeze = data.ndim == 1
    if squeeze:
        data = data[None, :]
    C, T = data.shape
    n_frames = -(-T // _GSM_FRAME)
    pcm = np.zeros((C, n_frames * _GSM_FRAME), dtype=np.int16)
    pcm[:, :T] = np.clip(data * 32768.0, -32768, 32767).astype(np.int16)

    out = np.empty_like(pcm)
    frame = (ctypes.c_ubyte * _GSM_BYTES)()
    for c in range(C):
        h_enc = ctypes.c_void_p(lib.gsm_create())
        h_dec = ctypes.c_void_p(lib.gsm_create())
        try:
            row = np.ascontiguousarray(pcm[c])
            dst = out[c]
            for i in range(n_frames):
                seg = row[i * _GSM_FRAME : (i + 1) * _GSM_FRAME]
                lib.gsm_encode(
                    h_enc,
                    seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    frame,
                )
                dec = (ctypes.c_int16 * _GSM_FRAME)()
                lib.gsm_decode(h_dec, frame, dec)
                dst[i * _GSM_FRAME : (i + 1) * _GSM_FRAME] = np.frombuffer(
                    dec, dtype=np.int16
                )
        finally:
            lib.gsm_destroy(h_enc)
            lib.gsm_destroy(h_dec)

    res = out[:, :T].astype(np.float32) / 32768.0
    return res[0] if squeeze else res
