"""Streaming (chunked) inference for the DAC codec.

Counterpart of ``audiotools_tpu/models/streaming.py``: arbitrarily long
audio runs through windows of one fixed length per direction, with bounded
device memory and results identical to the whole-signal model.

Design: overlap-save over the codec's receptive field
-------------------------------------------------------
The encoder and decoder are convolutional stacks with a finite receptive
field, so a window of ``chunk + 2*halo`` frames computes its central
``chunk`` frames exactly, provided ``halo`` covers the receptive field. Two
details make the chunked outputs equal to the whole-signal pass rather than
merely close:

* **Fixed window length.** Every window has the same length, so each
  direction runs one convolution geometry (and, on the card, one choice of
  cuDNN algorithm per layer) for the whole stream.
* **Boundary clamping, not zero-stuffing.** Windows near the signal edges
  are slid inward (``start = clamp(pos - halo, 0, total - W)``) instead of
  zero-padded. A window whose edge coincides with the true signal edge
  reproduces the whole model's zero padding at every layer; fabricated
  zeros would not (each layer's bias turns a zero input region into a
  nonzero feature region, which the whole model never sees). Central
  frames of interior windows are clean by the halo argument; edge frames
  are clean by alignment.

Halos are computed analytically from the model configuration
(:func:`encoder_halo_frames`, :func:`decoder_halo_frames`) with a safety
margin. The push/flush classes keep only a window's worth of history, on
the model's device (O(chunk + halo) memory whatever the stream's length),
and emit codes or samples, as tensors on that device, as soon as they are
computable. Inputs may be tensors or numpy arrays. Every window runs under
``torch.no_grad`` in full fp32 (``strict_fp32``).
"""
import math
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops._fp32 import strict_fp32
from .dac import DAC

__all__ = [
    "encoder_halo_frames",
    "decoder_halo_frames",
    "StreamingEncoder",
    "StreamingDecoder",
    "stream_encode",
    "stream_decode",
]

# per-stage residual-unit context: three units of k=7 convs at dilations
# (1, 3, 9) -> 3*(1+3+9) samples each side (the k=1 projections add none)
_RU_CONTEXT = 3 * (1 + 3 + 9)


def encoder_halo_frames(model: DAC, margin: int = 2) -> int:
    """One-sided receptive field of the encoder, in latent frames (rounded
    up, plus ``margin``): the stem k=7 conv, per stage three dilated
    residual units and a k=2s strided conv, and the k=3 latent head, each
    layer's one-sided context in input samples (context x cumulative
    stride)."""
    samples = 3  # stem conv, k=7
    P = 1
    for s in model.encoder_rates:
        samples += (_RU_CONTEXT + 2 * s) * P  # units + strided conv (k=2s)
        P *= s
    samples += 1 * P  # latent head, k=3
    return math.ceil(samples / model.hop_length) + margin


def decoder_halo_frames(model: DAC, margin: int = 2) -> int:
    """One-sided receptive field of the decoder, in code frames (rounded
    up, plus ``margin``): the k=7 stem at the code rate, per stage a k=2s
    transposed conv and three dilated residual units at the upsampled rate,
    and the k=7 waveform head."""
    frames = 3.0  # stem conv, k=7, at code rate
    U = 1
    for s in reversed(model.encoder_rates):  # decoder strides
        frames += 2.0 / U  # transposed conv, k=2s: <=2 input frames of context
        U *= s
        frames += _RU_CONTEXT / U
    frames += 3.0 / U  # waveform head, k=7
    return math.ceil(frames) + margin


def _window_starts(total: int, chunk: int, halo: int, W: int):
    """Yield ``(start, lo, hi)``: window start and the central slice
    ``[lo, hi)`` (window-relative) holding output positions
    ``[i*chunk, min((i+1)*chunk, total))``.

    The one source of the clamped window-start invariant; both flush paths
    iterate it (``_emit_ready`` cannot: the right clamp needs ``total``,
    unknown until the stream ends)."""
    n = math.ceil(total / chunk)
    for i in range(n):
        pos = i * chunk
        end = min(pos + chunk, total)
        start = min(max(pos - halo, 0), total - W)
        yield start, pos - start, end - start


def _as_tensor(x, device, dtype) -> torch.Tensor:
    """A tensor or numpy array as a tensor of ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=dtype)


class StreamingEncoder:
    """Incremental waveform -> codes encoder with bounded memory.

    >>> enc = StreamingEncoder(model, batch_size=1)
    >>> for block in microphone_blocks():          # any block sizes
    ...     for codes in enc.push(block):          # (B, n_q, chunk) each
    ...         ship(codes)
    >>> for codes in enc.flush():                  # drain the tail
    ...     ship(codes)

    Emitted chunks concatenate to exactly the whole-signal
    ``model.encode(audio)`` codes. Latency: ``chunk + halo`` frames of
    lookahead (``chunk`` amortizes the fixed per-call cost; lower it for
    lower latency).
    """

    def __init__(
        self,
        model: DAC,
        batch_size: int = 1,
        chunk_frames: int = 128,
        halo_frames: Optional[int] = None,
        n_quantizers: Optional[int] = None,
    ):
        self.model = model
        self.hop = model.hop_length
        self.chunk = int(chunk_frames)
        self.halo = encoder_halo_frames(model) if halo_frames is None else halo_frames
        if self.chunk < 1:
            raise ValueError("chunk_frames must be >= 1")
        self.W = (self.chunk + 2 * self.halo) * self.hop  # window samples
        self._nq = n_quantizers
        self.device = model.device
        self._buf = torch.zeros(batch_size, 1, 0, device=self.device)
        self._consumed = 0  # samples dropped from the left of _buf
        self._next_frame = 0  # next frame index to emit
        self._flushed = False

    def _enc(self, window: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), strict_fp32():
            return self.model.encode(window.contiguous(), self._nq)[1]

    def _window(self, start_samples: int) -> torch.Tensor:
        lo = start_samples - self._consumed
        return self._buf[:, :, lo: lo + self.W]

    def _emit_ready(self) -> Iterator[torch.Tensor]:
        """Emit every chunk whose window fits in the buffered samples."""
        have = self._consumed + self._buf.shape[-1]
        while True:
            pos = self._next_frame  # frames; steady state: not clamped
            start = max(pos - self.halo, 0) * self.hop
            if start + self.W > have:
                return
            codes = self._enc(self._window(start))
            lo = pos - (start // self.hop)
            yield codes[:, :, lo: lo + self.chunk]
            self._next_frame = pos + self.chunk
            # retain one full WINDOW of history, not just the halo: the
            # flush path's right-clamped final window can start as far
            # back as (stream_end - W) <= (next - chunk - 2*halo)
            keep_from = max(self._next_frame - self.chunk - 2 * self.halo, 0) * self.hop
            if keep_from > self._consumed:
                self._buf = self._buf[:, :, keep_from - self._consumed:]
                self._consumed = keep_from

    def push(self, samples) -> Iterator[torch.Tensor]:
        """Feed ``(B, 1, n)`` (or ``(n,)``) samples, a tensor or a numpy
        array; yields zero or more ``(B, n_q, chunk)`` code blocks as they
        become computable."""
        if self._flushed:
            raise RuntimeError("push() after flush()")
        samples = _as_tensor(samples, self.device, torch.float32)
        if samples.ndim == 1:
            samples = samples[None, None]
        if samples.ndim != 3 or samples.shape[0] != self._buf.shape[0]:
            raise ValueError(
                f"expected (B={self._buf.shape[0]}, 1, n) samples, got {tuple(samples.shape)}")
        self._buf = torch.cat([self._buf, samples], dim=-1)
        yield from self._emit_ready()

    def flush(self) -> Iterator[torch.Tensor]:
        """Drain the tail: pad the stream to a whole frame, emit the
        remaining chunks (the final one may be shorter)."""
        if self._flushed:
            return
        self._flushed = True
        total_samples = self._consumed + self._buf.shape[-1]
        total = math.ceil(total_samples / self.hop)  # frames, model pads
        if total == 0:
            return
        pad = total * self.hop - total_samples
        if total * self.hop < self.W:
            # stream shorter than one window: one call of the whole model
            codes = self._enc(F.pad(self._buf, (0, pad)))[:, :, self._next_frame:]
            if codes.shape[-1]:
                yield codes
            return
        if pad:
            self._buf = F.pad(self._buf, (0, pad))
        Wf = self.W // self.hop  # window length in frames
        for start, lo, hi in _window_starts(total, self.chunk, self.halo, Wf):
            if start + lo < self._next_frame:
                continue  # already emitted by _emit_ready
            codes = self._enc(self._window(start * self.hop))
            yield codes[:, :, lo:hi]
            self._next_frame = start + hi


class StreamingDecoder:
    """Incremental codes -> waveform decoder (mirror of
    :class:`StreamingEncoder`, in the code-frame domain)."""

    def __init__(
        self,
        model: DAC,
        batch_size: int = 1,
        chunk_frames: int = 128,
        halo_frames: Optional[int] = None,
    ):
        self.model = model
        self.hop = model.hop_length
        self.chunk = int(chunk_frames)
        self.halo = decoder_halo_frames(model) if halo_frames is None else halo_frames
        self.W = self.chunk + 2 * self.halo  # window frames
        self.device = model.device
        self._buf = None  # (B, n_q, frames), sized on the first push
        self._batch = batch_size
        self._consumed = 0
        self._next_frame = 0
        self._flushed = False

    def _dec(self, window: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), strict_fp32():
            return self.model.decode_from_codes(window.contiguous())

    def _window(self, start: int) -> torch.Tensor:
        lo = start - self._consumed
        return self._buf[:, :, lo: lo + self.W]

    def _emit_ready(self) -> Iterator[torch.Tensor]:
        have = self._consumed + self._buf.shape[-1]
        while True:
            pos = self._next_frame
            start = max(pos - self.halo, 0)
            if start + self.W > have:
                return
            audio = self._dec(self._window(start))
            lo = (pos - start) * self.hop
            yield audio[:, :, lo: lo + self.chunk * self.hop]
            self._next_frame = pos + self.chunk
            # one full window of history (see StreamingEncoder note)
            keep_from = max(self._next_frame - self.chunk - 2 * self.halo, 0)
            if keep_from > self._consumed:
                self._buf = self._buf[:, :, keep_from - self._consumed:]
                self._consumed = keep_from

    def push(self, codes) -> Iterator[torch.Tensor]:
        """Feed ``(B, n_q, frames)`` codes, a tensor or a numpy array of
        integers; yields zero or more ``(B, 1, chunk*hop)`` waveform
        blocks."""
        if self._flushed:
            raise RuntimeError("push() after flush()")
        codes = _as_tensor(codes, self.device, torch.long)
        if codes.ndim != 3 or codes.shape[0] != self._batch:
            raise ValueError(
                f"expected (B={self._batch}, n_q, frames) codes, got {tuple(codes.shape)}")
        if self._buf is None:
            self._buf = codes.new_zeros(codes.shape[:2] + (0,))
        self._buf = torch.cat([self._buf, codes], dim=-1)
        yield from self._emit_ready()

    def flush(self) -> Iterator[torch.Tensor]:
        if self._flushed or self._buf is None:
            return
        self._flushed = True
        total = self._consumed + self._buf.shape[-1]
        if total == 0:
            return
        if total < self.W:
            # stream shorter than one window: one call of the whole model
            audio = self._dec(self._buf)[:, :, self._next_frame * self.hop:]
            if audio.shape[-1]:
                yield audio
            return
        for start, lo, hi in _window_starts(total, self.chunk, self.halo, self.W):
            if start + lo < self._next_frame:
                continue  # already emitted by _emit_ready
            audio = self._dec(self._window(start))
            yield audio[:, :, lo * self.hop: hi * self.hop]
            self._next_frame = start + hi


def stream_encode(
    model: DAC,
    audio,
    chunk_frames: int = 128,
    halo_frames: Optional[int] = None,
    n_quantizers: Optional[int] = None,
) -> torch.Tensor:
    """One-shot chunked encode of ``(B, 1, T)`` audio (a tensor or a numpy
    array): the whole-signal ``model.encode`` codes computed through
    fixed-length windows with O(chunk) device memory. Returns ``(B, n_q,
    ceil(T/hop))`` codes on the model's device."""
    if audio.ndim != 3:
        raise ValueError(f"expected (B, 1, T) audio, got {tuple(audio.shape)}")
    enc = StreamingEncoder(model, audio.shape[0], chunk_frames, halo_frames, n_quantizers)
    out = list(enc.push(audio))
    out += list(enc.flush())
    return torch.cat(out, dim=-1)


def stream_decode(
    model: DAC,
    codes,
    chunk_frames: int = 128,
    halo_frames: Optional[int] = None,
) -> torch.Tensor:
    """One-shot chunked decode of ``(B, n_q, F)`` codes -> ``(B, 1, F*hop)``
    waveform on the model's device, equal to ``model.decode_from_codes``."""
    if codes.ndim != 3:
        raise ValueError(f"expected (B, n_q, F) codes, got {tuple(codes.shape)}")
    dec = StreamingDecoder(model, codes.shape[0], chunk_frames, halo_frames)
    out = list(dec.push(codes))
    out += list(dec.flush())
    return torch.cat(out, dim=-1)
