"""Effects on AudioSignals: mixing at an SNR, impulse-response
convolution with DRR alteration, loudness normalization, EQ and the mel
band split, pitch shift and time stretch, percentile clipping, (mu-law)
quantization and the PCM codec presets.

Counterpart of ``audiotools_tpu/core/_effects.py``. Every effect is
batched and runs on the signal's device, apart from the compressed codecs
(MP3, Vorbis/Ogg, GSM-FR, AMR-NB): those take one device-to-host copy of
the batch through the host codec libraries (``io.codecs``, ``io.amrnb``)
and return to the signal's device; the telephone codecs' resamples to and
from 8 kHz run on the device.
"""
import tempfile

import numpy as np
import torch

from . import util
from ._dsp import _polar
from ..ops import filters as _filters
from ..ops import loudness as _loudness
from ..ops import stretch as _stretch


class EffectMixin:
    GAIN_FACTOR = _loudness.GAIN_FACTOR
    CODEC_PRESETS = {
        "8-bit": {"format": "wav", "encoding": "ULAW", "bits_per_sample": 8},
        "GSM-FR": {"format": "gsm"},
        "MP3": {"format": "mp3", "compression": -9},
        "Vorbis": {"format": "vorbis", "compression": -1},
        "Ogg": {"format": "ogg", "compression": -1},
        "Amr-nb": {"format": "amr-nb"},
    }
    """The original library's codec presets."""

    def mix(self, other, snr=10, other_eq=None):
        """Mix ``other`` into this signal at ``snr`` dB below its loudness,
        after EQ-ing ``other`` by ``other_eq``."""
        snr = util.ensure_tensor(snr, device=self.audio_data.device)
        other.zero_pad(0, max(0, self.signal_length - other.signal_length))
        other.truncate_samples(self.signal_length)
        if other_eq is not None:
            other = other.equalizer(other_eq)

        # Both loudnesses from one meter call over the stacked batch when
        # neither is cached: gating is per item, so the results are the same.
        if (self._loudness is None and other._loudness is None
                and other.audio_data.shape == self.audio_data.shape
                and other.sample_rate == self.sample_rate):
            stacked = _loudness.loudness(
                torch.cat([self.audio_data, other.audio_data], dim=0), self.sample_rate
            )
            nb = self.audio_data.shape[0]
            self._loudness = stacked[:nb]
            other._loudness = stacked[nb:]

        other = other.normalize(self.loudness() - snr)
        self.audio_data = self.audio_data + other.audio_data
        return self

    def convolve(self, other, start_at_max: bool = True):
        """Circular convolution (period: this signal's length) with the
        impulse response ``other``, normalized by the IR's peak and, with
        ``start_at_max``, rolled so each IR's peak lands at t = 0.

        Evaluated as a power-of-two linear convolution folded back mod the
        length. For an IR much shorter than the signal, the samples the
        power-of-two transform wraps are recovered from a small auxiliary
        convolution of the two tails.
        """
        length = self.signal_length
        K = other.signal_length
        if K > length:
            other.truncate_samples(length)
            K = length
        ir = other.audio_data  # (B, C_ir, K)
        x = self.audio_data
        fft, ifft = torch.fft.rfft, torch.fft.irfft

        n = 1 << (length - 1).bit_length()
        m = length + K - 1 - n  # samples of the linear conv the pow2 transform wraps
        if K < length and 0 < m <= n // 4:
            Y = ifft(fft(x, n=n) * fft(ir, n=n), n=n)
            p = 1 << (2 * m - 2).bit_length() if m > 1 else 1
            small = ifft(fft(x[..., -m:], n=p) * fft(ir[..., -m:], n=p), n=p)
            alias = small[..., m - 1 : 2 * m - 1]  # linear conv [n, n + m)
            y = Y[..., :length].clone()
            y[..., :m] -= alias
            y[..., : K - 1] += torch.cat([Y[..., length:n], alias], dim=-1)
        elif K < length and m <= 0:
            lin = ifft(fft(x, n=n) * fft(ir, n=n), n=n)[..., : length + K - 1]
            y = lin[..., :length].clone()
            y[..., : K - 1] += lin[..., length:]
        else:
            if K < length:
                other.zero_pad(0, length - K)
                ir = other.audio_data
            n2 = 1 << (2 * length - 1).bit_length()
            lin = ifft(fft(ir, n=n2) * fft(x, n=n2), n=n2)[..., : 2 * length - 1]
            y = lin[..., :length].clone()
            y[..., : length - 1] += lin[..., length:]

        if start_at_max:
            shift = torch.abs(ir).argmax(dim=-1).amax(dim=1)  # (B,)
            idx = (torch.arange(length, device=y.device)[None, :] + shift[:, None]) % length
            y = torch.gather(y, -1, idx[:, None, :].expand(y.shape))

        delta_max = torch.abs(ir).amax(dim=-1, keepdim=True)
        self.audio_data = y * (1 / torch.clamp(delta_max, min=1e-5))
        return self

    def apply_ir(self, ir, drr=None, ir_eq=None, use_original_phase: bool = False):
        """Convolve with an impulse response after optional EQ and DRR
        alteration of the IR, then rescale to the dry signal's peak.

        ``use_original_phase``: the wet signal's STFT magnitude on the dry
        signal's STFT phase (at ``stft_params``), inverted at the dry length,
        before the rescale."""
        if ir_eq is not None:
            ir = ir.equalizer(ir_eq)
        if drr is not None:
            ir = ir.alter_drr(drr)
        max_spk = torch.abs(self.audio_data).amax(dim=-1, keepdim=True)
        # the dry phase costs an STFT: take it only when it is used
        phase = self.phase if use_original_phase else None
        self.convolve(ir)
        if use_original_phase:
            # setting audio_data keeps the cached (dry) STFT: take the wet one
            self.stft()
            self.stft_data = _polar(self.magnitude, phase)
            self.istft()
        max_transformed = torch.abs(self.audio_data).amax(dim=-1, keepdim=True)
        scale = torch.clamp(max_spk, min=1e-8) / torch.clamp(max_transformed, min=1e-8)
        self.audio_data = self.audio_data * scale
        return self

    def ensure_max_of_audio(self, max: float = 1.0):
        """Scale down items whose peak exceeds ``max``."""
        peak = torch.abs(self.audio_data).amax(dim=-1, keepdim=True)
        gain = torch.where(peak > max, max / torch.clamp(peak, min=1e-12), 1.0)
        self.audio_data = self.audio_data * gain
        return self

    def normalize(self, db=-24.0):
        """Scale each item to the loudness ``db`` LUFS."""
        db = util.ensure_tensor(db, device=self.audio_data.device)
        gain = torch.exp((db - self.loudness()) * self.GAIN_FACTOR)
        self.audio_data = self.audio_data * gain[:, None, None]
        return self

    def volume_change(self, db):
        """Change each item's level by ``db`` decibels."""
        db = util.ensure_tensor(db, ndim=1, device=self.audio_data.device)
        self.audio_data = self.audio_data * torch.exp(db * self.GAIN_FACTOR)[:, None, None]
        return self

    def mel_filterbank(self, n_bands: int):
        """The audio split into ``n_bands`` mel bands, ``(B, C, T, n_bands)``
        (``ops.filters.split_bands``)."""
        return _filters.split_bands(self.audio_data, self.sample_rate, n_bands)

    def equalizer(self, db, conv_method: str = None):
        """Mel-spaced graphic EQ; ``db`` is ``(n_bands,)`` or ``(1 or B,
        n_bands)``; ``conv_method`` as ``ops.filters.equalizer`` takes it."""
        db = util.ensure_tensor(db, device=self.audio_data.device)
        if db.ndim == 2 and db.shape[0] not in (1, self.batch_size):
            raise ValueError("EQ batch dim must be 1 or match the signal")
        self.audio_data = _filters.equalizer(self.audio_data, db, self.sample_rate,
                                             conv_method=conv_method)
        return self

    def pitch_shift(self, n_semitones: float, quick: bool = True, **kwargs):
        """Shift pitch by ``n_semitones`` keeping the duration
        (``ops.stretch.pitch_shift``; other keyword arguments pass through).
        ``quick`` is accepted for the original library's signature and
        ignored. The cached STFT is dropped."""
        self.audio_data = _stretch.pitch_shift(
            self.audio_data, n_semitones, self.sample_rate, **kwargs
        )
        self.stft_data = None
        return self

    def time_stretch(self, factor: float, quick: bool = True, **kwargs):
        """Stretch the duration by ``1 / factor`` keeping the pitch
        (``ops.stretch.time_stretch``; other keyword arguments, such as
        ``pv_formulation``, pass through). ``quick`` is accepted for the
        original library's signature and ignored. The cached STFT is
        dropped."""
        self.audio_data = _stretch.time_stretch(self.audio_data, factor, **kwargs)
        self.stft_data = None
        return self

    def apply_codec(self, preset: str = None, format: str = "wav", encoding: str = None,
                    bits_per_sample: int = None, compression: int = None):
        """Round-trip through a codec: a ``preset`` of ``CODEC_PRESETS`` or
        the format given. ``wav`` runs on the device as uniform quantization
        at ``bits_per_sample`` (16 by default), or mu-law with ``encoding
        "ULAW"`` (8 by default). ``mp3``, ``vorbis``/``ogg``, ``gsm`` and
        ``amr-nb`` run the host codecs on one device-to-host copy of the
        batch (MP3 realigned past its codec delay; GSM and AMR-NB at 8 kHz,
        resampled on the device) and put the result back on the signal's
        device. A codec whose system library is missing raises
        ``RuntimeError``."""
        if preset is None:
            kwargs = dict(format=format, encoding=encoding, bits_per_sample=bits_per_sample,
                          compression=compression)
        elif preset in self.CODEC_PRESETS:
            kwargs = dict(self.CODEC_PRESETS[preset])
        else:
            raise ValueError(f"Unknown preset: {preset}. "
                             f"Known presets: {list(self.CODEC_PRESETS.keys())}")
        fmt = kwargs.get("format", "wav")
        if fmt == "wav":
            if kwargs.get("encoding") == "ULAW":
                return self.mulaw_quantization(2 ** (kwargs.get("bits_per_sample") or 8))
            return self.quantization(2 ** (kwargs.get("bits_per_sample") or 16))
        from ..io import amrnb, codecs

        compression = kwargs.get("compression")
        if fmt == "mp3":
            if not codecs.mp3_available():
                raise RuntimeError("MP3 codec libraries not available")
            # sox's compression semantics for mp3: negative = LAME VBR
            # quality (integer part, 9 = worst), positive = CBR kbps,
            # None = the encoder's default
            enc_kwargs = {}
            if compression is not None:
                c = float(compression)
                if c < 0:
                    enc_kwargs["vbr_quality"] = min(9, int(-c))
                else:
                    enc_kwargs["bitrate"] = max(8, int(round(c)))
            return self._host_codec_roundtrip(
                lambda item: _mp3_roundtrip(item, self.sample_rate, enc_kwargs))
        if fmt == "gsm":
            if not codecs.gsm_available():
                raise RuntimeError("GSM codec library not available")
            return self._telephone_codec_roundtrip(
                lambda host: np.stack([codecs.gsm_roundtrip(item) for item in host]))
        if fmt in ("vorbis", "ogg"):
            if not (codecs.vorbis_encode_available() and codecs.vorbis_available()):
                raise RuntimeError("Vorbis codec libraries not available")
            # sox's vorbis quality scale over 10, clamped to libvorbisenc's
            # [-0.1, 1.0]; sox's default is 3
            quality = float(np.clip((3.0 if compression is None else compression) / 10.0,
                                    -0.1, 1.0))
            return self._host_codec_roundtrip(
                lambda item: _ogg_roundtrip(item, self.sample_rate, quality))
        if fmt == "amr-nb":
            return self._telephone_codec_roundtrip(amrnb.amrnb_roundtrip_batch)
        raise RuntimeError(
            f"Codec format '{fmt}' requires external codec libraries that are not "
            "available; native support: wav (PCM/ULAW), mp3, ogg/vorbis, gsm, amr-nb."
        )

    def _host_codec_roundtrip(self, roundtrip):
        """Run ``roundtrip`` ((C, T) numpy -> (C, >= T)) on each item of one
        host copy of the batch, keep ``T`` samples (zero-padded where the
        codec returns fewer) and put the batch back on the signal's device."""
        T = self.signal_length
        host = self.audio_data.detach().cpu().numpy()
        out = []
        for item in host:
            dec = roundtrip(item)
            if dec.shape[-1] < T:
                dec = np.pad(dec, ((0, 0), (0, T - dec.shape[-1])))
            out.append(dec[:, :T])
        self.audio_data = torch.from_numpy(np.stack(out)).to(self.audio_data.device)
        return self

    def _telephone_codec_roundtrip(self, roundtrip):
        """Shared scaffolding of the 8 kHz mono telephone codecs (GSM-FR,
        AMR-NB): resample down on the device, run the host ``roundtrip``
        (``(B, C, T)`` numpy in and out: the ACELP coder codes the batch in
        one lockstep pass, libgsm item by item) on one host copy of the
        batch, resample back on the device, and restore the length."""
        orig_sr, T = self.sample_rate, self.signal_length
        self.resample(8000)
        out = roundtrip(self.audio_data.detach().cpu().numpy())
        self.audio_data = torch.from_numpy(np.asarray(out, np.float32)).to(self.audio_data.device)
        self.resample(orig_sr)
        if self.signal_length < T:
            self.zero_pad(0, T - self.signal_length)
        self.truncate_samples(T)
        return self

    def clip_distortion(self, clip_percentile):
        """Clip each item to its ``clip_percentile / 2`` and ``1 -
        clip_percentile / 2`` quantiles (one percentile per item)."""
        perc = util.ensure_tensor(clip_percentile, ndim=1, device=self.audio_data.device)
        perc = perc.reshape(-1).expand(self.batch_size)
        x = self.audio_data
        lo, hi = _row_quantiles(x, torch.stack([perc / 2, 1 - perc / 2]))
        self.audio_data = torch.clamp(x, lo, hi)
        return self

    def quantization(self, quantization_channels):
        """Uniform quantization to ``quantization_channels`` levels, with a
        straight-through gradient."""
        q = util.ensure_tensor(quantization_channels, ndim=3, device=self.audio_data.device)
        x = self.audio_data
        x = (x + 1) / 2
        x = x * q
        x = torch.floor(x)
        x = x / q
        x = 2 * x - 1
        self.audio_data = self.audio_data - (self.audio_data - x).detach()
        return self

    def mulaw_quantization(self, quantization_channels):
        """Mu-law quantization to ``quantization_channels`` levels, with a
        straight-through gradient."""
        mu = util.ensure_tensor(quantization_channels - 1.0, ndim=3,
                                device=self.audio_data.device).float()
        x = self.audio_data
        x = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / torch.log1p(mu)
        x = ((x + 1) / 2 * mu + 0.5).to(torch.int32).float()  # truncation, as astype
        x = (x / mu) * 2 - 1.0
        # exp in float64, rounded once: the CPU's float32 exp gave results up
        # to ~190 ulps apart from one process to the next for one input
        expanded = torch.exp((torch.abs(x) * torch.log1p(mu)).double()).float()
        x = torch.sign(x) * (expanded - 1.0) / mu
        self.audio_data = self.audio_data - (self.audio_data - x).detach()
        return self


    def __matmul__(self, other):
        return self.convolve(other)


def _row_quantiles(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Quantiles ``(Q, B, C, 1)`` of each ``(B, C, T)`` row at per-item
    levels ``q`` ``(Q, B)``, as ``jnp.quantile`` computes them: a sort, the
    position ``q (T - 1)`` in fp32, and linear interpolation between its
    floor and ceiling. A row holding a NaN gives NaN. (``torch.quantile``
    takes one level for all rows and refuses inputs over 2**24 elements.)"""
    n = x.shape[-1]
    last = float(np.float32(n) - np.float32(1))  # n - 1 rounded as fp32 rounds it
    x = torch.where(torch.isnan(x).any(-1, keepdim=True), torch.nan, x)
    s = torch.sort(x, dim=-1).values.expand(q.shape[0], *x.shape)
    pos = q * last
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w

    def at(p):
        idx = p.clamp(0, last).long()[..., None, None].expand(*q.shape, x.shape[1], 1)
        return s.gather(-1, idx)

    return at(low) * low_w[..., None, None] + at(high) * high_w[..., None, None]


class ImpulseResponseMixin:
    """Early/late decomposition of impulse responses and DRR alteration."""

    def decompose_ir(self):
        """Early response (within 2.5 ms of the peak), late field, and a
        periodic Hann window over each item's early span."""
        data = self.audio_data
        td = data.argmax(dim=-1, keepdim=True)
        t0 = int(self.sample_rate * 0.0025)
        idx = torch.arange(data.shape[-1], device=data.device)[None, None, :]
        early_idx = (idx >= td - t0) & (idx <= td + t0)
        early_response = torch.where(early_idx, data, 0.0)
        late_field = torch.where(early_idx, 0.0, data)
        span = early_idx.sum(dim=-1, keepdim=True)
        k = idx - torch.clamp(td - t0, min=0)
        hann = 0.5 - 0.5 * torch.cos(2 * torch.pi * k / torch.clamp(span, min=1))
        return early_response, late_field, torch.where(early_idx, hann, 0.0)

    def measure_drr(self):
        """Direct-to-reverberant ratio in dB, ``(B, C)``."""
        early_response, late_field, _ = self.decompose_ir()
        return 10 * torch.log10((early_response ** 2).sum(-1) / (late_field ** 2).sum(-1))

    @staticmethod
    def solve_alpha(early_response, late_field, wd, target_drr):
        """Scale of the windowed early response that reaches ``target_drr``
        (larger root of the quadratic)."""
        e_sq = early_response ** 2
        a = (wd ** 2 * e_sq).sum(-1)
        b = (2 * (1 - wd) * wd * e_sq).sum(-1)
        c = ((1 - wd) ** 2 * e_sq).sum(-1) - torch.pow(10, target_drr / 10) * (
            late_field ** 2
        ).sum(-1)
        expr = torch.sqrt(b ** 2 - 4 * a * c)
        return torch.maximum((-b - expr) / (2 * a), (-b + expr) / (2 * a))

    def alter_drr(self, drr):
        """Rescale the early response so the IR has DRR ``drr`` dB."""
        drr = util.ensure_tensor(drr, 2, self.batch_size, device=self.audio_data.device)
        early_response, late_field, window = self.decompose_ir()
        alpha = self.solve_alpha(early_response, late_field, window, drr)
        min_alpha = torch.abs(late_field).amax(-1) / torch.clamp(
            torch.abs(early_response).amax(-1), min=1e-12
        )
        alpha = torch.maximum(alpha, min_alpha)[..., None]
        self.audio_data = early_response * (1 + (alpha - 1) * window) + late_field
        return self.ensure_max_of_audio()


def _mp3_roundtrip(orig, sample_rate, enc_kwargs):
    """One ``(C, T)`` item through lame and mpg123, with the codec delay
    found by cross-correlating the first channels and trimmed, so that the
    augmentation stays time-aligned with its input."""
    from ..io import codecs

    T = orig.shape[-1]
    with tempfile.NamedTemporaryFile(suffix=".mp3") as f:
        codecs.write_mp3(f.name, orig, sample_rate, **enc_kwargs)
        dec, _ = codecs.read_mp3(f.name)
    n = 1 << int(np.ceil(np.log2(dec.shape[-1] + T)))
    xc = np.fft.irfft(np.fft.rfft(dec[0], n) * np.conj(np.fft.rfft(orig[0], n)), n)
    lag = int(np.argmax(xc[: dec.shape[-1] - T + 1])) if dec.shape[-1] > T else 0
    return dec[:, lag:]


def _ogg_roundtrip(orig, sample_rate, quality):
    """One ``(C, T)`` item through libvorbisenc and libvorbisfile. Vorbis is
    granulepos-aligned: the decode is sample-accurate, with no delay."""
    from ..io import codecs

    with tempfile.NamedTemporaryFile(suffix=".ogg") as f:
        codecs.write_ogg(f.name, orig, sample_rate, quality)
        dec, _ = codecs.read_ogg(f.name)
    return dec
