"""Effects on AudioSignals: mixing at an SNR, impulse-response
convolution with DRR alteration, loudness normalization, EQ and pitch
shift.

Counterpart of the augmentation-path subset of
``audiotools_tpu/core/_effects.py``. Every effect is batched and runs on
the signal's device.
"""
import torch

from . import util
from ..ops import filters as _filters
from ..ops import loudness as _loudness
from ..ops import stretch as _stretch


class EffectMixin:
    GAIN_FACTOR = _loudness.GAIN_FACTOR

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
        alteration of the IR, then rescale to the dry signal's peak."""
        if use_original_phase:
            raise NotImplementedError(
                "apply_ir(use_original_phase=True) is not ported yet (ROADMAP.md, Queue 1: core/)"
            )
        if ir_eq is not None:
            ir = ir.equalizer(ir_eq)
        if drr is not None:
            ir = ir.alter_drr(drr)
        max_spk = torch.abs(self.audio_data).amax(dim=-1, keepdim=True)
        self.convolve(ir)
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

    def equalizer(self, db):
        """Mel-spaced graphic EQ; ``db`` is ``(n_bands,)`` or ``(1 or B, n_bands)``."""
        db = util.ensure_tensor(db, device=self.audio_data.device)
        if db.ndim == 2 and db.shape[0] not in (1, self.batch_size):
            raise ValueError("EQ batch dim must be 1 or match the signal")
        self.audio_data = _filters.equalizer(self.audio_data, db, self.sample_rate)
        return self

    def pitch_shift(self, n_semitones: float, **kwargs):
        """Shift pitch by ``n_semitones`` keeping the duration
        (``ops.stretch.pitch_shift``; keyword arguments pass through)."""
        self.audio_data = _stretch.pitch_shift(
            self.audio_data, n_semitones, self.sample_rate, **kwargs
        )
        return self


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
