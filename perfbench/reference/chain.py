"""Plain reference of the augmentation chain: the four transforms
(``RoomImpulseResponse``, ``BackgroundNoise``, ``Equalizer``,
``VolumeNorm``), the pitch shift, the mel spectrogram and the BS.1770
meter, in float64 PyTorch (scipy's ``lfilter`` for the weighting filters).

It follows descriptinc/audiotools v0.7.4 (``audiotools/core/effects.py``,
``dsp.py``, ``loudness.py``, ``data/transforms.py``) with these departures,
which are the library's own in this repository:

- the graphic EQ splits into HTK-mel-spaced bands by Hann-windowed sinc
  low-passes (8 zero crossings at the lowest cutoff), edge-padded, where
  julius splits with its own windowed sinc;
- the pitch shift is a phase vocoder (window 2048, hop 512) and a
  Hann-squared windowed-sinc resample (24 zero crossings, roll-off 0.945)
  by the nearest small fraction of the pitch ratio, where the library
  calls torchaudio's ``pitch_shift``;
- the meter's blocks are zero-padded at the end to a whole count, and the
  loudness is clamped at -70 LUFS;
- the fast meter, where a configuration states it, is each K-weighting
  stage's impulse response cut to ``zeros`` taps, composed.

It imports nothing of the program and takes nothing the program made:
filter designs, DFTs, mel bases, resample kernels and loudness are all made
here. ``q`` rounds an operand to the precision under test: the identity for
the reference, a lower precision for the control (``rounding``).
"""
import math
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

GAIN_FACTOR = math.log(10) / 20
MIN_LOUDNESS = -70.0
# K-weighting as RBJ biquads whose bilinear design gives BS.1770-4's 48 kHz
# table and scales to any rate: (type, gain dB, Q, fc)
K_SHELF = ("high_shelf", 3.99979529, 0.707315703, 1500.51207)
K_HIGHPASS = ("high_pass", 0.0, 0.50032685, 38.13546889)


def identity(x):
    return x


def _tf32(x):
    """Round to TF32's 10-bit mantissa (to nearest), as the tensor cores
    round fp32 operands."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def _straight_through(round_):
    """The rounding's value with the identity's gradient."""
    def q(x):
        return x + (round_(x.detach()) - x.detach())
    return q


def rounding(dtype):
    """``q`` that rounds a float tensor to ``dtype`` and back (``"tf32"``:
    TF32's mantissa); fp8 is scaled by the tensor's largest magnitude
    first. Gradients pass through as if unrounded."""
    if dtype == "tf32":
        return _straight_through(_tf32)
    if dtype in (torch.float8_e4m3fn,):
        def q8(x):
            scale = x.abs().amax().clamp(min=1e-30) / 448.0
            return (x / scale).to(dtype).to(x.dtype) * scale
        return _straight_through(q8)
    return _straight_through(lambda x: x.to(dtype).to(x.dtype))


# ---------------------------------------------------------------------------
# graphic EQ
# ---------------------------------------------------------------------------


def band_cutoffs(sr, n_bands):
    high = 2595.0 * math.log10(1 + (sr / 2) / 700.0)
    mels = np.linspace(0.0, high, n_bands + 1)
    return 700.0 * (10.0 ** (mels[1:-1] / 2595.0) - 1.0)


def band_lowpasses(sr, n_bands, zeros=8):
    """Low-pass kernels at the interior cutoffs, one support (the lowest
    cutoff's) and unit sum each: ``(n_bands - 1, 2 half + 1)``, ``half``."""
    cut = band_cutoffs(sr, n_bands) / sr
    half = int(zeros / cut.min() / 2)
    t = np.arange(-half, half + 1, dtype=np.float64)
    win = np.hanning(2 * half + 1)
    kernels = []
    for c in cut:
        k = 2 * c * win * np.sinc(2 * c * t)
        kernels.append(k / k.sum())
    return np.stack(kernels), half


def _fft_correlate_valid(x, kernel, out_len):
    """``y[t] = sum_j kernel[j] x[t + j]`` for ``t < out_len``."""
    L = kernel.shape[-1]
    n = 1 << (x.shape[-1] + L - 1).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(kernel.flip(-1), n=n), n=n)
    return y[..., L - 1: L - 1 + out_len]


def equalizer(x, db, sr, q=identity):
    """``x`` ``(B, C, T)``; ``db`` ``(B or 1, n_bands)`` log10 gains: each
    band weighted by ``10 ** db`` and summed."""
    T = x.shape[-1]
    weights = 10.0 ** db.to(x.dtype)
    if weights.ndim == 1:
        weights = weights[None]
    kernels, half = band_lowpasses(sr, weights.shape[-1])
    k = q(torch.as_tensor(kernels, dtype=x.dtype, device=x.device))
    xp = q(F.pad(x, (half, half), mode="replicate"))
    lows = [_fft_correlate_valid(xp, k[i], T) for i in range(k.shape[0])]
    bands = [lows[0]] + [lows[i] - lows[i - 1] for i in range(1, len(lows))] + [x - lows[-1]]
    return sum(weights[:, i, None, None] * b for i, b in enumerate(bands))


# ---------------------------------------------------------------------------
# room impulse response
# ---------------------------------------------------------------------------


def alter_drr(ir, drr, sr):
    """Scale each impulse response's early part (2.5 ms around its peak,
    Hann-windowed) so its direct-to-reverberant ratio is ``drr`` dB."""
    B, C, K = ir.shape
    td = ir.argmax(dim=-1, keepdim=True)
    t0 = int(sr * 0.0025)
    idx = torch.arange(K, device=ir.device)[None, None]
    early = (idx >= td - t0) & (idx <= td + t0)
    e = torch.where(early, ir, 0.0)
    late = torch.where(early, 0.0, ir)
    span = early.sum(-1, keepdim=True)
    k = idx - torch.clamp(td - t0, min=0)
    w = torch.where(early, 0.5 - 0.5 * torch.cos(2 * math.pi * k / span.clamp(min=1)), 0.0)
    target = drr.to(ir.dtype).reshape(B, 1)
    e2 = e ** 2
    a = (w ** 2 * e2).sum(-1)
    b = (2 * (1 - w) * w * e2).sum(-1)
    c = ((1 - w) ** 2 * e2).sum(-1) - 10 ** (target / 10) * (late ** 2).sum(-1)
    disc = torch.sqrt(b ** 2 - 4 * a * c)
    alpha = torch.maximum((-b - disc) / (2 * a), (-b + disc) / (2 * a))
    alpha = torch.maximum(alpha, late.abs().amax(-1) / e.abs().amax(-1).clamp(min=1e-12))
    out = e * (1 + (alpha[..., None] - 1) * w) + late
    peak = out.abs().amax(-1, keepdim=True)
    return out * torch.where(peak > 1.0, 1.0 / peak.clamp(min=1e-12), 1.0)


def circular_convolve(x, ir, q=identity):
    """Convolution of period ``T`` with the IR, rolled so the IR's largest
    magnitude lands at t = 0, divided by that magnitude."""
    T = x.shape[-1]
    ir = ir[..., :T]
    y = torch.fft.irfft(torch.fft.rfft(q(x), n=T) * torch.fft.rfft(q(ir), n=T), n=T)
    shift = ir.abs().argmax(-1).amax(1)
    idx = (torch.arange(T, device=x.device)[None] + shift[:, None]) % T
    y = torch.gather(y, -1, idx[:, None].expand(y.shape))
    return y / ir.abs().amax(-1, keepdim=True).clamp(min=1e-5)


def apply_ir(x, ir, drr, eq, sr, q=identity):
    ir = alter_drr(equalizer(ir, eq, sr, q), drr, sr)
    dry_peak = x.abs().amax(-1, keepdim=True)
    y = circular_convolve(x, ir, q)
    return y * dry_peak.clamp(min=1e-8) / y.abs().amax(-1, keepdim=True).clamp(min=1e-8)


# ---------------------------------------------------------------------------
# BS.1770 loudness
# ---------------------------------------------------------------------------


def rbj(kind, gain_db, Q, fc, sr):
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * fc / sr
    alpha = math.sin(w0) / (2.0 * Q)
    cw = math.cos(w0)
    if kind == "high_shelf":
        sa = 2 * math.sqrt(A) * alpha
        b = [A * ((A + 1) + (A - 1) * cw + sa), -2 * A * ((A - 1) + (A + 1) * cw),
             A * ((A + 1) + (A - 1) * cw - sa)]
        a = [(A + 1) - (A - 1) * cw + sa, 2 * ((A - 1) - (A + 1) * cw),
             (A + 1) - (A - 1) * cw - sa]
    else:  # high-pass with BS.1770's numerator [1, -2, 1]
        b = [1.0, -2.0, 1.0]
        a = [1 + alpha, -2 * cw, 1 - alpha]
        return np.array(b), np.array(a) / a[0]
    return np.array(b) / a[0], np.array(a) / a[0]


def k_weighting(sr):
    return [rbj(*K_SHELF, sr), rbj(*K_HIGHPASS, sr)]


def fir_meter_kernel(sr, zeros):
    """Each stage's impulse response cut to ``zeros`` taps, composed."""
    from scipy.signal import lfilter

    h = np.ones(1)
    for b, a in k_weighting(sr):
        impulse = np.zeros(zeros)
        impulse[0] = 1.0
        h = np.convolve(h, lfilter(b, a, impulse))
    return h


def weight(x, sr, meter, q=identity):
    """K-weighted ``(B, C, T)`` float64 audio, on the host as numpy.
    ``meter``: ``{"kind": "exact"}`` (the IIR cascade) or ``{"kind": "fir",
    "zeros": n}``."""
    from scipy.signal import lfilter

    data = q(x).detach().cpu().numpy().astype(np.float64)
    if meter["kind"] == "exact":
        for b, a in k_weighting(sr):
            b = q(torch.from_numpy(b)).numpy()
            a = q(torch.from_numpy(a)).numpy()
            data = lfilter(b, a, data, axis=-1)
        return data
    h = q(torch.from_numpy(fir_meter_kernel(sr, meter["zeros"]))).numpy()
    T = data.shape[-1]
    n = 1 << (T + len(h)).bit_length()
    return np.fft.irfft(np.fft.rfft(data, n) * np.fft.rfft(h, n), n)[..., :T]


def gated_loudness(weighted, sr, block=0.4):
    """BS.1770-4 gating of K-weighted ``(B, C, T)`` numpy audio, ``(B,)``."""
    B, C, T = weighted.shape
    gains = np.array([1.0, 1.0, 1.0, 1.41, 1.41])[:C]
    size = int(block * sr)
    stride = int(block * sr * 0.25)
    n_frames = math.ceil((max(T, size) - size) / stride) + 1
    padded = np.pad(weighted, ((0, 0), (0, 0), (0, (n_frames - 1) * stride + size - T)))
    sq = np.concatenate([np.zeros((B, C, 1)), np.cumsum(padded ** 2, axis=-1)], axis=-1)
    starts = np.arange(n_frames) * stride
    z = (sq[..., starts + size] - sq[..., starts]) / (block * sr)  # (B, C, frames)
    with np.errstate(divide="ignore", invalid="ignore"):
        l = -0.691 + 10 * np.log10((gains[None, :, None] * z).sum(1))  # (B, frames)
        above = l > -70.0
        z_abs = (z * above[:, None]).sum(-1) / above.sum(-1)[:, None]
        gamma = -0.691 + 10 * np.log10((gains[None] * z_abs).sum(-1)) - 10
        both = above & (l > gamma[:, None])
        z_avg = np.nan_to_num((z * both[:, None]).sum(-1) / both.sum(-1)[:, None])
        lufs = -0.691 + 10 * np.log10((gains[None] * z_avg).sum(-1))
    return np.maximum(np.nan_to_num(lufs, neginf=MIN_LOUDNESS), MIN_LOUDNESS)


def loudness(x, sr, meter, q=identity):
    """Integrated loudness (LUFS) of ``(B, C, T)`` audio, padded to 0.5 s,
    as a float64 tensor on ``x``'s device."""
    T = x.shape[-1]
    if T < int(0.5 * sr):
        x = F.pad(x, (0, int(0.5 * sr) - T))
    lufs = gated_loudness(weight(x, sr, meter, q), sr)
    return torch.as_tensor(lufs, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# the four transforms
# ---------------------------------------------------------------------------


def mix(x, noise, snr, eq, sr, meter, q=identity):
    T = x.shape[-1]
    noise = F.pad(noise, (0, max(0, T - noise.shape[-1])))[..., :T]
    noise = equalizer(noise, eq, sr, q)
    gain = torch.exp((loudness(x, sr, meter, q) - snr.to(x.dtype) - loudness(noise, sr, meter, q))
                     * GAIN_FACTOR)
    return x + noise * gain[:, None, None]


def normalize(x, db, sr, meter, q=identity):
    return x * torch.exp((db.to(x.dtype) - loudness(x, sr, meter, q)) * GAIN_FACTOR)[:, None, None]


def transforms(x, args, sr, meter, q=identity):
    """``Compose(RoomImpulseResponse, BackgroundNoise, Equalizer,
    VolumeNorm)`` on ``(B, 1, T)`` float64 audio with the drawn ``args``
    (``ir``, ``ir_eq``, ``drr``, ``noise``, ``noise_eq``, ``snr``, ``eq``,
    ``db``: float64 tensors, one row an item)."""
    x = apply_ir(x, args["ir"], args["drr"], args["ir_eq"], sr, q)
    x = mix(x, args["noise"], args["snr"], args["noise_eq"], sr, meter, q)
    x = q(equalizer(x, args["eq"], sr, q))
    return normalize(x, args["db"], sr, meter, q)


# ---------------------------------------------------------------------------
# pitch shift
# ---------------------------------------------------------------------------


def pitch_fraction(n_semitones):
    """The pitch ratio's nearest small fraction (error under 2e-5)."""
    rate = 2.0 ** (-float(n_semitones) / 12.0)
    for cap in (60, 125, 250, 500, 1000, 5000):
        frac = Fraction(rate).limit_denominator(cap)
        if abs(float(frac) - rate) / rate < 2e-5:
            break
    return rate, frac


def resample(x, old, new, zeros=24, rolloff=0.945, q=identity):
    """Windowed-sinc resample of ``(..., T)`` by ``new / old`` (coprime) to
    ``int(T new / old)`` samples: output ``j`` sits at input position
    ``j old / new``; edges repeat the end samples."""
    cutoff = min(old, new) * rolloff
    width = math.ceil(zeros * old / cutoff)
    idx = np.arange(-width, width + old, dtype=np.float64)
    kernels = []
    for p in range(new):
        t = np.clip((-p / new + idx / old) * cutoff, -zeros, zeros) * np.pi
        k = np.sinc(t / np.pi) * np.cos(t / zeros / 2) ** 2
        kernels.append(k / k.sum())
    bank = q(torch.as_tensor(np.stack(kernels)[:, None], dtype=x.dtype, device=x.device))
    T = x.shape[-1]
    xp = F.pad(x.reshape(-1, 1, T), (width, width + old), mode="replicate")
    y = F.conv1d(q(xp), bank, stride=old)  # (rows, new, blocks)
    return y.transpose(1, 2).reshape(xp.shape[0], -1)[:, : int(T * new / old)].reshape(
        x.shape[:-1] + (-1,))


def _window(n, x):
    return torch.hann_window(n, periodic=True, dtype=x.dtype, device=x.device)


def stft(x, n_fft=2048, hop=512, q=identity):
    """``(rows, T)`` -> ``(rows, n_fft / 2 + 1, frames)``, centred with
    reflection, periodic Hann."""
    return torch.stft(q(x), n_fft, hop, window=_window(n_fft, x), center=True,
                      pad_mode="reflect", return_complex=True)


def phase_vocoder(spec, rate):
    """Interpolated magnitudes; each output step's phase is frame 0's plus
    the summed phase differences of the frame pairs before it (a pair with
    a silent frame adds nothing)."""
    T = spec.shape[-1]
    n = int(np.ceil(T / rate))
    steps = np.arange(n) * rate
    i0 = np.minimum(np.floor(steps).astype(np.int64), T - 1)
    i1 = np.minimum(i0 + 1, T - 1)
    frac = torch.as_tensor(steps - i0, dtype=spec.real.dtype, device=spec.device)
    z0, z1 = spec[..., i0], spec[..., i1]
    mag = (1 - frac) * z0.abs() + frac * z1.abs()
    live = (z0.abs() * z1.abs()) > 0
    dphi = torch.where(live, torch.angle(z1 * z0.conj()), 0.0)
    first = spec[..., 0]
    phi0 = torch.where(first.abs() > 0, torch.angle(first), 0.0)
    phase = phi0[..., None] + F.pad(torch.cumsum(dphi, -1)[..., :-1], (1, 0))
    return torch.polar(mag, phase)


def time_stretch(x, rate, n_fft=2048, hop=512, q_analysis=identity, q_synthesis=identity):
    rows_shape, T = x.shape[:-1], x.shape[-1]
    out_len = int(round(T / rate))
    spec = phase_vocoder(stft(x.reshape(-1, T), n_fft, hop, q_analysis), rate)
    spec = torch.complex(q_synthesis(spec.real), q_synthesis(spec.imag))
    y = torch.istft(spec, n_fft, hop, window=_window(n_fft, x), center=True, length=out_len)
    return y.reshape(rows_shape + (out_len,))


def pitch_shift(x, n_semitones, sr, q_analysis=identity, q_synthesis=identity):
    """Pitch shift keeping the length: a resample by the ratio's fraction
    and a time stretch by the ratio, the stretch on the shorter side."""
    T = x.shape[-1]
    rate, frac = pitch_fraction(n_semitones)
    old, new = frac.denominator, frac.numerator
    stretch = dict(q_analysis=q_analysis, q_synthesis=q_synthesis)
    if rate < 1.0:
        y = time_stretch(resample(x, old, new, q=q_analysis), rate, **stretch)
    else:
        y = resample(time_stretch(x, rate, **stretch), old, new, q=q_analysis)
    return F.pad(y, (0, max(0, T - y.shape[-1])))[..., :T]


# ---------------------------------------------------------------------------
# mel spectrogram
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_basis(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """Slaney-scale, area-normalized triangles ``(n_mels, n_fft / 2 + 1)``."""
    fmax = sr / 2 if fmax is None else fmax
    bins = np.linspace(0, sr / 2, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    basis = np.zeros((n_mels, len(bins)))
    for m in range(n_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        up = (bins - lo) / (mid - lo)
        down = (hi - bins) / (hi - mid)
        basis[m] = np.maximum(0, np.minimum(up, down)) * 2.0 / (hi - lo)
    return basis


def mel_spectrogram(x, sr, n_mels=80, n_fft=2048, hop=512, q=identity):
    """``(B, C, T)`` -> ``(B, C, n_mels, frames)``: the mel basis times the
    STFT magnitude."""
    B, C, T = x.shape
    mag = stft(x.reshape(-1, T), n_fft, hop, q).abs()
    basis = q(torch.as_tensor(mel_basis(sr, n_fft, n_mels), dtype=x.dtype, device=x.device))
    return (basis @ q(mag)).reshape(B, C, n_mels, -1)
