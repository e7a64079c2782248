"""Native perceptual speech-quality estimator with the ITU-T P.862 (PESQ)
architecture: the float64 host oracle of the port's device PESQ
(``ops/pesq.py``), and the tables that program is built from.

Counterpart of ``audiotools_tpu/metrics/_pesq.py``, kept as the port's own
copy (the port imports nothing of the JAX package) and pinned to it by the
parity tests. The pipeline:

    level alignment -> receive filtering -> envelope-based time alignment
    -> Hann-framed power spectra -> Bark-band grouping -> partial frequency
    compensation -> frame gain compensation -> Zwicker loudness -> masked
    disturbance + asymmetric disturbance -> L6/L2 two-stage aggregation
    -> raw score -> MOS-LQO logistic map (P.862.1 for nb, P.862.2 for wb).

It is NOT the bit-exact ITU implementation: the band tables are derived
from the Bark warping formula, the absolute-threshold curve comes from
Terhardt's closed form, and the disturbance scale factors were
re-calibrated on codec/noise ladders so the output occupies the familiar
MOS-LQO range (identical -> ~4.5+, heavy degradation -> ~1). For certified
P.862 numbers install the ``pesq`` package
(``metrics.quality.pesq(..., backend="itu")``).

Everything here is host-side float64 numpy: a batch loops per item.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pesq_native"]

# --------------------------------------------------------------------------
# mode constants
# --------------------------------------------------------------------------

_TARGET_POWER = 1e7  # active-speech calibration power (P.862 level alignment)
# internal-unit power of a 0 dB SPL tone, fixing 10^7 units ~= 79 dB SPL
_SPL0 = _TARGET_POWER / 10 ** (79.0 / 10.0)


def _bark(f_hz):
    """P.862-style auditory warping (Zwicker scale, asinh form)."""
    return 7.0 * np.arcsinh(np.asarray(f_hz, dtype=np.float64) / 650.0)


def _bark_inv(z):
    return 650.0 * np.sinh(np.asarray(z, dtype=np.float64) / 7.0)


class _Mode:
    def __init__(self, fs, frame, n_bands, f_lo, f_hi):
        self.fs = fs
        self.frame = frame            # 32 ms Hann frame, 50% overlap
        self.hop = frame // 2
        self.n_bands = n_bands
        # uniform grid on the Bark axis between the band-pass edges,
        # mirroring the ITU tables' coverage (42 bands to 4 kHz at 8 kHz,
        # 49 bands to 8 kHz at 16 kHz)
        edges_bark = np.linspace(_bark(f_lo), _bark(f_hi), n_bands + 1)
        self.band_edges_hz = _bark_inv(edges_bark)
        self.band_centers_hz = _bark_inv(0.5 * (edges_bark[:-1] + edges_bark[1:]))
        self.band_widths_bark = np.diff(edges_bark)
        # absolute hearing threshold per band (Terhardt 1979 closed form),
        # converted from dB SPL into internal power units
        fk = self.band_centers_hz / 1000.0
        tq_db = (
            3.64 * fk ** -0.8
            - 6.5 * np.exp(-0.6 * (fk - 3.3) ** 2)
            + 1e-3 * fk ** 4
        )
        self.abs_thresh = _SPL0 * 10.0 ** (tq_db / 10.0)
        # per-bin -> band membership for the rfft grid
        freqs = np.fft.rfftfreq(frame, d=1.0 / fs)
        self.band_of_bin = np.digitize(freqs, self.band_edges_hz) - 1
        self.valid_bin = (self.band_of_bin >= 0) & (self.band_of_bin < n_bands)
        counts = np.bincount(
            self.band_of_bin[self.valid_bin], minlength=n_bands
        ).astype(np.float64)
        self.band_bin_counts = np.maximum(counts, 1.0)


_MODES = {
    # narrow-band: 8 kHz, 256-sample frames, telephone band
    "nb": _Mode(fs=8000, frame=256, n_bands=42, f_lo=100.0, f_hi=3800.0),
    # wide-band (P.862.2): 16 kHz, 512-sample frames, 100 Hz - 8 kHz
    "wb": _Mode(fs=16000, frame=512, n_bands=49, f_lo=100.0, f_hi=7600.0),
}

# disturbance scale factors; the symmetric weight is P.862's 0.1, the
# asymmetric weight and the loudness scale were re-calibrated on AWGN /
# clipping / quantization / band-limit ladders (see module docstring)
_D_SYM_SCALE = 0.1
_D_ASYM_SCALE = 0.06
_ZWICKER_P = 0.23
_LOUDNESS_SCALE = 0.1
# subtractive-loss weight: the sym/asym disturbances respond weakly to
# outright signal loss (their scales are calibrated on additive ladders
# and the Zwicker compression flattens a band-kill), so the fraction of
# audible reference loudness with no degraded counterpart is scored
# directly — 1.0 for a silent degraded signal, ~0 for additive noise
_D_LOSS_SCALE = 3.5


# --------------------------------------------------------------------------
# stage 1: level alignment + receive filtering
# --------------------------------------------------------------------------


def _fft_filter(x, fs, response_fn):
    """Zero-phase filtering via one full-length rfft (host float64)."""
    n = int(2 ** np.ceil(np.log2(max(len(x), 2))))
    X = np.fft.rfft(x, n=n)
    gain = response_fn(np.fft.rfftfreq(n, d=1.0 / fs))
    return np.fft.irfft(X * gain, n=n)[: len(x)]


def _level_align(x, fs):
    """Scale so the power above 300 Hz equals the calibration target
    (P.862 'fix power level': alignment uses supra-300 Hz band power so
    DC/hum offsets cannot bias the gain)."""
    band = _fft_filter(x, fs, lambda f: ((f > 300.0) & (f < 0.475 * fs)).astype(float))
    p = np.mean(band**2) + 1e-30
    return x * np.sqrt(_TARGET_POWER / p)


def _receive_filter(x, fs, mode):
    """nb: IRS-receive-like telephone-band weighting; wb: 100 Hz high-pass
    (P.862.2 replaces the IRS shape with a flat band-pass)."""
    if mode == "wb":
        return _fft_filter(
            x, fs, lambda f: 1.0 / (1.0 + (100.0 / np.maximum(f, 1e-9)) ** 8)
        )

    # piecewise-log-linear approximation of the IRS receive characteristic:
    # steep roll-off below 300 Hz, gentle presence rise to ~3 kHz, sharp
    # cut above 3.4 kHz
    pts_hz = np.array([50.0, 135.0, 250.0, 300.0, 500.0, 1000.0, 2000.0, 3000.0, 3400.0, 4000.0])
    pts_db = np.array([-40.0, -20.0, -6.0, -2.0, 0.0, 0.0, 2.0, 4.0, -2.0, -40.0])

    def response(f):
        lf = np.log10(np.maximum(f, 1.0))
        g = np.interp(lf, np.log10(pts_hz), pts_db, left=-60.0, right=-60.0)
        return 10.0 ** (g / 20.0)

    return _fft_filter(x, fs, response)


# --------------------------------------------------------------------------
# stage 2: time alignment
# --------------------------------------------------------------------------


def _frame_log_energy(x, win):
    n = max(len(x) // win, 1)
    e = np.add.reduceat(x[: n * win] ** 2, np.arange(0, n * win, win))
    return np.log10(e + 1e4)


def _estimate_delay(ref, deg, fs):
    """Two-stage delay estimate (P.862 crude+fine alignment, collapsed to
    one global delay): 4 ms log-energy-envelope cross-correlation for the
    coarse lag, then a sample-level cross-correlation of the rectified
    signals in a +-2 ms window around it."""
    win = max(int(0.004 * fs), 1)
    er = _frame_log_energy(ref, win)
    ed = _frame_log_energy(deg, win)
    er = er - er.mean()
    ed = ed - ed.mean()
    n = min(len(er), len(ed))
    if n < 8:
        return 0
    corr = np.correlate(ed[:n], er[:n], mode="full")
    # ties (a flat correlation — e.g. a silent or constant degraded
    # signal) resolve to the lag nearest zero, not np.argmax's extreme
    # negative pick which would trim away almost the whole signal
    lags = np.arange(-(n - 1), n)
    tol = 1e-9 * max(float(np.abs(corr).max()), 1.0)
    tied = np.flatnonzero(corr >= corr.max() - tol)
    coarse = int(lags[tied[np.argmin(np.abs(lags[tied]))]]) * win

    span = int(0.002 * fs)
    best, best_v = coarse, -np.inf
    r = np.abs(ref)
    d = np.abs(deg)
    # visit lags nearest the coarse estimate first so exact ties keep it
    fine_lags = sorted(
        range(coarse - span, coarse + span + 1, max(span // 16, 1)),
        key=lambda l: (abs(l - coarse), l),
    )
    for lag in fine_lags:
        if lag >= 0:
            a, b = r[: len(d) - lag if lag else None], d[lag:]
        else:
            a, b = r[-lag:], d[: len(r) + lag]
        m = min(len(a), len(b))
        if m <= 0:
            continue
        v = float(np.dot(a[:m], b[:m])) / (m + 1e-9)
        if v > best_v:
            best_v, best = v, lag
    return best


def _apply_delay(ref, deg, delay):
    """Positive delay: degraded lags the reference."""
    if delay > 0:
        deg = deg[delay:]
    elif delay < 0:
        ref = ref[-delay:]
    n = min(len(ref), len(deg))
    return ref[:n], deg[:n]


# --------------------------------------------------------------------------
# stage 3: perceptual model
# --------------------------------------------------------------------------


def _bark_spectrogram(x, mode):
    """(frames, n_bands) pitch-power densities: Hann-framed power spectra
    summed per Bark band and normalized by band occupancy."""
    frame, hop = mode.frame, mode.hop
    if len(x) < frame:
        x = np.pad(x, (0, frame - len(x)))
    n = 1 + (len(x) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    w = np.hanning(frame)
    spec = np.abs(np.fft.rfft(x[idx] * w, axis=1)) ** 2
    # compensate the window's power loss so band powers stay on the
    # calibrated absolute scale
    spec /= np.mean(w**2)
    spec = spec[:, mode.valid_bin] / frame
    bands = np.zeros((n, mode.n_bands))
    np.add.at(bands.T, mode.band_of_bin[mode.valid_bin], spec.T)
    return bands / mode.band_bin_counts


def _zwicker_loudness(bands, mode):
    """Modified Zwicker loudness (P.862 eq. for Sone density)."""
    p0 = mode.abs_thresh[None, :]
    ratio = np.maximum(bands / p0, 0.0)
    loud = (
        _LOUDNESS_SCALE
        * (p0 / (0.5 * _SPL0)) ** _ZWICKER_P
        * ((0.5 + 0.5 * ratio) ** _ZWICKER_P - 1.0)
    )
    return np.maximum(loud, 0.0)


def _lp(x, w, p, axis=-1):
    return (np.sum(w * np.abs(x) ** p, axis=axis) / np.sum(w)) ** (1.0 / p)


def _pesq_core(ref, deg, mode):
    B_ref = _bark_spectrogram(ref, mode)
    B_deg = _bark_spectrogram(deg, mode)
    n = min(len(B_ref), len(B_deg))
    B_ref, B_deg = B_ref[:n], B_deg[:n]

    frame_pow = B_ref.sum(axis=1)
    active = frame_pow > 1e-2 * _TARGET_POWER * 1e-4
    if not np.any(active):
        active = np.ones(n, dtype=bool)

    # partial frequency compensation: the reference spectrum absorbs the
    # time-averaged linear response of the system under test (clipped to
    # +-20 dB so genuine band-kill still registers as distortion)
    mean_ref = B_ref[active].mean(axis=0)
    mean_deg = B_deg[active].mean(axis=0)
    comp = (mean_deg + 1e3) / (mean_ref + 1e3)
    comp = np.clip(comp, 10.0**-2.0, 10.0**2.0)
    B_ref_eq = B_ref * comp[None, :]

    # short-term gain compensation: the degraded frame absorbs slowly
    # varying gain (first-order smoothed, clipped)
    g = (B_ref_eq.sum(axis=1) + 5e3) / (B_deg.sum(axis=1) + 5e3)
    g = np.clip(g, 3e-4, 5.0)
    g_s = np.empty_like(g)
    acc = g[0]
    for i in range(len(g)):
        acc = 0.8 * acc + 0.2 * g[i]
        g_s[i] = acc
    B_deg_eq = B_deg * g_s[:, None]

    L_ref = _zwicker_loudness(B_ref_eq, mode)
    L_deg = _zwicker_loudness(B_deg_eq, mode)

    # masked disturbance: each cell's difference is shrunk by a deadzone
    # of a quarter of the smaller loudness (P.862 masking step)
    diff = L_deg - L_ref
    dead = 0.25 * np.minimum(L_deg, L_ref)
    disturb = np.sign(diff) * np.maximum(np.abs(diff) - dead, 0.0)

    # asymmetry factor: additive (deg > ref) distortion is weighted up,
    # with the P.862 gate (h < 3 -> 0) and cap (12)
    h = ((B_deg_eq + 50.0) / (B_ref_eq + 50.0)) ** 1.2
    h[h < 3.0] = 0.0
    h = np.minimum(h, 12.0)

    wb = mode.band_widths_bark[None, :]
    d_frame = _lp(disturb, wb, p=2.0, axis=1)
    da_frame = np.sum(np.abs(disturb * h) * wb, axis=1) / np.sum(wb)

    # subtractive-loss channel (see _D_LOSS_SCALE): per active frame, the
    # fraction of reference loudness that simply went missing; cubed so
    # partial spectral tilts barely register but a band-kill saturates
    loss_num = np.sum(wb * np.maximum(L_ref - L_deg, 0.0), axis=1)
    loss_den = np.sum(wb * L_ref, axis=1) + 1e-12
    d_loss = float(np.mean((loss_num / loss_den)[active] ** 3))

    # emphasize audible frames: weight by the frame's reference energy
    # with a soft floor so silence neither dominates nor vanishes
    wf = ((frame_pow + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / wf, 45.0)
    da_frame = np.minimum(da_frame / wf, 45.0)

    # two-stage aggregation: L6 over ~320 ms sub-intervals, L2 over time
    def aggregate(d):
        chunk = 20
        pad = (-len(d)) % chunk
        d = np.pad(d, (0, pad))
        d6 = (np.mean(d.reshape(-1, chunk) ** 6.0, axis=1)) ** (1.0 / 6.0)
        return float(np.sqrt(np.mean(d6**2.0)))

    return aggregate(d_frame), aggregate(da_frame), d_loss


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------


def _mos_map(raw, mode):
    if mode == "wb":
        # logistic map re-derived to anchor the published P.862.2 output
        # range (identical -> 4.64, floor ~1.1)
        return 0.999 + 4.999 / (1.0 + np.exp(-1.338 * raw + 5.035))
    # P.862.1 mapping
    return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))


def pesq_native(ref: np.ndarray, deg: np.ndarray, fs: int, mode: str = "wb") -> float:
    """P.862-architecture MOS-LQO estimate for one utterance pair.

    ``ref``/``deg`` are 1-D float arrays already at the mode's sample rate
    (8 kHz for ``nb``, 16 kHz for ``wb`` — same contract as the ``pesq``
    C extension).
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be 'nb' or 'wb', got {mode!r}")
    m = _MODES[mode]
    if fs != m.fs:
        raise ValueError(f"mode {mode!r} requires fs={m.fs}, got {fs}")
    ref = np.asarray(ref, dtype=np.float64).reshape(-1)
    deg = np.asarray(deg, dtype=np.float64).reshape(-1)
    if min(len(ref), len(deg)) < 4 * m.frame:
        raise ValueError("signals too short for PESQ (need >= 4 frames)")

    ref = _level_align(ref, m.fs)
    deg = _level_align(deg, m.fs)
    ref = _receive_filter(ref, m.fs, mode)
    deg = _receive_filter(deg, m.fs, mode)
    delay = _estimate_delay(ref, deg, m.fs)
    ref, deg = _apply_delay(ref, deg, delay)

    d_sym, d_asym, d_loss = _pesq_core(ref, deg, m)
    raw = (
        4.5
        - _D_SYM_SCALE * d_sym
        - _D_ASYM_SCALE * d_asym
        - _D_LOSS_SCALE * d_loss
    )
    return float(_mos_map(raw, mode))
