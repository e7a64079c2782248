"""AMR-NB-class ACELP speech codec (host-side numpy/scipy, batched).

Counterpart of ``audiotools_tpu/io/amrnb.py``, copied: the codebook
searches are argmins, so any change of arithmetic order would flip
indices, and the two packages code the same input to the same bits.

The original audiotools library applies the ``Amr-nb`` codec preset
through torchaudio's sox/ffmpeg bindings (audiotools effects.py:14-25,
:370-384). This module needs no AMR library nor ffmpeg: it implements
the codec itself: an analysis-by-synthesis ACELP coder with the
AMR-NB 12.2 kbit/s (3GPP TS 26.090 / GSM-EFR) architecture —

  * 8 kHz mono, 20 ms frames (160 samples), four 5 ms subframes;
  * 80 Hz high-pass preprocessing;
  * 10th-order LP analysis per frame, coded as mean-removed AR-predicted
    scalar-quantized LSFs (38 bits) and interpolated per subframe;
  * open-loop + closed-loop adaptive codebook (lags 18..145 at 1/3
    fractional resolution via an 8-tap windowed-sinc interpolator,
    7+2 bits) with a 4-bit pitch gain;
  * 10-pulse algebraic codebook: five interleaved tracks of eight
    positions, two signed pulses per track (8 bits/track);
  * 5-bit predictive log-domain fixed-codebook gain;
  * decoder-side adaptive postfilter Â(z/γn)/Â(z/γd) with spectral-tilt
    compensation and gain normalization (TS 26.090 §6.2.1 structure).

270 bits/frame → 13.5 kbit/s, the 12.2-mode class. The bit allocation
and quantizer tables are this implementation's own; the output is an
AMR-class narrowband telephone codec, NOT bit-exact with
opencore-amrnb. That matches the preset's role in the reference — a
codec *augmentation* imposing narrowband ACELP artifacts — which is
behavioral, not bitstream, parity. Offline validation is property-based
only (tests/test_amrnb.py, tests/test_torch_codecs.py); a behavioural
cross-check against opencore-amrnb (PESQ band comparison) is
VALIDATION.md §4.

Host-side only (codecs are frame-sequential recursions, like the
MP3/GSM/Vorbis paths in ``io/codecs.py``) but **batched**: every
per-frame stage operates on ``(N, ...)`` arrays so a whole batch of
equal-length items is coded in lockstep — the per-item recursions
become vectorized 40-step subframe loops, the codebook searches become
Toeplitz matmuls over all candidate lags at once, and the scalar
``encode``/``decode`` are just batches of one. This is what makes the
preset usable inside a training-loop augmentation chain, where the
reference leans on sox's C codec.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as _ss
from numpy.lib.stride_tricks import sliding_window_view as _swv

SR = 8000
FRAME = 160
SUBFRAME = 40
N_SUBFRAMES = 4
ORDER = 10

PIT_MIN = 18
PIT_MAX = 145  # 7 bits: lags 18..145

# Perceptual weighting W(z) = A(z/G1)/A(z/G2)  (TS 26.090 §5.3, MR122)
GAMMA1 = 0.9
GAMMA2 = 0.6

# Postfilter H(z) = A(z/GN)/A(z/GD) * tilt  (§6.2.1)
POST_GN = 0.55
POST_GD = 0.7
POST_MU = 0.8

# --- LSF quantizer ----------------------------------------------------
# Long-term LSF means: the near-uniform spacing over (0, pi) that the
# classic ITU/3GPP mean tables cluster around.
LSF_MEAN = np.pi * np.arange(1, ORDER + 1) / (ORDER + 1)
LSF_PRED = 0.65  # AR(1) prediction of the mean-removed vector
LSF_BITS = (4, 4, 4, 4, 4, 4, 4, 4, 3, 3)
LSF_RANGE = (0.18, 0.22, 0.26, 0.28, 0.28, 0.28, 0.26, 0.24, 0.22, 0.20)
LSF_MIN_GAP = 0.0125 * np.pi  # ~50 Hz

GP_BITS = 4
GP_MAX = 1.2

# Fixed gain: AR(0.7)-predicted 20*log10(gc), 5-bit residual over
# +/-16 dB (predictive coding covers the wide dynamic range of the
# int16-scaled residual with ~1 dB steps).
GC_BITS = 5
GC_PRED = 0.7
GC_RES_DB = 16.0
GC_DB_MIN, GC_DB_MAX = -40.0, 75.0
GC_DB_INIT = 10.0

TRACKS = 5
TRACK_LEN = SUBFRAME // TRACKS  # 8 positions per track
POS_BITS = 3

FRAC_BITS = 2  # pitch-lag fraction in thirds: 0, 1/3, 2/3
SUBFRAME_BITS = 7 + FRAC_BITS + GP_BITS + TRACKS * (2 * POS_BITS + 2) + GC_BITS
FRAME_BITS = sum(LSF_BITS) + N_SUBFRAMES * SUBFRAME_BITS

_MAGIC = b"ATNB"

# 80 Hz 2nd-order Butterworth high-pass at 8 kHz (precomputed bilinear
# design; the spec's preprocessing filter is the same class).
_HP_B = np.array([0.95654323, -1.91308646, 0.95654323])
_HP_A = np.array([1.0, -1.91119707, 0.91497583])

_EXC_LEN = PIT_MAX + SUBFRAME

# 60 Hz bandwidth-expansion lag window + white-noise floor, applied to
# the autocorrelation before Levinson.
_LAG_WINDOW = np.exp(-0.5 * (2 * np.pi * 60.0 * np.arange(ORDER + 1) / SR) ** 2)
_LP_HAMMING = np.hamming(FRAME + 80)


def _interp_taps(frac):
    """8-tap windowed-sinc interpolator for a ``frac``/3-sample
    fractional delay (the spec's b60 table plays this role at 1/6
    resolution, TS 26.090 §5.6). Tap m weights exc at offset m-4."""
    t = np.arange(-4, 4) + frac / 3.0
    w = np.sinc(t) * (0.54 + 0.46 * np.cos(np.pi * t / 4.5))
    return w / w.sum()


# frac 3 only appears in corrupt bitstreams; the decoder must still
# produce finite output for it (codecs are lossy, not brittle).
_TAPS = {f: _interp_taps(f) for f in (1, 2, 3)}


# ----------------------------------------------------------------------
# Batched filtering primitives — raw-sample memories, newest first
# ----------------------------------------------------------------------


def _syn40(a, x, mem):
    """One-subframe batched synthesis filter y = x / A(z).

    ``a`` (N, ORDER+1) with a[:,0] = 1, ``x`` (N, SUBFRAME), ``mem``
    (N, ORDER) = last outputs newest-first. The per-item-coefficient IIR
    runs as a 40-step recursion over (N,) vectors. Returns (y, new_mem).
    """
    n_items = a.shape[0]
    yext = np.empty((n_items, ORDER + SUBFRAME))
    yext[:, :ORDER] = mem[:, ::-1]
    ar = np.ascontiguousarray(a[:, :0:-1])  # a[ORDER] .. a[1]
    for n in range(SUBFRAME):
        yext[:, ORDER + n] = x[:, n] - np.einsum(
            "nk,nk->n", ar, yext[:, n : n + ORDER]
        )
    y = yext[:, ORDER:]
    return y, y[:, -ORDER:][:, ::-1].copy()


def _zir40(a, mem):
    """Zero-input response of 1/A(z) from ``mem`` (newest first)."""
    return _syn40(a, np.zeros((a.shape[0], SUBFRAME)), mem)[0]


def _fir40(a, x, mem):
    """One-subframe batched FIR y = x * A(z); ``mem`` = last inputs,
    newest first. Vectorized as a sliding-window einsum."""
    xext = np.concatenate([mem[:, ::-1], x], axis=1)  # (N, ORDER+40)
    win = _swv(xext, ORDER + 1, axis=1)  # (N, 40, 11) oldest->newest
    y = np.einsum("nwk,nk->nw", win, a[:, ::-1])
    return y, x[:, -ORDER:][:, ::-1].copy()


def _levinson(r):
    """Batched Levinson-Durbin; r (N, ORDER+1) -> a with a[:,0] = 1.

    Degenerate rows (tiny autocorrelation energy) freeze their
    reflection coefficients at 0, which leaves a = [1, 0, ...] — the
    scalar algorithm's early-return, expressed as a lockstep mask.
    """
    n_items = r.shape[0]
    a = np.zeros((n_items, ORDER + 1))
    a[:, 0] = 1.0
    err = r[:, 0].astype(np.float64).copy()
    frozen = err <= 1e-9
    for i in range(1, ORDER + 1):
        acc = r[:, i].copy()
        if i > 1:
            acc += np.einsum("nj,nj->n", a[:, 1:i], r[:, i - 1 : 0 : -1])
        safe = np.where(np.abs(err) > 1e-30, err, 1.0)
        k = np.clip(-acc / safe, -0.999, 0.999)
        k = np.where(frozen, 0.0, k)
        prev = a[:, 1:i].copy()
        a[:, 1:i] = prev + k[:, None] * prev[:, ::-1]
        a[:, i] = k
        err *= 1.0 - k * k
        frozen |= err <= 1e-12
    return a


def _lp_analysis(ext):
    """Batched autocorrelation LP over the (N, 240) Hamming window."""
    x = ext * _LP_HAMMING
    span = x.shape[1]
    r = np.stack(
        [
            np.einsum("nt,nt->n", x[:, : span - k], x[:, k:])
            for k in range(ORDER + 1)
        ],
        axis=1,
    )
    r[:, 0] = r[:, 0] * 1.0001 + 1e-6  # white-noise correction floor
    r *= _LAG_WINDOW
    return _levinson(r)


_M = ORDER // 2
_GRID = np.linspace(0.0, np.pi, 1024)
_BASIS = 2.0 * np.cos(np.outer(_GRID, np.arange(_M, 0, -1)))  # (grid, m)


def _a_to_lsf(a):
    """Batched LP -> line spectral frequencies.

    Sum/difference polynomial roots located by sign changes on a dense
    cosine grid + linear refinement, all rows at once: the grid
    evaluation is one matmul, and the k-th root of each row is pulled
    out with a cumulative-count argmax. Rows whose two polynomials
    don't yield ORDER sign changes in total are degenerate (silence
    etc.) and fall back to LSF_MEAN, as in the scalar recursion.
    """
    n_items = a.shape[0]
    f1 = np.zeros((n_items, _M + 1))
    f2 = np.zeros((n_items, _M + 1))
    f1[:, 0] = f2[:, 0] = 1.0
    for i in range(_M):
        f1[:, i + 1] = a[:, i + 1] + a[:, ORDER - i] - f1[:, i]
        f2[:, i + 1] = a[:, i + 1] - a[:, ORDER - i] + f2[:, i]

    cands = []
    counts = np.zeros(n_items, dtype=np.int64)
    for f in (f1, f2):
        v = f[:, :_M] @ _BASIS.T + f[:, _M:]  # (N, grid)
        flips = np.signbit(v[:, :-1]) != np.signbit(v[:, 1:])
        cs = np.cumsum(flips, axis=1)
        cnt = cs[:, -1]
        counts += cnt
        for j in range(ORDER):  # a polynomial CAN have >_M grid flips
            sel = flips & (cs == j + 1)
            pos = np.argmax(sel, axis=1)  # first flip #j+1 (0 if none)
            vi = np.take_along_axis(v, pos[:, None], 1)[:, 0]
            vi1 = np.take_along_axis(v, pos[:, None] + 1, 1)[:, 0]
            t = vi / np.where(vi != vi1, vi - vi1, 1.0)
            root = _GRID[pos] + t * (_GRID[pos + 1] - _GRID[pos])
            cands.append(np.where(j < cnt, root, np.inf))
    allroots = np.sort(np.stack(cands, axis=1), axis=1)[:, :ORDER]
    ok = counts == ORDER
    return np.where(ok[:, None], allroots, LSF_MEAN[None, :])


def _lsf_to_a(lsf):
    """Batched LSFs -> LP coefficients: A(z) = (P(z) + Q(z)) / 2 with P
    from the even-indexed and Q from the odd-indexed frequencies; the
    quadratic-factor products run as shift-and-add vector updates."""
    n_items = lsf.shape[0]
    w = np.sort(lsf, axis=1)

    def _poly(ws):
        p = np.zeros((n_items, 2 * ws.shape[1] + 1))
        p[:, 0] = 1.0
        for r in range(ws.shape[1]):
            c = -2.0 * np.cos(ws[:, r])
            newp = p.copy()
            newp[:, 1:] += c[:, None] * p[:, :-1]
            newp[:, 2:] += p[:, :-2]
            p = newp
        return p

    p = _poly(w[:, 0::2])
    q = _poly(w[:, 1::2])
    out = np.zeros((n_items, ORDER + 2))
    out[:, : ORDER + 1] += p
    out[:, 1:] += p  # * (1 + z^-1): restore trivial root z = -1
    out[:, : ORDER + 1] += q
    out[:, 1:] -= q  # * (1 - z^-1): restore trivial root z = +1
    return 0.5 * out[:, : ORDER + 1]


def _stabilize_lsf(lsf):
    """Batched sort + minimum-gap enforcement (sequential sweep kept —
    each gap fix can push the next pair below the gap)."""
    lsf = np.clip(np.sort(lsf, axis=1), 0.005 * np.pi, 0.995 * np.pi)
    for i in range(1, ORDER):
        bad = lsf[:, i] - lsf[:, i - 1] < LSF_MIN_GAP
        mid = 0.5 * (lsf[:, i] + lsf[:, i - 1])
        lsf[:, i - 1] = np.where(bad, mid - 0.5 * LSF_MIN_GAP, lsf[:, i - 1])
        lsf[:, i] = np.where(bad, mid + 0.5 * LSF_MIN_GAP, lsf[:, i])
    return np.clip(lsf, 0.004 * np.pi, 0.996 * np.pi)


def _bw_expand(a, gamma):
    return a * gamma ** np.arange(ORDER + 1)


def _interp_lsf(prev, cur):
    """Per-subframe LSF interpolation (TS 26.090 §5.2.6 pattern)."""
    ws = ((0.75, 0.25), (0.5, 0.5), (0.25, 0.75), (0.0, 1.0))
    return [_stabilize_lsf(wp * prev + wc * cur) for wp, wc in ws]


# ----------------------------------------------------------------------
# Batched adaptive-codebook vectors
# ----------------------------------------------------------------------


def _adaptive_int(exc, lags):
    """Integer-lag past-excitation vectors for several candidate lags.

    ``exc`` (N, E), ``lags`` (N, L) -> (N, L, SUBFRAME). Lags shorter
    than the subframe repeat the most recent ``lag`` samples (standard
    LTP simplification of the spec's extended-excitation rule),
    expressed as a modular index gather.
    """
    e_len = exc.shape[1]
    n = np.arange(SUBFRAME)
    lag = lags[..., None]  # (N, L, 1)
    idx = (e_len - lag) + (n - lag * (n // lag))
    return np.take_along_axis(exc[:, None, :], idx, axis=2)


def _adaptive_frac_multi(exc, lags, fracs):
    """Fractional-delay past-excitation vectors for several candidates.

    ``lags`` (N, L), ``fracs`` a length-L tuple of values in {1, 2, 3}
    -> (N, L, SUBFRAME). Windowed-sinc interpolation over the history;
    for short lags, positions whose taps would cross into the
    not-yet-formed excitation fall back to integer values — the scalar
    recursion's ``v[n] = v[n - lag]`` chain is at most two deep
    (lag >= 18), so it resolves as two where-folds.
    """
    n_items, e_len = exc.shape
    taps = np.stack([_TAPS[f] for f in fracs])  # (L, 8)
    base = e_len - lags  # (N, L)
    rows = np.arange(n_items)[:, None, None]
    n = np.arange(SUBFRAME)[None, None, :]
    lim = np.minimum(SUBFRAME, lags - 3)[..., None]  # valid for n < lim

    # interpolated values at every n (garbage beyond lim, masked below)
    gidx = base[..., None, None] - 4 + n[..., None] + np.arange(8)
    interp = np.einsum(
        "nlwm,lm->nlw",
        exc[rows[..., None], np.clip(gidx, 0, e_len - 1)],
        taps,
    )

    lagc = lags[..., None]  # (N, L, 1)
    n1 = np.where(n >= lagc, n - lagc, n)
    n2 = np.where(n1 >= lagc, n1 - lagc, n1)
    fb_idx = np.clip(base[..., None] + n2 - lagc, 0, e_len - 1)
    fb = exc[rows, fb_idx]
    return np.where(n2 < lim, np.take_along_axis(interp, n2, axis=2), fb)


def _adaptive_frac(exc, lag, frac):
    """Single-candidate form: ``lag`` (N,), scalar ``frac``."""
    return _adaptive_frac_multi(exc, lag[:, None], (frac,))[:, 0]


def _toeplitz_lower(h):
    """(N, 40) impulse response -> (N, 40, 40) lower-triangular Toeplitz
    convolution matrix H[n, i, j] = h[n, i-j]."""
    i = np.arange(SUBFRAME)
    d = i[:, None] - i[None, :]
    return np.where(d >= 0, h[:, np.clip(d, 0, SUBFRAME - 1)], 0.0)


# ----------------------------------------------------------------------
# Batched bit packing
# ----------------------------------------------------------------------


class _BatchBitWriter:
    """Collects fixed-width fields as (N,) value columns; materializes
    one (N, total_bits) bit matrix at the end and packs per row."""

    def __init__(self, n_items):
        self.n_items = n_items
        self.fields = []  # (values (N,), nbits)

    def put(self, values, nbits):
        self.fields.append((np.asarray(values, dtype=np.int64), nbits))

    def tobytes(self):
        cols = []
        for v, nb in self.fields:
            shifts = np.arange(nb - 1, -1, -1)
            cols.append(((v[:, None] >> shifts) & 1).astype(np.uint8))
        if not cols:
            return [b""] * self.n_items
        bits = np.concatenate(cols, axis=1)
        return [np.packbits(bits[i]).tobytes() for i in range(self.n_items)]


class _BatchBitReader:
    """Reads fixed-width fields from N equal-length bitstreams in
    lockstep, returning (N,) value columns."""

    def __init__(self, streams):
        self.bits = np.stack(
            [np.unpackbits(np.frombuffer(s, dtype=np.uint8)) for s in streams]
        ).astype(np.int64)
        self.pos = 0

    def get(self, nbits):
        sl = self.bits[:, self.pos : self.pos + nbits]
        self.pos += nbits
        weights = 1 << np.arange(nbits - 1, -1, -1)
        return sl @ weights


# ----------------------------------------------------------------------
# Batched quantizers (encoder and decoder share the state recursions)
# ----------------------------------------------------------------------

_LSF_LEVELS = np.array([1 << b for b in LSF_BITS])
_LSF_STEP = 2.0 * np.array(LSF_RANGE) / _LSF_LEVELS


def _quant_lsf(lsf, pred_state):
    resid = (lsf - LSF_MEAN) - LSF_PRED * pred_state
    idx = np.clip(
        np.round(resid / _LSF_STEP + _LSF_LEVELS / 2), 0, _LSF_LEVELS - 1
    ).astype(np.int64)
    deq = (idx - _LSF_LEVELS / 2) * _LSF_STEP
    new_state = LSF_PRED * pred_state + deq
    return idx, _stabilize_lsf(LSF_MEAN + new_state), new_state


def _dequant_lsf(idx, pred_state):
    deq = (idx - _LSF_LEVELS / 2) * _LSF_STEP
    new_state = LSF_PRED * pred_state + deq
    return _stabilize_lsf(LSF_MEAN + new_state), new_state


_GP_STEP = GP_MAX / ((1 << GP_BITS) - 1)


def _quant_gp(gp):
    idx = np.clip(np.round(gp / _GP_STEP), 0, (1 << GP_BITS) - 1).astype(
        np.int64
    )
    return idx, idx * _GP_STEP


_GC_STEP = 2.0 * GC_RES_DB / ((1 << GC_BITS) - 1)
_GC_HALF = (1 << GC_BITS) / 2


def _quant_gc(gc, pred_db):
    db = np.clip(
        20.0 * np.log10(np.maximum(gc, 1e-6)), GC_DB_MIN, GC_DB_MAX
    )
    resid = db - GC_PRED * pred_db
    idx = np.clip(
        np.round(resid / _GC_STEP + _GC_HALF), 0, (1 << GC_BITS) - 1
    ).astype(np.int64)
    q_db = np.clip(
        GC_PRED * pred_db + (idx - _GC_HALF) * _GC_STEP, GC_DB_MIN, GC_DB_MAX
    )
    return idx, 10.0 ** (q_db / 20.0), q_db


def _dequant_gc(idx, pred_db):
    q_db = np.clip(
        GC_PRED * pred_db + (idx - _GC_HALF) * _GC_STEP, GC_DB_MIN, GC_DB_MAX
    )
    return 10.0 ** (q_db / 20.0), q_db


# ----------------------------------------------------------------------
# Batched encoder
# ----------------------------------------------------------------------


class _EncoderState:
    def __init__(self, n_items):
        self.n = n_items
        self.prev_speech = np.zeros((n_items, 80))  # LP-window lookback
        self.lsf_pred = np.zeros((n_items, ORDER))
        self.prev_lsf_q = np.tile(LSF_MEAN, (n_items, 1))
        self.gc_pred_db = np.full(n_items, GC_DB_INIT)
        self.exc = np.zeros((n_items, _EXC_LEN))
        # clean weighted-speech path W(z) = A(z/g1)/A(z/g2)
        self.wf_mem = np.zeros((n_items, ORDER))  # FIR A(z/g1) inputs
        self.ws_mem = np.zeros((n_items, ORDER))  # 1/A(z/g2) outputs
        # quantized path 1/Aq -> A(z/g1) -> 1/A(z/g2)
        self.syn_mem = np.zeros((n_items, ORDER))  # 1/Aq outputs
        self.wqf_mem = np.zeros((n_items, ORDER))  # FIR inputs
        self.wqs_mem = np.zeros((n_items, ORDER))  # 1/A(z/g2) outputs
        self.prev_wsp = np.zeros((n_items, PIT_MAX))  # open-loop history


def _weighted_impulse(aq, a1, a2):
    """Batched impulse response of the weighted synthesis cascade
    A(z/g1) / (Aq(z) A(z/g2)), truncated to one subframe."""
    n_items = aq.shape[0]
    imp = np.zeros((n_items, SUBFRAME))
    imp[:, 0] = 1.0
    # conv(imp, a1)[:40] is just a1 zero-padded
    x = np.zeros((n_items, SUBFRAME))
    x[:, : ORDER + 1] = a1
    h, _ = _syn40(aq, x, np.zeros((n_items, ORDER)))
    h, _ = _syn40(a2, h, np.zeros((n_items, ORDER)))
    return h


_OL_OFFSETS = PIT_MAX - np.arange(PIT_MIN, PIT_MAX + 1)  # lag-ascending
_CL_WINDOW = np.arange(-5, 6)  # closed-loop search around open-loop lag


def _encode_frame(speech, st: _EncoderState, bw: _BatchBitWriter):
    """One 20 ms frame for all N items in lockstep. speech (N, 160)."""
    rows = np.arange(st.n)

    # LP analysis over [previous 80 | current 160]
    a = _lp_analysis(np.concatenate([st.prev_speech, speech], axis=1))
    lsf = _stabilize_lsf(_a_to_lsf(a))
    idx, lsf_q, st.lsf_pred = _quant_lsf(lsf, st.lsf_pred)
    for i in range(ORDER):
        bw.put(idx[:, i], LSF_BITS[i])
    lsf_sub = _interp_lsf(st.prev_lsf_q, lsf_q)
    st.prev_lsf_q = lsf_q
    st.prev_speech = speech[:, -80:].copy()

    aq_subs = [_lsf_to_a(l) for l in lsf_sub]
    a1_subs = [_bw_expand(aq, GAMMA1) for aq in aq_subs]
    a2_subs = [_bw_expand(aq, GAMMA2) for aq in aq_subs]

    # weighted speech for the full frame (commits the clean-path mems)
    wsp = np.empty((st.n, FRAME))
    for s in range(N_SUBFRAMES):
        seg = speech[:, s * SUBFRAME : (s + 1) * SUBFRAME]
        r, st.wf_mem = _fir40(a1_subs[s], seg, st.wf_mem)
        w, st.ws_mem = _syn40(a2_subs[s], r, st.ws_mem)
        wsp[:, s * SUBFRAME : (s + 1) * SUBFRAME] = w

    # open-loop pitch: normalized correlation of the frame's weighted
    # speech against its own past, all 128 lags at once
    buf = np.concatenate([st.prev_wsp, wsp], axis=1)
    cur = buf[:, PIT_MAX:]
    past = _swv(buf, FRAME, axis=1)[:, _OL_OFFSETS]  # (N, n_lags, 160)
    num = np.einsum("nt,nlt->nl", cur, past)
    den = np.sqrt(np.einsum("nlt,nlt->nl", past, past) + 1e-9)
    best_ol = PIT_MIN + np.argmax(num / den, axis=1)  # first max wins
    st.prev_wsp = buf[:, -PIT_MAX:].copy()

    for s in range(N_SUBFRAMES):
        aq, a1, a2 = aq_subs[s], a1_subs[s], a2_subs[s]
        h = _weighted_impulse(aq, a1, a2)
        toep = _toeplitz_lower(h)
        w_seg = wsp[:, s * SUBFRAME : (s + 1) * SUBFRAME]

        # target = weighted speech minus the quantized path's zero-input
        # response (memories probed, not committed)
        z = _zir40(aq, st.syn_mem)
        z, _ = _fir40(a1, z, st.wqf_mem)
        z, _ = _syn40(a2, z, st.wqs_mem)
        x = w_seg - z

        def _scores(v):
            """v (N, L, 40) -> (score, y1) per candidate."""
            y1 = np.einsum("nlj,nij->nli", v, toep)
            num = np.einsum("nw,nlw->nl", x, y1)
            den = np.einsum("nlw,nlw->nl", y1, y1) + 1e-9
            return np.where(num > 0, num * num / den, 0.0), y1

        # closed-loop adaptive codebook around the open-loop lag:
        # integer stage over the +/-5 window, then 1/3-fraction
        # refinement around the integer winner — every candidate for
        # every item scored in one Toeplitz matmul
        cand = best_ol[:, None] + _CL_WINDOW
        valid = (cand >= PIT_MIN) & (cand <= PIT_MAX)
        cand_c = np.clip(cand, PIT_MIN, PIT_MAX)
        v_int = _adaptive_int(st.exc, cand_c)
        s_int, y1_int = _scores(v_int)
        s_int = np.where(valid, s_int, -np.inf)
        pick = np.argmax(s_int, axis=1)
        t0 = cand_c[rows, pick]

        dlags = np.array([-1, -1, 0, 0])
        fracs = (1, 2, 1, 2)  # candidate order = the scalar sweep order
        lag_f = t0[:, None] + dlags
        ok = (lag_f >= PIT_MIN) & (lag_f <= PIT_MAX)
        lag_fc = np.clip(lag_f, PIT_MIN, PIT_MAX)
        v_frac = _adaptive_frac_multi(st.exc, lag_fc, fracs)
        s_frac, y1_frac = _scores(v_frac)
        s_frac = np.where(ok, s_frac, -np.inf)

        stack_s = np.concatenate([s_int[rows, pick, None], s_frac], axis=1)
        best = np.argmax(stack_s, axis=1)  # first max = scalar's strict >
        v_all = np.concatenate([v_int[rows, pick][:, None], v_frac], axis=1)
        y1_all = np.concatenate([y1_int[rows, pick][:, None], y1_frac], axis=1)
        lag_all = np.concatenate([t0[:, None], lag_fc], axis=1)
        frac_all = np.concatenate(
            [np.zeros((st.n, 1), dtype=np.int64), np.tile(fracs, (st.n, 1))],
            axis=1,
        )
        v_adapt = v_all[rows, best]
        y1 = y1_all[rows, best]
        lag = lag_all[rows, best]
        frac = frac_all[rows, best]

        gp = np.clip(
            np.einsum("nw,nw->n", x, y1)
            / (np.einsum("nw,nw->n", y1, y1) + 1e-9),
            0.0,
            GP_MAX,
        )
        gp_idx, gp_q = _quant_gp(gp)
        bw.put(lag - PIT_MIN, 7)
        bw.put(frac, FRAC_BITS)
        bw.put(gp_idx, GP_BITS)

        # algebraic codebook on the updated target: two signed pulses
        # per interleaved track, chosen greedily on the backward-filtered
        # target d(n) = <x2[n:], h[:N-n]> (the standard simplification
        # of the spec's nested-loop search)
        x2 = x - gp_q[:, None] * y1
        d = np.einsum("nj,nji->ni", x2, toep)
        c = np.zeros((st.n, SUBFRAME))
        pulse_pos = []
        pulse_sign = []
        for t in range(TRACKS):
            track = np.arange(t, SUBFRAME, TRACKS)
            order = np.argsort(-np.abs(d[:, track]), axis=1)[:, :2]
            pos = track[order]  # (N, 2)
            sign = np.where(d[rows[:, None], pos] >= 0, 1.0, -1.0)
            np.add.at(c, (rows[:, None], pos), sign)
            pulse_pos.append(pos)
            pulse_sign.append(sign)

        y2 = np.einsum("nj,nij->ni", c, toep)
        gc = np.maximum(
            np.einsum("nw,nw->n", x2, y2)
            / (np.einsum("nw,nw->n", y2, y2) + 1e-9),
            0.0,
        )
        gc_idx, gc_q, st.gc_pred_db = _quant_gc(gc, st.gc_pred_db)
        for t in range(TRACKS):
            for p in range(2):
                bw.put(pulse_pos[t][:, p] // TRACKS, POS_BITS)
                bw.put((pulse_sign[t][:, p] < 0).astype(np.int64), 1)
        bw.put(gc_idx, GC_BITS)

        # commit state with the quantized excitation
        u = gp_q[:, None] * v_adapt + gc_q[:, None] * c
        st.exc = np.concatenate([st.exc[:, SUBFRAME:], u], axis=1)
        syn, st.syn_mem = _syn40(aq, u, st.syn_mem)
        r, st.wqf_mem = _fir40(a1, syn, st.wqf_mem)
        _, st.wqs_mem = _syn40(a2, r, st.wqs_mem)


# ----------------------------------------------------------------------
# Batched decoder
# ----------------------------------------------------------------------


class _DecoderState:
    def __init__(self, n_items):
        self.n = n_items
        self.lsf_pred = np.zeros((n_items, ORDER))
        self.prev_lsf_q = np.tile(LSF_MEAN, (n_items, 1))
        self.gc_pred_db = np.full(n_items, GC_DB_INIT)
        self.exc = np.zeros((n_items, _EXC_LEN))
        self.syn_mem = np.zeros((n_items, ORDER))
        self.pf_fir_mem = np.zeros((n_items, ORDER))  # A(z/gn) inputs
        self.pf_syn_mem = np.zeros((n_items, ORDER))  # 1/A(z/gd) outputs
        self.tilt_mem = np.zeros(n_items)
        self.agc_gain = np.ones(n_items)


_AGC_DECAY = 0.99 ** np.arange(1, SUBFRAME + 1)


def _decode_frame(br: _BatchBitReader, st: _DecoderState):
    rows = np.arange(st.n)
    idx = np.stack([br.get(LSF_BITS[i]) for i in range(ORDER)], axis=1)
    lsf_q, st.lsf_pred = _dequant_lsf(idx, st.lsf_pred)
    lsf_sub = _interp_lsf(st.prev_lsf_q, lsf_q)
    st.prev_lsf_q = lsf_q

    out = np.empty((st.n, FRAME))
    for s in range(N_SUBFRAMES):
        aq = _lsf_to_a(lsf_sub[s])
        lag = br.get(7) + PIT_MIN
        frac = br.get(FRAC_BITS)
        gp_q = br.get(GP_BITS) * _GP_STEP
        c = np.zeros((st.n, SUBFRAME))
        for t in range(TRACKS):
            for _ in range(2):
                p = br.get(POS_BITS) * TRACKS + t
                sign = np.where(br.get(1) != 0, -1.0, 1.0)
                np.add.at(c, (rows, p), sign)
        gc_q, st.gc_pred_db = _dequant_gc(br.get(GC_BITS), st.gc_pred_db)

        # adaptive vector: rows mix integer and fractional lags, so
        # compute the integer gather for everyone and overlay each
        # fraction actually present
        v = _adaptive_int(st.exc, lag[:, None])[:, 0]
        for f in (1, 2, 3):
            sel = frac == f
            if np.any(sel):
                vf = _adaptive_frac(st.exc, lag, f)
                v = np.where(sel[:, None], vf, v)

        u = gp_q[:, None] * v + gc_q[:, None] * c
        st.exc = np.concatenate([st.exc[:, SUBFRAME:], u], axis=1)
        syn, st.syn_mem = _syn40(aq, u, st.syn_mem)

        # adaptive postfilter: A(z/gn)/A(z/gd), tilt, AGC
        r, st.pf_fir_mem = _fir40(_bw_expand(aq, POST_GN), syn, st.pf_fir_mem)
        pf, st.pf_syn_mem = _syn40(_bw_expand(aq, POST_GD), r, st.pf_syn_mem)
        r0 = np.einsum("nw,nw->n", pf, pf) + 1e-9
        k1 = np.einsum("nw,nw->n", pf[:, 1:], pf[:, :-1]) / r0
        mu = POST_MU * np.maximum(k1, 0.0)
        shifted = np.concatenate([st.tilt_mem[:, None], pf[:, :-1]], axis=1)
        tilted = pf - mu[:, None] * shifted
        st.tilt_mem = pf[:, -1].copy()
        g_target = np.sqrt(
            np.einsum("nw,nw->n", syn, syn)
            / (np.einsum("nw,nw->n", tilted, tilted) + 1e-9)
        )
        g = _AGC_DECAY * (st.agc_gain - g_target)[:, None] + g_target[:, None]
        st.agc_gain = g[:, -1].copy()
        out[:, s * SUBFRAME : (s + 1) * SUBFRAME] = tilted * g
    return out


# ----------------------------------------------------------------------
# Public API
# ----------------------------------------------------------------------


def bitrate() -> float:
    """Coded bitrate in bits/s (13.5 kbit/s — the 12.2-mode class)."""
    return FRAME_BITS / (FRAME / SR)


def encode_batch(audio: np.ndarray) -> list:
    """Encode a batch of equal-length mono float 8 kHz items.

    ``audio`` (N, T) in [-1, 1] -> list of N independent bitstreams,
    each ``b"ATNB"`` + uint32 sample count + packed frames — the same
    layout ``encode`` writes, produced N-at-a-time in lockstep.
    """
    x = np.asarray(audio, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError(f"encode_batch expects (N, T), got {x.shape}")
    n_items, n = x.shape
    n_frames = -(-n // FRAME) if n else 0
    x = np.pad(x, ((0, 0), (0, n_frames * FRAME - n))) * 32768.0
    header = _MAGIC + np.uint32(n).tobytes()
    if n_frames == 0:
        return [header] * n_items

    # 80 Hz high-pass preprocessing over the whole padded signal (the
    # per-frame scalar filtering with carried state is the same thing)
    x = _ss.lfilter(_HP_B, _HP_A, x, axis=1, zi=np.zeros((n_items, 2)))[0]

    st = _EncoderState(n_items)
    bw = _BatchBitWriter(n_items)
    for f in range(n_frames):
        _encode_frame(x[:, f * FRAME : (f + 1) * FRAME], st, bw)
    return [header + body for body in bw.tobytes()]


def decode_batch(streams) -> np.ndarray:
    """Decode N same-length-audio ``encode`` bitstreams to (N, T).

    Raises ``ValueError`` on a bad magic, a truncated payload, a header
    sample count inconsistent with the payload size, or mismatched
    lengths within the batch (each stream still fails cleanly instead
    of crashing mid-frame or over-allocating).
    """
    streams = list(streams)
    if not streams:
        return np.zeros((0, 0), dtype=np.float32)
    counts = []
    for data in streams:
        if data[:4] != _MAGIC:
            raise ValueError("not an ATNB bitstream")
        if len(data) < 8:
            raise ValueError("truncated ATNB header")
        n = int(np.frombuffer(data[4:8], dtype=np.uint32)[0])
        n_frames = -(-n // FRAME) if n else 0
        need = (n_frames * FRAME_BITS + 7) // 8
        if len(data) - 8 < need:
            raise ValueError(
                f"truncated ATNB payload: header promises {n_frames} "
                f"frames ({need} bytes), got {len(data) - 8}"
            )
        counts.append(n)
    if len(set(counts)) > 1:
        raise ValueError(
            f"decode_batch needs equal-length items, got lengths {counts}"
        )
    n = counts[0]
    n_frames = -(-n // FRAME) if n else 0
    n_items = len(streams)
    if n_frames == 0:
        return np.zeros((n_items, 0), dtype=np.float32)

    need = (n_frames * FRAME_BITS + 7) // 8
    br = _BatchBitReader([d[8 : 8 + need] for d in streams])
    st = _DecoderState(n_items)
    out = np.empty((n_items, n_frames * FRAME))
    for f in range(n_frames):
        out[:, f * FRAME : (f + 1) * FRAME] = _decode_frame(br, st)
    # int16-range saturation, as in any fixed-point decoder
    return (np.clip(out[:, :n], -32768.0, 32767.0) / 32768.0).astype(
        np.float32
    )


def encode(audio: np.ndarray) -> bytes:
    """Encode mono float 8 kHz audio in [-1, 1] to an ACELP bitstream.

    Layout: ``b"ATNB"`` + uint32 sample count + packed frames. A batch
    of one through the lockstep coder.
    """
    return encode_batch(np.asarray(audio).reshape(1, -1))[0]


def decode(data: bytes) -> np.ndarray:
    """Decode an ``encode`` bitstream back to mono float32 8 kHz audio."""
    return decode_batch([data])[0]


def amrnb_available() -> bool:
    """The codec is self-contained numpy/scipy — always available."""
    return True


def amrnb_roundtrip(data: np.ndarray) -> np.ndarray:
    """Encode+decode ``(C, T)`` float32 8 kHz audio through the ACELP
    codec; channels are coded independently (the codec is mono) but in
    one lockstep batch. Mirrors ``codecs.gsm_roundtrip`` — the caller
    resamples to/from 8 kHz. Used by ``apply_codec(preset="Amr-nb")``
    (reference effects.py:14-25, torchaudio path :370-384)."""
    data = np.asarray(data, dtype=np.float32)
    squeeze = data.ndim == 1
    if squeeze:
        data = data[None, :]
    out = decode_batch(encode_batch(data))
    if squeeze:
        out = out[0]
    return out.astype(np.float32)


def amrnb_roundtrip_batch(data: np.ndarray) -> np.ndarray:
    """Batch form for ``apply_codec``: (B, C, T) -> (B, C, T), every
    channel of every item coded in one lockstep pass."""
    data = np.asarray(data, dtype=np.float32)
    b, ch, t = data.shape
    flat = data.reshape(b * ch, t)
    return decode_batch(encode_batch(flat)).reshape(b, ch, t)
