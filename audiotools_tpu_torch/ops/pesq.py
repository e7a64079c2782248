"""Batched P.862-architecture PESQ on ``(B, T)`` tensors.

Counterpart of ``audiotools_tpu/ops/pesq.py``: level alignment, receive
filtering, two-stage delay estimation, Bark pitch-power densities, partial
frequency and gain compensation, Zwicker loudness, masked and asymmetric
disturbance, L6/L2 aggregation and the MOS-LQO map, over the batch on the
device of its inputs. The tables come from the host implementation
(``metrics/_pesq.py``), and the alignment keeps a static shape instead of
trimming:

- the degraded signal is rolled by each item's estimated delay and a mask
  of valid samples replaces the host's trim;
- frames are computed on the full grid, and each item's fully valid frames
  (a contiguous run) are rolled to the front, so the gain smoother's
  warm-up, the active-frame statistics and the 320 ms L6 chunks reproduce
  the host's trimmed-from-start semantics;
- the first-order gain smoother ``g_s[i] = 0.8 g_s[i-1] + 0.2 g[i]`` runs as
  a causal FIR of ``_SMOOTH_TAPS`` taps in float64 plus the exact
  initial-state term (see :func:`_smooth_gain`).

The delay searches score their candidate lags in float64 and keep the
host's tie-break rules exactly; the spectral products run in full fp32
(``strict_fp32``). For pairs whose delay is zero or positive the result
matches the host to float32 precision; for a negative delay the framing
phase can differ from the host's by up to one hop (the host re-frames from
the trim point, the static grid cannot). Narrowband expects 8 kHz input and
wideband 16 kHz.
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ._fp32 import strict_fp32
from .fft import _frame
from .stoi import _common_length

__all__ = ["pesq_batch"]

_TARGET_POWER = 1e7
_ACTIVE_THRESH = 1e-2 * _TARGET_POWER * 1e-4
_CHUNK = 20  # frames per L6 sub-interval (~320 ms at 50% overlap)
# 0.8**128 = 4e-13: a tap past the last moves a smoothed gain (at least
# 3e-4, each input at most 5) by under 1e-8 of itself, below fp32's rounding
_SMOOTH_TAPS = 128


@functools.lru_cache(maxsize=None)
def _mode_tables(mode: str, n_fft: int):
    """Numpy constants for one mode, derived from the host implementation's
    tables so both paths share their numerics. ``n_fft`` is the padded
    transform length of the level and receive filters (it depends on T,
    hence a cache key)."""
    from ..metrics import _pesq as host

    if mode not in host._MODES:
        raise ValueError(f"mode must be 'nb' or 'wb', got {mode!r}")
    m = host._MODES[mode]

    # full-signal filter gains on the padded rfft grid
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / m.fs)
    level_gain = ((freqs > 300.0) & (freqs < 0.475 * m.fs)).astype(np.float32)
    if mode == "wb":
        recv_gain = 1.0 / (1.0 + (100.0 / np.maximum(freqs, 1e-9)) ** 8)
    else:
        pts_hz = np.array([50.0, 135.0, 250.0, 300.0, 500.0, 1000.0, 2000.0, 3000.0, 3400.0,
                           4000.0])
        pts_db = np.array([-40.0, -20.0, -6.0, -2.0, 0.0, 0.0, 2.0, 4.0, -2.0, -40.0])
        lf = np.log10(np.maximum(freqs, 1.0))
        g_db = np.interp(lf, np.log10(pts_hz), pts_db, left=-60.0, right=-60.0)
        recv_gain = 10.0 ** (g_db / 20.0)
    recv_gain = recv_gain.astype(np.float32)

    # Bark grouping as a (valid_bins, n_bands) 0/1 matrix
    onehot = np.zeros((int(m.valid_bin.sum()), m.n_bands), dtype=np.float32)
    onehot[np.arange(onehot.shape[0]), m.band_of_bin[m.valid_bin]] = 1.0

    return dict(
        fs=m.fs,
        frame=m.frame,
        hop=m.hop,
        n_bands=m.n_bands,
        level_gain=level_gain,
        recv_gain=recv_gain,
        valid_bin=np.where(m.valid_bin)[0],
        onehot=onehot,
        bin_counts=m.band_bin_counts.astype(np.float32),
        abs_thresh=m.abs_thresh.astype(np.float32),
        band_widths=m.band_widths_bark.astype(np.float32),
        spl0=np.float32(host._SPL0),
        d_sym=np.float32(host._D_SYM_SCALE),
        d_asym=np.float32(host._D_ASYM_SCALE),
        d_loss=np.float32(host._D_LOSS_SCALE),
        zwicker_p=np.float32(host._ZWICKER_P),
        loud_scale=np.float32(host._LOUDNESS_SCALE),
    )


def _const(array, device):
    return torch.from_numpy(np.asarray(array)).to(device)


def _level_and_receive(x, tab):
    """Level alignment and receive filtering through one padded rfft (gains
    measured on the truncated filtered signal, as the host does)."""
    T = x.shape[-1]
    n = int(2 ** np.ceil(np.log2(max(T, 2))))
    X = torch.fft.rfft(x, n=n)
    band = torch.fft.irfft(X * _const(tab["level_gain"], x.device), n=n)[..., :T]
    p = torch.mean(band ** 2, dim=-1, keepdim=True) + 1e-30
    scale = torch.sqrt(_TARGET_POWER / p)
    filt = torch.fft.irfft(X * _const(tab["recv_gain"], x.device), n=n)[..., :T]
    return filt * scale


def _coarse_delay(x, y, win):
    """Lag of the log-energy envelopes' cross-correlation, in envelope
    frames ``(B,)``, through a padded-FFT circular correlation in float64.
    Among near-equal maxima (a flat correlation: a silent or constant
    degraded signal) the lag nearest zero wins, the negative one on ties of
    ``|lag|``, as on the host."""
    B, T = x.shape
    nE = T // win
    x, y = x.double(), y.double()
    ex = torch.log10((x[:, : nE * win].reshape(B, nE, win) ** 2).sum(dim=-1) + 1e4)
    ey = torch.log10((y[:, : nE * win].reshape(B, nE, win) ** 2).sum(dim=-1) + 1e4)
    ex = ex - ex.mean(dim=-1, keepdim=True)
    ey = ey - ey.mean(dim=-1, keepdim=True)
    M = int(2 ** np.ceil(np.log2(max(2 * nE, 2))))
    # c[l] = sum_i ey[i + l] ex[i], negative lags wrapped to the top
    c = torch.fft.irfft(torch.fft.rfft(ey, n=M) * torch.conj(torch.fft.rfft(ex, n=M)), n=M)
    lags = torch.from_numpy(np.concatenate([np.arange(nE), np.arange(-(nE - 1), 0)])).to(x.device)
    vals = torch.cat([c[:, :nE], c[:, M - (nE - 1):]], dim=-1)
    tol = 1e-9 * torch.clamp(vals.abs().max(dim=-1, keepdim=True).values, min=1.0)
    tied = vals >= vals.max(dim=-1, keepdim=True).values - tol
    key = torch.where(tied, lags.abs() * 2 + (lags > 0), torch.iinfo(torch.int64).max)
    return lags[torch.argmin(key, dim=-1)]


def _roll_items(z, shift):
    """``z`` ``(B, L, ...)`` rolled left along axis 1 by ``shift[b]`` for
    each item: ``out[b, i] = z[b, (i + shift[b]) mod L]``."""
    L = z.shape[1]
    idx = (torch.arange(L, device=z.device)[None, :] + shift[:, None]) % L
    return torch.take_along_dim(z, idx.reshape(idx.shape + (1,) * (z.ndim - 2)), dim=1)


def _fine_delay(x, y, coarse, fs):
    """Rectified-signal correlation, normalized by the overlap and scored in
    float64, over a +-2 ms lag grid around each item's coarse estimate. The
    grid runs nearest-first, so argmax's first-maximum rule keeps the host's
    strict-improvement visit order."""
    T = x.shape[-1]
    span = int(0.002 * fs)
    step = max(span // 16, 1)
    off_np = np.arange(-span, span + 1, step)
    offsets = off_np[np.lexsort((off_np, np.abs(off_np)))]
    r, d = x.abs().double(), y.abs().double()
    idx = torch.arange(T, device=x.device)
    vals = []
    for off in offsets:
        lag = coarse + int(off)
        m = ((idx[None, :] + lag[:, None] >= 0) & (idx[None, :] + lag[:, None] < T)).double()
        vals.append((r * m * _roll_items(d, lag)).sum(dim=-1) / (m.sum(dim=-1) + 1e-9))
    best = torch.argmax(torch.stack(vals, dim=-1), dim=-1)
    return coarse + torch.from_numpy(offsets).to(x.device)[best]


def _smooth_gain(g):
    """``g_s[i] = 0.8 g_s[i-1] + 0.2 g[i]`` with ``g_s[-1] = g[0]`` along the
    last axis of ``(B, F)``: ``0.8^(i+1) g[0] + sum_k 0.2 0.8^k g[i-k]``, the
    sum truncated at ``_SMOOTH_TAPS`` taps and taken in float64 as one causal
    convolution. (The closed form ``0.8^i cumsum(0.8^-j g_j)`` overflows
    fp32 from j ~ 398, and a sequential recurrence costs one launch a
    frame.)"""
    B, n = g.shape
    gd = g.double()
    taps = 0.2 * 0.8 ** torch.arange(_SMOOTH_TAPS - 1, -1, -1, dtype=torch.float64,
                                     device=g.device)
    fir = F.conv1d(F.pad(gd[:, None], (_SMOOTH_TAPS - 1, 0)), taps[None, None])[:, 0]
    init = 0.8 ** torch.arange(1, n + 1, dtype=torch.float64, device=g.device)
    return (fir + init * gd[:, :1]).to(g.dtype)


def _aggregate(d, n_valid_frames):
    """L6 over CHUNK-frame sub-intervals, L2 over chunks, per item. ``d`` is
    zero past each item's valid prefix, so the partial last chunk's zero
    fill matches the host's zero pad; wholly invalid chunks are masked out of
    the L2 mean."""
    B, n = d.shape
    d = F.pad(d, (0, -(-n // _CHUNK) * _CHUNK - n)).reshape(B, -1, _CHUNK)
    d6 = torch.mean(d ** 6.0, dim=-1) ** (1.0 / 6.0)
    n_chunks = torch.ceil(n_valid_frames / _CHUNK)
    cmask = (torch.arange(d6.shape[1], device=d.device) < n_chunks[:, None]).to(d.dtype)
    return torch.sqrt((cmask * d6 ** 2.0).sum(dim=-1) / torch.clamp(n_chunks, min=1.0))


def _pesq_parts(x, y, mode):
    """``(B, T)`` references and degraded signals at the mode's rate ->
    MOS-LQO ``(B,)`` and each item's delay in samples ``(B,)``."""
    T = x.shape[-1]
    dev = x.device
    tab = _mode_tables(mode, int(2 ** np.ceil(np.log2(max(T, 2)))))
    fs, frame, hop = tab["fs"], tab["frame"], tab["hop"]

    x = _level_and_receive(x, tab)
    y = _level_and_receive(y, tab)

    win = max(int(0.004 * fs), 1)
    delay = _fine_delay(x, y, _coarse_delay(x, y, win) * win, fs)

    # align by rolling the degraded signal; the window of sample indices
    # where both sides are genuine data replaces the host's trim
    y = _roll_items(y, delay)
    s0 = torch.clamp(-delay, min=0)
    e0 = T - torch.clamp(delay, min=0)

    # Bark pitch-power densities on the full frame grid
    w = torch.from_numpy(np.hanning(frame).astype(np.float32)).to(dev)
    w_pow = float(np.mean(np.hanning(frame) ** 2))
    valid_bin = _const(tab["valid_bin"], dev)
    onehot, bin_counts = _const(tab["onehot"], dev), _const(tab["bin_counts"], dev)

    def bark(sig):
        spec = torch.fft.rfft(_frame(sig, frame, hop) * w, dim=-1).abs() ** 2 / (w_pow * frame)
        with strict_fp32():
            return (spec[..., valid_bin] @ onehot) / bin_counts

    B_ref, B_deg = bark(x), bark(y)  # (B, F, n_bands)
    n_frames = B_ref.shape[1]

    starts = torch.arange(n_frames, device=dev) * hop
    valid = (starts >= s0[:, None]) & (starts + frame <= e0[:, None])  # contiguous run
    # roll the valid run to the front: warm-ups, active-frame statistics
    # and chunk boundaries then match the host's re-framed trimmed signal
    # (up to the sub-hop framing phase)
    f0 = torch.argmax(valid.int(), dim=-1)
    nv = valid.sum(dim=-1)
    B_ref, B_deg = _roll_items(B_ref, f0), _roll_items(B_deg, f0)
    vmask = (torch.arange(n_frames, device=dev) < nv[:, None]).to(B_ref.dtype)

    frame_pow = B_ref.sum(dim=-1)
    active = (frame_pow > _ACTIVE_THRESH).to(B_ref.dtype) * vmask
    active = torch.where(active.sum(dim=-1, keepdim=True) > 0, active, vmask)

    # partial frequency compensation
    n_act = active.sum(dim=-1, keepdim=True) + 1e-9
    mean_ref = (B_ref * active[..., None]).sum(dim=1) / n_act
    mean_deg = (B_deg * active[..., None]).sum(dim=1) / n_act
    comp = torch.clamp((mean_deg + 1e3) / (mean_ref + 1e3), 1e-2, 1e2)
    B_ref_eq = B_ref * comp[:, None, :]

    # short-term gain compensation; invalid frames take the first valid
    # frame's gain so the recurrence reaches the valid prefix in the host's
    # warmed-up state
    g = (B_ref_eq.sum(dim=-1) + 5e3) / (B_deg.sum(dim=-1) + 5e3)
    g = torch.clamp(g, 3e-4, 5.0)
    g = torch.where(vmask > 0, g, g[:, :1])
    B_deg_eq = B_deg * _smooth_gain(g)[..., None]

    # Zwicker loudness
    p0 = _const(tab["abs_thresh"], dev)[None, None, :]
    zp = float(tab["zwicker_p"])

    def loud(b):
        ratio = torch.clamp(b / p0, min=0.0)
        L = (float(tab["loud_scale"]) * (p0 / (0.5 * float(tab["spl0"]))) ** zp
             * ((0.5 + 0.5 * ratio) ** zp - 1.0))
        return torch.clamp(L, min=0.0)

    L_ref, L_deg = loud(B_ref_eq), loud(B_deg_eq)

    # masked and asymmetric disturbance
    diff = L_deg - L_ref
    dead = 0.25 * torch.minimum(L_deg, L_ref)
    disturb = torch.sign(diff) * torch.clamp(diff.abs() - dead, min=0.0)
    h = ((B_deg_eq + 50.0) / (B_ref_eq + 50.0)) ** 1.2
    h = torch.where(h < 3.0, 0.0, torch.clamp(h, max=12.0))

    wb = _const(tab["band_widths"], dev)[None, None, :]
    wb_sum = wb.sum()
    d_frame = ((wb * disturb.abs() ** 2.0).sum(dim=-1) / wb_sum) ** 0.5
    da_frame = ((disturb * h).abs() * wb).sum(dim=-1) / wb_sum

    wf = ((frame_pow + 1e5) / 1e7) ** 0.04
    d_frame = torch.clamp(d_frame / wf, max=45.0) * vmask
    da_frame = torch.clamp(da_frame / wf, max=45.0) * vmask

    # subtractive-loss channel: the fraction of audible reference loudness
    # with no degraded counterpart, cubed and averaged over active frames
    loss = (wb * torch.clamp(L_ref - L_deg, min=0.0)).sum(dim=-1) / (
        (wb * L_ref).sum(dim=-1) + 1e-12)
    d_loss = (active * loss ** 3).sum(dim=-1) / (active.sum(dim=-1) + 1e-9)

    raw = (4.5 - float(tab["d_sym"]) * _aggregate(d_frame, nv)
           - float(tab["d_asym"]) * _aggregate(da_frame, nv)
           - float(tab["d_loss"]) * d_loss)
    if mode == "wb":
        mos = 0.999 + 4.999 / (1.0 + torch.exp(-1.338 * raw + 5.035))
    else:
        mos = 0.999 + 4.0 / (1.0 + torch.exp(-1.4945 * raw + 4.6607))
    # no fully valid frame after alignment: every disturbance term is 0 and
    # `raw` its 4.5 ceiling, a perfect score for a pair with no usable
    # overlap. Undefined, as in STOI's too-short guard.
    return torch.where(nv > 0, mos, torch.nan), delay


def _checked_pair(references, estimates, mode):
    references, estimates = _common_length(references, estimates)
    tab = _mode_tables(mode, 2)  # validates the mode first
    if references.shape[-1] < 4 * tab["frame"]:
        raise ValueError("signals too short for PESQ (need >= 4 frames)")
    return references, estimates


def pesq_batch(references, estimates, mode: str = "wb") -> torch.Tensor:
    """MOS-LQO estimates ``(B,)`` for ``(B, T)`` reference/degraded pairs
    already at the mode's sample rate (nb: 8 kHz, wb: 16 kHz). Each item is
    level-aligned, receive-filtered, delay-aligned and scored on its own.
    Pairs of unequal length are trimmed to the shorter signal (the delay
    alignment absorbs the offset)."""
    return _pesq_parts(*_checked_pair(references, estimates, mode), mode)[0]
