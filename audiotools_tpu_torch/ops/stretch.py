"""Phase-vocoder time stretching and pitch shifting on tensors.

Counterpart of ``audiotools_tpu/ops/stretch.py``: STFT -> phase vocoder
-> iSTFT, and a polyphase resample for the pitch shift. The vocoder has the
JAX package's four formulations (``_FORMULATIONS``): ``"angle"`` (the
default), ``"phasor"``, ``"phasor_fused"`` (kernel B,
``hopper_kernels.phase_vocoder_fused``, differentiable through
``_FusedPhaseVocoder``) and ``"phasor_fused_interpret"`` (the same with
B's plain version in the kernel's place).
"""
import math
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from . import fft as _fft
from . import hopper_kernels
from . import resample as _resample

__all__ = ["phase_vocoder", "time_stretch", "pitch_shift"]

_FORMULATIONS = ("angle", "phasor", "phasor_fused", "phasor_fused_interpret")


def _pv_indices(T: int, rate: float):
    """Step tables: frames ``i0``/``i1`` around input position ``s *
    rate`` and the interpolation weight ``frac`` of each output step."""
    n_steps = int(np.ceil(T / rate))
    steps = np.arange(n_steps) * rate
    i0 = np.minimum(np.floor(steps).astype(np.int32), T - 1)
    i1 = np.minimum(i0 + 1, T - 1)
    frac = (steps - i0).astype(np.float32)
    return i0, i1, frac


def _rot(a, b):
    """Complex product of real pairs ``a * b``."""
    (ar, ai), (br, bi) = a, b
    return ar * br - ai * bi, ar * bi + ai * br


def _associative_scan(combine, elems):
    """Inclusive scan of a tuple of tensors over the last axis with an
    associative ``combine``, in log depth: adjacent pairs are combined, the
    half-length sequence is scanned, and the even positions are filled in
    (the odd/even recursion of ``jax.lax.associative_scan``, so the
    products are formed in the same tree order)."""
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    odd = _associative_scan(combine, combine(
        tuple(e[..., 0:n - 1:2] for e in elems), tuple(e[..., 1::2] for e in elems)))
    if n % 2 == 0:
        even = combine(tuple(o[..., :-1] for o in odd), tuple(e[..., 2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[..., 2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        ev = torch.cat([e[..., :1], ev], dim=-1)
        full = ev.new_empty(ev.shape[:-1] + (n,))
        full[..., 0::2] = ev
        full[..., 1::2] = od
        out.append(full)
    return tuple(out)


def _pv_phasor_prep(stft_data, i0, i1, frac):
    """The phasor vocoder's pieces before its scan: interpolated magnitudes
    ``mag``, each step's unit rotation ``(ur, ui)`` (the identity at a
    silent bin) and frame 0's unit seed phasor ``(cr, ci)``."""
    frac = torch.from_numpy(frac).to(stft_data.device)
    z0, z1 = stft_data[..., i0], stft_data[..., i1]
    a0, a1 = z0.abs(), z1.abs()
    mag = (1.0 - frac) * a0 + frac * a1
    wr = z1.real * z0.real + z1.imag * z0.imag
    wi = z1.imag * z0.real - z1.real * z0.imag
    norm = a0 * a1
    safe = torch.where(norm > 0.0, norm, 1.0)
    ur = torch.where(norm > 0.0, wr / safe, 1.0)
    ui = torch.where(norm > 0.0, wi / safe, 0.0)
    f0 = z0[..., 0]
    fa = f0.abs()
    fsafe = torch.where(fa > 0.0, fa, 1.0)
    cr = torch.where(fa > 0.0, f0.real / fsafe, 1.0)
    ci = torch.where(fa > 0.0, f0.imag / fsafe, 0.0)
    return mag, ur, ui, cr, ci


def _phase_vocoder_phasor(stft_data, i0, i1, frac):
    """Phasor evaluation: interpolated magnitudes times the exclusive
    cumulative product of the unit cross-spectra, seeded with frame 0's
    unit phasor (a zero frame contributes the identity)."""
    mag, ur, ui, cr, ci = _pv_phasor_prep(stft_data, i0, i1, frac)
    sr = torch.cat([cr[..., None], ur[..., :-1]], dim=-1)
    si = torch.cat([ci[..., None], ui[..., :-1]], dim=-1)
    pr, pi = _associative_scan(_rot, (sr, si))
    return torch.complex(mag * pr, mag * pi)


class _FusedPhaseVocoder(torch.autograd.Function):
    """The ``phasor_fused`` vocoder with a gradient (the JAX package's
    ``_fused_pv_diff``). Forward: kernel B with its phasor track ``P``
    (``out = mag P``), kept for the backward with the spectrum. Backward,
    in plain PyTorch: with ``g`` the output's gradient, ``mbar = Re(g
    conj P)`` and ``w = mag g conj P``; since every phasor is unit, the
    reverse rotation recurrence is one reversed cumsum ``V_s = sum_{t >= s}
    w_t``, giving ``ubar_s = u_s V_{s+1}`` and ``cbar = c V_0``; these go
    through the vector-Jacobian product of ``_pv_phasor_prep``. ``vocoder``
    is kernel B's wrapper, or its plain version for
    ``"phasor_fused_interpret"``."""

    @staticmethod
    def forward(ctx, stft_data, i0, i1, frac, vocoder):
        out, track = vocoder(stft_data, i0, i1, frac, with_phasor=True)
        ctx.save_for_backward(stft_data, track)
        ctx.tables = (i0, i1, frac)
        return out

    @staticmethod
    def backward(ctx, grad):
        stft_data, track = ctx.saved_tensors
        with torch.enable_grad():
            z = stft_data.detach().requires_grad_(True)
            prep = _pv_phasor_prep(z, *ctx.tables)
        mag, ur, ui, cr, ci = (t.detach() for t in prep)
        pr, pi, gr, gi = track.real, track.imag, grad.real, grad.imag
        mbar = gr * pr + gi * pi
        # V_s = sum_{t >= s} w_t: one reversed cumsum over the stacked pair
        w = torch.stack([mag * mbar, mag * (gi * pr - gr * pi)], dim=-2)
        v = w.flip(-1).cumsum(-1).flip(-1)
        vr, vi = v[..., 0, :], v[..., 1, :]
        vr1 = F.pad(vr[..., 1:], (0, 1))
        vi1 = F.pad(vi[..., 1:], (0, 1))
        ubar_r, ubar_i = ur * vr1 - ui * vi1, ur * vi1 + ui * vr1
        cbar_r = cr * vr[..., 0] - ci * vi[..., 0]
        cbar_i = cr * vi[..., 0] + ci * vr[..., 0]
        (zbar,) = torch.autograd.grad(prep, z, (mbar, ubar_r, ubar_i, cbar_r, cbar_i))
        return zbar, None, None, None, None


def _phase_vocoder_angle(stft_data, i0, i1, frac, hop_length, window_length):
    """Real-angle evaluation: per-step phase deviations by ``atan2``,
    integrated with one cumsum."""
    F_bins = stft_data.shape[-2]
    device = stft_data.device
    mag, phase = stft_data.abs(), stft_data.angle()
    mag_t = (torch.from_numpy(1.0 - frac).to(device) * mag[..., i0]
             + torch.from_numpy(frac).to(device) * mag[..., i1])
    # expected advance per hop and bin, reduced mod 2 pi in exact integer
    # arithmetic: an f32 ramp reaches ~1.6e3 rad, whose representation
    # error the cumsum would accumulate linearly (5e-3 at 431 steps)
    phi_advance = torch.from_numpy((
        ((hop_length * np.arange(F_bins, dtype=np.int64)) % window_length).astype(np.float32)
        * (2.0 * np.pi / window_length)
    )[:, None]).to(device)
    two_pi = 2.0 * math.pi
    dphase = phase[..., i1] - phase[..., i0] - phi_advance
    dphase = dphase - two_pi * torch.round(dphase / two_pi)
    # each step wrapped to its principal value keeps the f32 cumsum O(pi n)
    step_advance = phi_advance + dphase
    step_advance = step_advance - two_pi * torch.round(step_advance / two_pi)
    acc = torch.cumsum(step_advance, dim=-1)
    phase_out = phase[..., :1] + F.pad(acc[..., :-1], (1, 0))
    return torch.complex(mag_t * torch.cos(phase_out), mag_t * torch.sin(phase_out))


def phase_vocoder(stft_data, rate: float, hop_length: int, window_length: int,
                  formulation: str = "angle"):
    """Stretch ``(..., F, T)`` complex STFT frames by ``rate`` (``rate > 1``
    gives fewer frames): interpolated magnitudes with the phase propagated
    step by step.

    ``formulation``: ``"angle"`` integrates wrapped ``atan2`` phase
    deviations with one cumsum; ``"phasor"`` forms the cumulative product
    of unit cross-spectra ``z1 conj(z0) / |z1 z0|`` by a log-depth scan;
    ``"phasor_fused"`` runs the phasor recurrence in kernel B, and when
    the spectrum requires grad it is differentiable, the backward a
    reversed cumsum over kernel B's phasor track (``_FusedPhaseVocoder``,
    gradient parity with ``"phasor"`` at 4.4e-5); ``"phasor_fused_interpret"``
    (the JAX package's name for the kernel off its hardware) is the same
    with B's plain version in the kernel's place, on the spectrum's own
    device. The formulations agree except after a transient zero frame,
    where the phasor forms carry an identity rotation and ``"angle"`` a
    phase of 0.
    """
    i0, i1, frac = _pv_indices(stft_data.shape[-1], rate)
    if formulation == "angle":
        return _phase_vocoder_angle(stft_data, i0, i1, frac, hop_length, window_length)
    if formulation == "phasor":
        return _phase_vocoder_phasor(stft_data, i0, i1, frac)
    if formulation in ("phasor_fused", "phasor_fused_interpret"):
        vocoder = (hopper_kernels.phase_vocoder_fused_plain
                   if formulation == "phasor_fused_interpret"
                   else hopper_kernels.phase_vocoder_fused)
        if torch.is_grad_enabled() and stft_data.requires_grad:
            return _FusedPhaseVocoder.apply(stft_data, i0, i1, frac, vocoder)
        return vocoder(stft_data, i0, i1, frac)
    raise ValueError(f"formulation must be one of {_FORMULATIONS}, got {formulation!r}")


def time_stretch(audio, factor: float, window_length: int = 2048, hop_length: int = None,
                 method: str = "matmul", synthesis_method: str = None,
                 pv_formulation: str = "angle"):
    """Stretch ``(..., T)`` audio by ``factor`` (> 1 is faster) to
    ``round(T / factor)`` samples. ``method`` selects the analysis STFT,
    ``synthesis_method`` (default: ``method``) the iSTFT."""
    if hop_length is None:
        hop_length = window_length // 4
    if synthesis_method is None:
        synthesis_method = method
    out_len = int(round(audio.shape[-1] / factor))
    spec = _fft.stft(audio, window_length, hop_length, "hann", method=method)
    stretched = phase_vocoder(spec, factor, hop_length, window_length,
                              formulation=pv_formulation)
    return _fft.istft(stretched, window_length, hop_length, "hann", length=out_len,
                      method=synthesis_method)


def pitch_shift(audio, n_semitones: float, sample_rate: int, window_length: int = 2048,
                hop_length: int = None, method: str = "matmul",
                synthesis_method: str = None, pv_formulation: str = "angle"):
    """Shift pitch by ``n_semitones`` keeping the duration: a time stretch
    by ``2 ** (-n / 12)`` and a resample by the same ratio, with the stretch
    on whichever side of the resample has fewer samples."""
    T = audio.shape[-1]
    rate = 2.0 ** (-float(n_semitones) / 12.0)
    # smallest denominator keeping the pitch-ratio error under 2e-5
    for cap in (60, 125, 250, 500, 1000, 5000):
        frac = Fraction(rate).limit_denominator(cap)
        if abs(float(frac) - rate) / rate < 2e-5:
            break
    old_sr, new_sr = frac.denominator, frac.numerator
    stretch = dict(window_length=window_length, hop_length=hop_length, method=method,
                   synthesis_method=synthesis_method, pv_formulation=pv_formulation)
    if rate < 1.0:
        out = time_stretch(_resample.resample(audio, old_sr, new_sr), rate, **stretch)
    else:
        out = _resample.resample(time_stretch(audio, rate, **stretch), old_sr, new_sr)
    if out.shape[-1] < T:
        out = F.pad(out, (0, T - out.shape[-1]))
    return out[..., :T]
