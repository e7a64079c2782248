"""Hand-written Hopper kernels, with their plain PyTorch versions
(counterpart of ``audiotools_tpu/ops/pallas_kernels.py``): A, the per-item
causal FIR; B, the fused phase vocoder; C, the causal FIR with one shared
kernel; D, the exclusive complex cumulative product; E, the fused bf16
iSTFT synthesis.

Each wrapper runs its plain version for a tensor on the CPU and launches
its CUDA kernel (``csrc/*.cu``, built at first use by ``_build``) for a
tensor on the card; for any other device, or when the kernel cannot be
built, it raises. ``LAUNCHES`` counts the kernel launches of each wrapper,
so a run can show that its main path went through the kernels.
"""
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ._fp32 import strict_fp32

__all__ = [
    "MAX_TAPS",
    "MAX_TAPS_BATCH",
    "MAX_SYNTHESIS_OVERLAP",
    "LAUNCHES",
    "reset_launch_counts",
    "fir_causal_batch",
    "fir_causal_batch_plain",
    "PvPlan",
    "pv_plan",
    "phase_vocoder_fused",
    "phase_vocoder_fused_plain",
    "fir_causal",
    "fir_causal_plain",
    "RotationPlan",
    "rotation_plan",
    "rotation_cumprod",
    "rotation_cumprod_plain",
    "synthesis_weights",
    "istft_synthesis_fused",
    "istft_synthesis_fused_plain",
]

MAX_TAPS = 8192  # kernel C's limit (the shared-kernel FIR; the meter uses 1023 or 4095)
MAX_TAPS_BATCH = 2048  # kernel A's limit (the equalizer's per-item FIR)
MAX_SYNTHESIS_OVERLAP = 8  # kernel E: at most n_fft / hop overlapping frames

LAUNCHES = {name: 0 for name in (
    "fir_causal_batch", "phase_vocoder_fused", "fir_causal", "rotation_cumprod",
    "istft_synthesis_fused",
)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (csrc file, argtypes)
    "fir_causal_batch": ("fir_causal_batch", [_P, _P, _P, _I, _I, _I, _P]),
    "fir_causal": ("fir_causal_batch", [_P, _P, _P, _I, _I, _I, _P]),
    "phase_vocoder_fused": ("phase_vocoder",
                            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "rotation_cumprod": ("rotation_cumprod", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "istft_synthesis_fused": ("istft_synthesis",
                              [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernel(name: str):
    """The C entry point ``name``, with its argument types declared."""
    source, argtypes = _SIGNATURES[name]
    fn = getattr(_build.library(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _require_cuda(name, *tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device != tensors[0].device:
            raise RuntimeError(f"{name}: tensors on {t.device} and {tensors[0].device}")
        if not t.is_contiguous():
            raise RuntimeError(f"{name}: expected contiguous tensors")


def _launch(name, tensors, *args):
    """Launch kernel ``name`` on the current stream of ``tensors``' device:
    the kernel is built or loaded first (raising if it cannot be), then the
    tensors must be contiguous CUDA tensors on one device."""
    fn = _kernel(name)
    _require_cuda(name, *tensors)
    device = tensors[0].device
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# A: per-item causal FIR (replaces pallas_kernels.fir_conv_causal_batch)
# ---------------------------------------------------------------------------


def _check_fir(x, h):
    if x.ndim != 2 or h.ndim != 2:
        raise ValueError(f"expected x (rows, T) and h (rows, L), got {tuple(x.shape)}, {tuple(h.shape)}")
    if h.shape[0] != x.shape[0]:
        raise ValueError(f"kernel batch {h.shape[0]} != signal batch {x.shape[0]}")
    if x.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}, {h.dtype}")


def fir_causal_batch_plain(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``y[r, n] = sum_k h[r, k] x[r, n - k]`` for ``n < T``: a grouped
    ``conv1d`` of the left-padded rows against their flipped kernels."""
    _check_fir(x, h)
    R, L = h.shape
    with strict_fp32():
        return F.conv1d(F.pad(x, (L - 1, 0))[None], h.flip(-1)[:, None, :], groups=R)[0]


def fir_causal_batch(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal FIR of ``(rows, T)`` float32 signals with per-row kernels
    ``(rows, L)``, ``L <= MAX_TAPS_BATCH``, truncated to ``T`` samples
    (``csrc/fir_causal_batch.cu``)."""
    if x.device.type == "cpu":
        return fir_causal_batch_plain(x, h)
    _check_fir(x, h)
    rows, T = x.shape
    L = h.shape[-1]
    if L > MAX_TAPS_BATCH:
        raise ValueError(f"fir_causal_batch takes at most {MAX_TAPS_BATCH} taps, got {L}")
    if rows > 65535:
        raise ValueError(f"fir_causal_batch takes at most 65535 rows, got {rows}")
    y = torch.empty_like(x)
    _launch("fir_causal_batch", (x, h, y), x.data_ptr(), h.data_ptr(),
            y.data_ptr(), rows, T, L)
    return y


# ---------------------------------------------------------------------------
# B: fused phasor phase vocoder (replaces pallas_kernels.phase_vocoder_fused)
# ---------------------------------------------------------------------------


def _check_pv(stft_data, i0, i1, frac):
    if not torch.is_complex(stft_data) or stft_data.dtype != torch.complex64:
        raise TypeError(f"expected complex64 spectra, got {stft_data.dtype}")
    T = stft_data.shape[-1]
    i0 = np.asarray(i0, dtype=np.int32)
    i1 = np.asarray(i1, dtype=np.int32)
    frac = np.asarray(frac, dtype=np.float32)
    n = i0.shape[0]
    if n < 1 or i0.shape != (n,) or i1.shape != (n,) or frac.shape != (n,):
        raise ValueError("i0, i1 and frac must be 1-D of one nonzero length")
    for idx in (i0, i1):
        if idx.min() < 0 or idx.max() >= T:
            raise ValueError(f"step indices must lie in [0, {T})")
    if i0[0] != 0:
        raise ValueError("the first step must read frame 0 (the seed frame)")
    return i0, i1, frac


def phase_vocoder_fused_plain(stft_data, i0, i1, frac, with_phasor: bool = False):
    """Phasor phase vocoder as a loop over steps on ``(rows,)`` planes, in
    the kernel's operation order. ``stft_data`` is ``(..., F, T)`` complex;
    returns ``(..., F, n_steps)`` complex, plus the phasor track ``P`` (same
    shape) when ``with_phasor``."""
    i0, i1, frac = _check_pv(stft_data, i0, i1, frac)
    *lead, F_bins, T = stft_data.shape
    n_steps = i0.shape[0]
    i0, i1 = i0.tolist(), i1.tolist()
    # time-major (T, rows): each step reads two contiguous rows of frames
    z = stft_data.reshape(-1, T).transpose(0, 1)
    zr, zi = z.real.contiguous(), z.imag.contiguous()

    sr, si = zr[0], zi[0]
    s_mag = torch.sqrt(sr * sr + si * si)
    nonzero = s_mag > 0.0
    safe = torch.where(nonzero, s_mag, 1.0)
    acc_r = torch.where(nonzero, sr / safe, 1.0)
    acc_i = torch.where(nonzero, si / safe, 0.0)

    out_r = torch.empty((n_steps,) + sr.shape, dtype=sr.dtype, device=sr.device)
    out_i = torch.empty_like(out_r)
    p_r = torch.empty_like(out_r) if with_phasor else None
    p_i = torch.empty_like(out_r) if with_phasor else None
    for s in range(n_steps):
        f = np.float32(frac[s])
        z0r, z0i, z1r, z1i = zr[i0[s]], zi[i0[s]], zr[i1[s]], zi[i1[s]]
        a0 = torch.sqrt(z0r * z0r + z0i * z0i)
        a1 = torch.sqrt(z1r * z1r + z1i * z1i)
        mag = float(np.float32(1.0) - f) * a0 + float(f) * a1
        out_r[s] = mag * acc_r
        out_i[s] = mag * acc_i
        if with_phasor:
            p_r[s] = acc_r
            p_i[s] = acc_i
        wr = z1r * z0r + z1i * z0i
        wi = z1i * z0r - z1r * z0i
        norm = a0 * a1
        ok = norm > 0.0
        inv = 1.0 / torch.where(ok, norm, 1.0)
        ur = torch.where(ok, wr * inv, 1.0)
        ui = torch.where(ok, wi * inv, 0.0)
        acc_r, acc_i = acc_r * ur - acc_i * ui, acc_r * ui + acc_i * ur

    def back(re, im):
        return torch.complex(re, im).transpose(0, 1).reshape(*lead, F_bins, n_steps)

    out = back(out_r, out_i)
    return (out, back(p_r, p_i)) if with_phasor else out


class PvPlan(NamedTuple):
    """Kernel B's launch: ``threads`` rows a block (one thread each), frames
    fetched ``depth`` steps ahead of their use, a block barrier every
    ``sync_every`` steps (0: none), ``smem`` bytes of frame ring a block,
    ``blocks`` blocks."""
    threads: int
    depth: int
    sync_every: int
    smem: int
    blocks: int


def pv_plan(rows: int, with_phasor: bool = False) -> PvPlan:
    """Kernel B's launch for ``rows`` rows, with the block and depth its
    build takes (``_build.DEFINES``): each thread's ring holds ``depth + 1``
    steps' two frames (complex64). With the phasor track, a block barrier
    every 4 steps keeps the warps of a block writing neighbouring bins
    together (measured faster with the track's second output, slower
    without it: PERF.md)."""
    geometry = _build.DEFINES["phase_vocoder"]
    threads, depth = geometry["PV_THREADS"], geometry["PV_DEPTH"]
    smem = (depth + 1) * 2 * threads * 8
    return PvPlan(threads, depth, 4 if with_phasor else 0, smem, -(-rows // threads))


@functools.lru_cache(maxsize=16)
def _step_tables(i0b: bytes, i1b: bytes, fracb: bytes, device):
    return (
        torch.from_numpy(np.frombuffer(i0b, np.int32).copy()).to(device),
        torch.from_numpy(np.frombuffer(i1b, np.int32).copy()).to(device),
        torch.from_numpy(np.frombuffer(fracb, np.float32).copy()).to(device),
    )


def phase_vocoder_fused(stft_data, i0, i1, frac, with_phasor: bool = False):
    """Fused phasor phase vocoder (``csrc/phase_vocoder.cu``).

    ``stft_data``: ``(..., F, T)`` complex64; ``i0``/``i1``/``frac``: the
    step tables of ``ops.stretch._pv_indices``. Returns ``(..., F,
    n_steps)`` complex64, and with ``with_phasor`` also the unit phasor
    track ``P`` (``out = mag * P``). A spectrum that is a transposed view
    of a time-major ``(..., T, F)`` tensor, as ``ops.fft.stft`` returns,
    is read in place.
    """
    if stft_data.device.type == "cpu":
        return phase_vocoder_fused_plain(stft_data, i0, i1, frac, with_phasor)
    i0, i1, frac = _check_pv(stft_data, i0, i1, frac)
    *lead, F_bins, T = stft_data.shape
    n_steps = i0.shape[0]
    items = int(np.prod(lead, dtype=np.int64)) if lead else 1
    z = stft_data.reshape(items, F_bins, T).transpose(1, 2).contiguous()
    ti0, ti1, tfrac = _step_tables(i0.tobytes(), i1.tobytes(), frac.tobytes(), z.device)
    out = torch.empty((items, n_steps, F_bins), dtype=torch.complex64, device=z.device)
    track = torch.empty_like(out) if with_phasor else None
    plan = pv_plan(items * F_bins, with_phasor)
    _launch(
        "phase_vocoder_fused", (z, ti0, ti1, tfrac, out), z.data_ptr(), ti0.data_ptr(), ti1.data_ptr(),
        tfrac.data_ptr(), out.data_ptr(), track.data_ptr() if with_phasor else None,
        items, F_bins, T, n_steps, plan.sync_every, plan.smem, plan.blocks,
    )

    def back(t):
        return t.transpose(1, 2).reshape(*lead, F_bins, n_steps)

    return (back(out), back(track)) if with_phasor else back(out)


# ---------------------------------------------------------------------------
# C: causal FIR with one shared kernel (replaces pallas_kernels.fir_conv_causal)
# ---------------------------------------------------------------------------


def _check_fir_shared(x, h):
    if h.ndim != 1 or x.ndim < 1:
        raise ValueError(f"expected x (..., T) and h (L,), got {tuple(x.shape)}, {tuple(h.shape)}")
    if x.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}, {h.dtype}")


def fir_causal_plain(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``y[..., n] = sum_k h[k] x[..., n - k]`` for ``n < T``: a ``conv1d``
    of the left-padded rows against the flipped shared kernel."""
    _check_fir_shared(x, h)
    T = x.shape[-1]
    L = h.shape[0]
    rows = x.reshape(-1, 1, T)
    with strict_fp32():
        y = F.conv1d(F.pad(rows, (L - 1, 0)), h.flip(0)[None, None])
    return y.reshape(x.shape)


def fir_causal(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal FIR of ``(..., T)`` float32 signals with one kernel ``(L,)``,
    ``L <= MAX_TAPS``, truncated to ``T`` samples (``csrc/fir_causal_batch.cu``,
    kernel A's code with the taps shared by every row). Rows that are not
    contiguous (a transposed multichannel meter input) are copied first."""
    if x.device.type == "cpu":
        return fir_causal_plain(x, h)
    _check_fir_shared(x, h)
    x = x.contiguous()
    T = x.shape[-1]
    L = h.shape[0]
    rows = x.numel() // T
    if L > MAX_TAPS:
        raise ValueError(f"fir_causal takes at most {MAX_TAPS} taps, got {L}")
    if rows > 65535:
        raise ValueError(f"fir_causal takes at most 65535 rows, got {rows}")
    y = torch.empty_like(x)
    _launch("fir_causal", (x, h, y), x.data_ptr(), h.data_ptr(), y.data_ptr(), rows, T, L)
    return y


# ---------------------------------------------------------------------------
# D: exclusive complex cumulative product (replaces pallas_kernels.rotation_cumprod)
# ---------------------------------------------------------------------------


def _check_rot(ur, ui, cr, ci):
    if ur.shape != ui.shape or cr.shape != ci.shape or ur.shape[:-1] != cr.shape:
        raise ValueError(
            f"expected u planes (..., n) and seeds (...,), got {tuple(ur.shape)}, "
            f"{tuple(ui.shape)}, {tuple(cr.shape)}, {tuple(ci.shape)}"
        )
    if any(t.dtype != torch.float32 for t in (ur, ui, cr, ci)):
        raise TypeError("expected float32 planes")


def rotation_cumprod_plain(ur, ui, cr, ci):
    """``P[..., 0] = c``, ``P[..., s + 1] = P[..., s] u[..., s]`` as a loop
    over steps, in the kernel's operation order."""
    _check_rot(ur, ui, cr, ci)
    pr, pi = torch.empty_like(ur), torch.empty_like(ui)
    ar, ai = cr, ci
    for s in range(ur.shape[-1]):
        pr[..., s] = ar
        pi[..., s] = ai
        u_r, u_i = ur[..., s], ui[..., s]
        ar, ai = ar * u_r - ai * u_i, ar * u_i + ai * u_r
    return pr, pi


class RotationPlan(NamedTuple):
    """Kernel D's launch: ``rows_per_block`` rows a block (one thread each),
    tiles of ``steps`` steps in a ring of ``stages``, copied 16 bytes at a
    time when ``wide`` (else 4), ``smem`` bytes of ring a block, ``blocks``
    blocks."""
    rows_per_block: int
    steps: int
    stages: int
    wide: bool
    smem: int
    blocks: int


def rotation_plan(rows: int, n: int, aligned: bool = True) -> RotationPlan:
    """Kernel D's launch for ``rows`` rows of ``n`` steps, with the block,
    tile and ring its build takes (``_build.DEFINES``): 16-byte copies when
    every row starts on 16 bytes (``n % 4 == 0`` and ``aligned`` planes),
    into rows of ``steps + 4`` words; 4-byte copies otherwise, into a
    transposed tile of ``rows_per_block + 1`` words a step."""
    geometry = _build.DEFINES["rotation_cumprod"]
    per_block, steps, stages = (geometry[k] for k in ("ROT_ROWS", "ROT_STEPS", "ROT_STAGES"))
    wide = aligned and n % 4 == 0
    words = per_block * (steps + 4) if wide else steps * (per_block + 1)
    smem = stages * 2 * words * 4
    return RotationPlan(per_block, steps, stages, wide, smem, -(-rows // per_block))


def rotation_cumprod(ur, ui, cr, ci):
    """Exclusive cumulative complex product over the last axis of the
    real-pair planes ``(ur, ui)`` ``(..., n)``, seeded with ``(cr, ci)``
    ``(...,)``: ``P[0] = c``, ``P[s + 1] = P[s] u[s]``. Returns ``(Pr, Pi)``
    shaped like ``ur`` (``csrc/rotation_cumprod.cu``). It is kernel B's
    rotation scan without the magnitudes; no path of the library calls it.
    """
    if ur.device.type == "cpu":
        return rotation_cumprod_plain(ur, ui, cr, ci)
    _check_rot(ur, ui, cr, ci)
    n = ur.shape[-1]
    rows = ur.numel() // n if n else 0
    if n < 1 or rows < 1:
        raise ValueError(f"rotation_cumprod needs nonempty planes, got {tuple(ur.shape)}")
    pr, pi = torch.empty_like(ur), torch.empty_like(ui)
    plan = rotation_plan(rows, n, all(t.data_ptr() % 16 == 0 for t in (ur, ui, pr, pi)))
    _launch("rotation_cumprod", (ur, ui, cr, ci, pr, pi), ur.data_ptr(), ui.data_ptr(),
            cr.data_ptr(), ci.data_ptr(), pr.data_ptr(), pi.data_ptr(), rows, n,
            int(plan.wide), plan.smem, plan.blocks)
    return pr, pi


# ---------------------------------------------------------------------------
# E: fused bf16 iSTFT synthesis (replaces pallas_kernels.istft_synthesis_fused)
# ---------------------------------------------------------------------------

# The weights' layout is the kernel's tile (csrc/istft_synthesis.cu): rows
# padded to whole chunks of KC, each shift's column block to whole tiles of
# TN, so that a tile's columns never reach into the next shift's.
_SYN_K_CHUNK = 16  # KC: bf16 contraction values a chunk
_SYN_COLS = 128  # TN: output columns a block


def _syn_layout(n_freq: int, hop: int):
    """``(hop_p, k2)``: the weights' column blocks and rows padded as the
    kernel takes them (zeros in the padding)."""
    return -(-hop // _SYN_COLS) * _SYN_COLS, -(-2 * n_freq // _SYN_K_CHUNK) * _SYN_K_CHUNK


def synthesis_weights(Ci: torch.Tensor, Si: torch.Tensor, hop: int) -> torch.Tensor:
    """Kernel E's weights from the window-fused iDFT matrices ``(n_freq,
    n_fft)``: rows ``2k`` and ``2k + 1`` are ``Ci[k]`` and ``Si[k]`` (the
    order of a complex64 row's re and im), each cut into the ``r = n_fft /
    hop`` hop-wide column blocks padded to a multiple of the block width,
    the rows padded with zeros to the contraction chunk; bf16, rounded to
    nearest even. ``(k2, r * hop_p)``."""
    n_freq, n_fft = Ci.shape
    if n_fft % hop or n_fft // hop > MAX_SYNTHESIS_OVERLAP:
        raise ValueError(f"fused synthesis needs hop | n_fft and n_fft / hop <= "
                         f"{MAX_SYNTHESIS_OVERLAP}, got n_fft {n_fft}, hop {hop}")
    r = n_fft // hop
    hop_p, k2 = _syn_layout(n_freq, hop)
    w = torch.stack([Ci, Si], dim=1).reshape(2 * n_freq, r, hop)
    w = F.pad(w, (0, hop_p - hop)).reshape(2 * n_freq, r * hop_p)
    return F.pad(w, (0, 0, 0, k2 - 2 * n_freq)).to(torch.bfloat16).contiguous()


def _check_syn(spec, w, hop, inv_env, edge):
    if spec.dtype != torch.complex64 or spec.ndim != 3:
        raise TypeError(f"expected complex64 spectra (B, nt, n_freq), got {spec.dtype} "
                        f"{tuple(spec.shape)}")
    B, nt, n_freq = spec.shape
    hop_p, k2 = _syn_layout(n_freq, hop)
    r = w.shape[-1] // hop_p
    if (w.dtype != torch.bfloat16 or w.shape != (k2, r * hop_p)
            or (r * hop) // 2 + 1 != n_freq):
        raise ValueError(f"expected synthesis weights ({k2}, r * {hop_p}) bf16 for {n_freq} "
                         f"bins at hop {hop}, got {w.dtype} {tuple(w.shape)}")
    if edge < 0:
        raise ValueError(f"edge must be >= 0, got {edge}")
    if inv_env.shape != (r * hop + hop * (nt + 2 * edge - 1),):
        raise ValueError(f"envelope of {tuple(inv_env.shape)} for {nt} + 2 x {edge} frames "
                         f"of {r * hop}, hop {hop}")
    return r, hop_p


def istft_synthesis_fused_plain(spec, w, hop: int, inv_env, edge: int = 0):
    """The ``matmul_bf16`` synthesis: spectrum rounded to bf16, times the
    bf16 iDFT matrices that ``w`` holds, summed in fp32, then overlap-add
    and the envelope. ``spec`` ``(B, nt, n_freq)`` complex64, after
    ``edge`` zero frames at each end -> ``(B, out_len)`` float32."""
    from .fft import _bf16, _overlap_add

    r, hop_p = _check_syn(spec, w, hop, inv_env, edge)
    n_freq = spec.shape[-1]
    m = w[: 2 * n_freq].float().reshape(n_freq, 2, r, hop_p)[..., :hop]
    Ci, Si = m[:, 0].reshape(n_freq, r * hop), m[:, 1].reshape(n_freq, r * hop)
    if edge:
        spec = F.pad(spec, (0, 0, edge, edge))
    with strict_fp32():
        frames = _bf16(spec.real) @ Ci + _bf16(spec.imag) @ Si
    return _overlap_add(frames, hop, inv_env.shape[0]) * inv_env


def istft_synthesis_fused(spec, w, hop: int, inv_env, edge: int = 0):
    """Fused iSTFT synthesis (``csrc/istft_synthesis.cu``): the window-fused
    inverse DFT with bf16 operands and fp32 sums, the overlap-add and the
    envelope in one pass, writing each output sample once; the ``(B, nt,
    n_fft)`` frame tensor is never built.

    ``spec``: ``(B, nt, n_freq)`` complex64, read in place when contiguous
    (the phase vocoder's output is); ``w``: :func:`synthesis_weights` of the
    window-fused iDFT matrices at ``hop``, which divides ``n_fft`` into at
    most ``MAX_SYNTHESIS_OVERLAP`` parts; ``edge``: zero frames taken to
    lead and trail the spectrum (read as zeros, not copied); ``inv_env``:
    ``(out_len,)`` reciprocal envelope. Returns ``(B, out_len)`` float32.
    """
    if spec.device.type == "cpu":
        return istft_synthesis_fused_plain(spec, w, hop, inv_env, edge)
    r, hop_p = _check_syn(spec, w, hop, inv_env, edge)
    B, nt, n_freq = spec.shape
    if B > 65535:
        raise ValueError(f"istft_synthesis_fused takes at most 65535 items, got {B}")
    spec = spec.contiguous()
    out = torch.empty((B, inv_env.shape[0]), dtype=torch.float32, device=spec.device)
    _launch("istft_synthesis_fused", (spec, w, inv_env, out), spec.data_ptr(), w.data_ptr(),
            inv_env.data_ptr(), out.data_ptr(), B, nt, edge, n_freq, w.shape[0], r, hop, hop_p,
            nt + 2 * edge + r - 1)
    return out
