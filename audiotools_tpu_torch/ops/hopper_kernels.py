"""Hand-written Hopper kernels, with their plain PyTorch versions
(counterpart of ``audiotools_tpu/ops/pallas_kernels.py``): A, the per-item
causal FIR; B, the fused phase vocoder; C, the causal FIR with one shared
kernel; D, the exclusive complex cumulative product; E, the fused bf16
iSTFT synthesis; F, the blocked IIR's block-state recurrence, which
replaces no Pallas kernel but the JAX package's ``lax.scan`` over block
states; and G, DAC's Snake activation forward and backward, which replaces
no Pallas kernel but a chain of eager elementwise kernels.

Each wrapper runs its plain version for a tensor on the CPU and launches
its CUDA kernel (``csrc/*.cu``, built at first use by ``_build``) for a
tensor on the card; for any other device, or when the kernel cannot be
built, it raises. Kernels A-F have no backward: on the card, a wrapper
given an input that requires grad while grad mode is on raises rather than
return a result cut from the graph (the differentiable vocoder wraps B in
``ops.stretch._FusedPhaseVocoder``); G's forward and backward are one
``torch.autograd.Function`` (``snake``). ``LAUNCHES`` counts the kernel
launches of each wrapper, so a run can show that its main path went
through the kernels. Each wrapper counts, under ``perf.xla_cost``, as its
function's own work (``wrapper.work(*args)``: the flops and bytes its bound
is computed from), whether its kernel or its plain version runs.
"""
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import _build
from ._fp32 import strict_fp32
from .perf import counts_as

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
    "MAX_SCAN_STATES",
    "ScanPlan",
    "scan_plan",
    "iir_block_scan",
    "iir_block_scan_plain",
    "SnakePlan",
    "snake_plan",
    "snake",
    "snake_plain",
    "snake_backward",
    "snake_backward_plain",
]

MAX_TAPS = 8192  # kernel C's limit (the shared-kernel FIR; the meter uses 1023 or 4095)
MAX_TAPS_BATCH = 2048  # kernel A's limit (the equalizer's per-item FIR)
MAX_SYNTHESIS_OVERLAP = 8  # kernel E: at most n_fft / hop overlapping frames
MAX_SCAN_STATES = 16  # kernel F: states of a cascade (2 a biquad; the meter's has 4)

LAUNCHES = {name: 0 for name in (
    "fir_causal_batch", "phase_vocoder_fused", "fir_causal", "rotation_cumprod",
    "istft_synthesis_fused", "iir_block_scan", "snake", "snake_backward",
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
    "iir_block_scan": ("iir_block_scan", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "snake": ("snake", [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "snake_backward": ("snake", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
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


def _refuse_grad(name, *tensors):
    """Raise if autograd would need a backward of kernel ``name``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires grad; call it "
            "under torch.no_grad() or on detached inputs"
        )


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


def _fir_batch_work(x, h):
    """2 flops a tap and output; each row, its output and its taps once."""
    rows, T = x.shape
    L = h.shape[-1]
    return {"flops": 2.0 * rows * T * L, "bytes": 4.0 * rows * (2 * T + L)}


@counts_as(_fir_batch_work)
def fir_causal_batch(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal FIR of ``(rows, T)`` float32 signals with per-row kernels
    ``(rows, L)``, ``L <= MAX_TAPS_BATCH``, truncated to ``T`` samples
    (``csrc/fir_causal_batch.cu``)."""
    if x.device.type == "cpu":
        return fir_causal_batch_plain(x, h)
    _refuse_grad("fir_causal_batch", x, h)
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


def _sqrt(x):
    """Correctly rounded fp32 square root, as the kernel's ``sqrtf`` (and
    XLA's) gives it: the CPU's ``torch.sqrt`` is off by an ulp in ~0.7% of
    fp32 inputs, while the float64 root rounds to the right fp32 value."""
    return torch.sqrt(x.double()).float()


def phase_vocoder_fused_plain(stft_data, i0, i1, frac, with_phasor: bool = False):
    """Phasor phase vocoder as a loop over steps on ``(rows,)`` planes, in
    the kernel's operation order and rounding, so that the kernel on the
    card and this version on either device give the same bits. ``stft_data``
    is ``(..., F, T)`` complex; returns ``(..., F, n_steps)`` complex, plus
    the phasor track ``P`` (same shape) when ``with_phasor``."""
    i0, i1, frac = _check_pv(stft_data, i0, i1, frac)
    *lead, F_bins, T = stft_data.shape
    n_steps = i0.shape[0]
    i0, i1 = i0.tolist(), i1.tolist()
    # time-major (T, rows): each step reads two contiguous rows of frames
    z = stft_data.reshape(-1, T).transpose(0, 1)
    zr, zi = z.real.contiguous(), z.imag.contiguous()

    sr, si = zr[0], zi[0]
    s_mag = _sqrt(sr * sr + si * si)
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
        a0 = _sqrt(z0r * z0r + z0i * z0i)
        a1 = _sqrt(z1r * z1r + z1i * z1i)
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


def _pv_work(stft_data, i0, i1, frac, with_phasor: bool = False):
    """~31 fp32 operations a bin and step (two magnitudes, the interpolated
    magnitude, the rotation, its normalisation, the phasor update); each
    input frame read once, the output (and the track) written once, the
    step tables read once."""
    T = stft_data.shape[-1]
    rows, n = stft_data.numel() // T, len(i0)
    return {"flops": 31.0 * rows * n,
            "bytes": 8.0 * rows * (T + n * (1 + with_phasor)) + 12.0 * n}


@counts_as(_pv_work)
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
    _refuse_grad("phase_vocoder_fused", stft_data)
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


def _fir_work(x, h):
    """2 flops a tap and output; each row and its output once, the shared
    taps once."""
    T = x.shape[-1]
    rows, L = x.numel() // T, h.shape[0]
    return {"flops": 2.0 * rows * T * L, "bytes": 4.0 * (2 * rows * T + L)}


@counts_as(_fir_work)
def fir_causal(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal FIR of ``(..., T)`` float32 signals with one kernel ``(L,)``,
    ``L <= MAX_TAPS``, truncated to ``T`` samples (``csrc/fir_causal_batch.cu``,
    kernel A's code with the taps shared by every row). Rows that are not
    contiguous (a transposed multichannel meter input) are copied first."""
    if x.device.type == "cpu":
        return fir_causal_plain(x, h)
    _refuse_grad("fir_causal", x, h)
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


def _rot_work(ur, ui, cr, ci):
    """6 flops a complex product; the two planes in and out and the seeds
    once."""
    n = ur.shape[-1]
    rows = ur.numel() // n
    return {"flops": 6.0 * rows * n, "bytes": 4.0 * rows * (4 * n + 2)}


@counts_as(_rot_work)
def rotation_cumprod(ur, ui, cr, ci):
    """Exclusive cumulative complex product over the last axis of the
    real-pair planes ``(ur, ui)`` ``(..., n)``, seeded with ``(cr, ci)``
    ``(...,)``: ``P[0] = c``, ``P[s + 1] = P[s] u[s]``. Returns ``(Pr, Pi)``
    shaped like ``ur`` (``csrc/rotation_cumprod.cu``). It is kernel B's
    rotation scan without the magnitudes; no path of the library calls it.
    """
    if ur.device.type == "cpu":
        return rotation_cumprod_plain(ur, ui, cr, ci)
    _refuse_grad("rotation_cumprod", ur, ui, cr, ci)
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


def _syn_work(spec, w, hop: int, inv_env, edge: int = 0):
    """2 flops a product of the frames' re and im parts with the iDFT rows
    (the edge frames are zeros); the spectrum, the weights and the envelope
    read once, the output written once."""
    B, nt, n_freq = spec.shape
    n_fft = (w.shape[-1] // _syn_layout(n_freq, hop)[0]) * hop
    return {"flops": 2.0 * B * nt * 2 * n_freq * n_fft,
            "bytes": 8.0 * spec.numel() + 2.0 * w.numel() + 4.0 * (1 + B) * inv_env.numel()}


@counts_as(_syn_work)
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
    _refuse_grad("istft_synthesis_fused", spec, w, inv_env)
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


# ---------------------------------------------------------------------------
# F: the blocked IIR's block-state recurrence (replaces the lax.scan of
# audiotools_tpu/ops/filters.py::iir_cascade_blocked)
# ---------------------------------------------------------------------------


def _check_scan(u, a_l_t):
    if u.ndim != 3 or a_l_t.shape != (u.shape[-1], u.shape[-1]):
        raise ValueError(f"expected u (rows, n_blk, ns) and (A^L)^T (ns, ns), got "
                         f"{tuple(u.shape)}, {tuple(a_l_t.shape)}")
    if u.dtype not in (torch.float32, torch.float64) or a_l_t.dtype != u.dtype:
        raise TypeError(f"expected float32 or float64 of one type, got {u.dtype}, {a_l_t.dtype}")


def iir_block_scan_plain(u: torch.Tensor, a_l_t: torch.Tensor) -> torch.Tensor:
    """``s_pre[:, 0] = 0``, ``s_pre[:, k + 1] = s_pre[:, k] @ a_l_t + u[:,
    k]`` as a loop of one ``addmm`` a block over block-major planes, in
    strict fp32. Returns ``(rows, n_blk, ns)``, a transposed view of the
    block-major result."""
    _check_scan(u, a_l_t)
    u = u.transpose(0, 1).contiguous()  # (n_blk, rows, ns)
    s_pre = torch.zeros_like(u)
    # s_pre[k + 1] = s_pre[k] A_L^T + u[k], in place
    s_k, u_k = s_pre.unbind(0), u.unbind(0)
    with strict_fp32():
        for k in range(u.shape[0] - 1):
            torch.addmm(u_k[k], s_k[k], a_l_t, out=s_k[k + 1])
    return s_pre.transpose(0, 1)


class ScanPlan(NamedTuple):
    """Kernel F's launch: ``threads`` rows a block (one thread each), each
    step's input fetched ``depth`` steps ahead into a ring in shared memory,
    ``blocks`` blocks."""
    threads: int
    depth: int
    blocks: int


def scan_plan(rows: int, ns: int, itemsize: int) -> ScanPlan:
    """Kernel F's launch for ``rows`` rows of ``ns`` states of ``itemsize``
    bytes, with the geometry its build takes (``_build.DEFINES``): the ring
    holds ``SCAN_RING_BYTES`` a thread, 2 to ``SCAN_DEPTH`` steps."""
    g = _build.DEFINES["iir_block_scan"]
    depth = min(g["SCAN_DEPTH"], max(2, g["SCAN_RING_BYTES"] // (ns * itemsize)))
    return ScanPlan(g["SCAN_THREADS"], depth, -(-rows // g["SCAN_THREADS"]))


def _scan_work(u, a_l_t):
    """``ns`` FMAs a state and step over ``n_blk - 1`` steps; ``u`` and the
    transition read once, ``s_pre`` written once."""
    rows, n_blk, ns = u.shape
    return {"flops": 2.0 * rows * (n_blk - 1) * ns * ns,
            "bytes": float(u.element_size()) * (2 * rows * n_blk * ns + ns * ns)}


@counts_as(_scan_work)
def iir_block_scan(u: torch.Tensor, a_l_t: torch.Tensor) -> torch.Tensor:
    """The state before each block of a blocked IIR, from each block's
    input term ``u`` ``(rows, n_blk, ns)`` and the transposed block
    transition ``a_l_t`` ``(ns, ns)``: ``s_pre[:, 0] = 0``, ``s_pre[:, k +
    1] = s_pre[:, k] @ a_l_t + u[:, k]``, sequential over blocks
    (``csrc/iir_block_scan.cu``). float32 or float64, ``ns <=
    MAX_SCAN_STATES``; ``u`` contiguous, as ``xb @ psi_x_t`` gives it.
    Returns ``(rows, n_blk, ns)`` in the same layout."""
    if u.device.type == "cpu":
        return iir_block_scan_plain(u, a_l_t)
    _refuse_grad("iir_block_scan", u, a_l_t)
    _check_scan(u, a_l_t)
    rows, n_blk, ns = u.shape
    if ns > MAX_SCAN_STATES:
        raise ValueError(f"iir_block_scan takes at most {MAX_SCAN_STATES} states, got {ns}")
    if not (u.is_contiguous() and a_l_t.is_contiguous()):
        raise RuntimeError("iir_block_scan: expected contiguous tensors")
    if u.numel() == 0:  # no rows or no blocks: nothing to launch
        return torch.zeros_like(u)
    if u.data_ptr() % 16:  # the kernel moves whole 16-byte words of a row
        u = u.clone()
    s_pre = torch.empty_like(u)
    plan = scan_plan(rows, ns, u.element_size())
    _launch("iir_block_scan", (u, a_l_t, s_pre), u.data_ptr(), a_l_t.data_ptr(),
            s_pre.data_ptr(), rows, n_blk, ns, u.element_size(), plan.depth, plan.blocks)
    return s_pre


# ---------------------------------------------------------------------------
# G: DAC's Snake activation, forward and backward (replaces no Pallas
# kernel: the eager chain of models/dac.py::snake)
# ---------------------------------------------------------------------------


def snake_plain(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake ``x + sin^2(alpha x) / (alpha + 1e-9)``, as the eager
    expression of the JAX package's ``models/dac.py::snake``, for any dtype,
    device and broadcastable shapes."""
    return x + (1.0 / (alpha + 1e-9)) * torch.sin(alpha * x) ** 2


def snake_backward_plain(x: torch.Tensor, alpha: torch.Tensor, g: torch.Tensor):
    """Kernel G's backward in torch: the gradients of ``snake_plain(x,
    alpha)`` against its output's gradient ``g``, for ``x`` and ``g`` ``(B,
    C, T)`` and ``alpha`` ``(1, C, 1)``. ``gx = g + (((g r) (2 s)) cos(alpha
    x)) alpha`` in eager's own product order, and ``g_alpha = sum g_t x -
    r^2 sum g s^2`` over batch and time, with ``s = sin(alpha x)``, ``r = 1 /
    (alpha + 1e-9)`` and ``g_t`` the product before ``alpha``. Returns
    ``(gx, g_alpha)``, the second shaped as ``alpha``."""
    t = alpha * x
    s = torch.sin(t)
    r = 1.0 / (alpha + 1e-9)
    g_t = g * r * (2.0 * s) * torch.cos(t)
    sums = (g_t * x).sum(dim=(0, 2), keepdim=True), (g * (s * s)).sum(dim=(0, 2), keepdim=True)
    return g + g_t * alpha, (sums[0] - r * r * sums[1]).reshape(alpha.shape)


class SnakePlan(NamedTuple):
    """Kernel G's launch: blocks of ``threads`` threads, a warp to each
    ``segment`` elements of a row, ``n_seg`` warps a row, ``blocks``
    blocks."""
    threads: int
    segment: int
    n_seg: int
    blocks: int


def snake_plan(rows: int, T: int) -> SnakePlan:
    """Kernel G's launch for ``rows`` rows ``(b, c)`` of ``T`` samples, with
    the geometry its build takes (``_build.DEFINES``): a warp's segment is
    32 lanes of ``SNAKE_UNROLL`` 16-byte loads."""
    g = _build.DEFINES["snake"]
    segment = 32 * 4 * g["SNAKE_UNROLL"]
    n_seg = -(-T // segment)
    return SnakePlan(g["SNAKE_THREADS"], segment, n_seg,
                     -(-rows * n_seg // (g["SNAKE_THREADS"] // 32)))


def _check_snake(x, alpha, *more):
    if x.ndim != 3 or alpha.numel() != x.shape[1] or any(t.shape != x.shape for t in more):
        raise ValueError(f"expected x (B, C, T), alpha of C values and gradients shaped as x, "
                         f"got {tuple(x.shape)}, {tuple(alpha.shape)}, "
                         f"{[tuple(t.shape) for t in more]}")
    if any(t.dtype != torch.float32 for t in (x, alpha, *more)):
        raise TypeError(f"expected float32, got {[t.dtype for t in (x, alpha, *more)]}")


class _Snake(torch.autograd.Function):
    """Kernel G under autograd: the forward (contiguous ``x``) saves ``x``
    and ``alpha`` alone, the backward is G's backward pass."""

    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x, alpha)
        B, C, T = x.shape
        y = torch.empty_like(x)
        if x.numel():
            alpha = alpha.reshape(C).contiguous()
            plan = snake_plan(B * C, T)
            _launch("snake", (x, alpha, y), x.data_ptr(), alpha.data_ptr(), y.data_ptr(), B, C,
                    T, plan.n_seg, plan.blocks)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, alpha = ctx.saved_tensors
        return snake_backward(x, alpha, g.contiguous())


def _snake_work(x, alpha):
    """5 operations an element (alpha x, the sine, its square, the scale by
    r, the sum); x read and y written once, alpha read once."""
    return {"flops": 5.0 * x.numel(), "bytes": 4.0 * (2 * x.numel() + alpha.numel())}


def _snake_backward_work(x, alpha, g):
    """13 operations an element (alpha x, its sine and cosine, six products
    and a sum for x's gradient, two products and two sums for alpha's); x
    and g read and x's gradient written once, alpha read and its gradient
    written once, and each warp segment's two partial sums written and read
    once."""
    B, C, T = x.shape
    partials = 2 * B * C * snake_plan(B * C, T).n_seg
    return {"flops": 13.0 * x.numel(),
            "bytes": 4.0 * (3 * x.numel() + 2 * alpha.numel() + 2 * partials)}


@counts_as(_snake_work)
def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake ``x + sin^2(alpha x) / (alpha + 1e-9)`` of float32 ``x`` ``(B,
    C, T)`` with one ``alpha`` a channel (``(1, C, 1)``), differentiable in
    both (``csrc/snake.cu``: one launch forward, one call of two launches
    backward, which needs only ``x`` and ``alpha``). On the card the result
    equals ``snake_plain``'s bit for bit."""
    if x.device.type == "cpu":
        return snake_plain(x, alpha)
    _check_snake(x, alpha)
    return _Snake.apply(x.contiguous(), alpha)


@counts_as(_snake_backward_work)
def snake_backward(x: torch.Tensor, alpha: torch.Tensor, g: torch.Tensor):
    """Kernel G's backward: ``(gx, g_alpha)``, the gradients of ``snake(x,
    alpha)`` for its output's gradient ``g``, as ``snake_backward_plain``
    computes them; ``g_alpha`` is summed over batch and time in a fixed
    order (per-segment fp32 partial sums, then fp64 over segments), so two
    runs give the same bits."""
    if x.device.type == "cpu":
        return snake_backward_plain(x, alpha, g)
    _refuse_grad("snake_backward", x, alpha, g)
    _check_snake(x, alpha, g)
    B, C, T = x.shape
    gx = torch.empty_like(x)
    g_alpha = torch.empty(C, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return gx, g_alpha.zero_().reshape(alpha.shape)
    alpha_c = alpha.reshape(C).contiguous()
    plan = snake_plan(B * C, T)
    partial = torch.empty(2, C, B * plan.n_seg, dtype=torch.float32, device=x.device)
    _launch("snake_backward", (x, alpha_c, g, gx, partial, g_alpha), x.data_ptr(),
            alpha_c.data_ptr(), g.data_ptr(), gx.data_ptr(), partial.data_ptr(),
            g_alpha.data_ptr(), B, C, T, plan.n_seg, plan.blocks)
    return gx, g_alpha.reshape(alpha.shape)
