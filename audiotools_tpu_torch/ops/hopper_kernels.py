"""Hand-written Hopper kernels of the augmentation path, with their plain
PyTorch versions (counterpart of ``audiotools_tpu/ops/pallas_kernels.py``).

Each wrapper runs its plain version for a tensor on the CPU and launches
its CUDA kernel (``csrc/*.cu``, built at first use by ``_build``) for a
tensor on the card; for any other device, or when the kernel cannot be
built, it raises. ``LAUNCHES`` counts the kernel launches of each wrapper,
so a run can show that its main path went through the kernels.
"""
import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ._fp32 import strict_fp32

__all__ = [
    "MAX_TAPS",
    "LAUNCHES",
    "reset_launch_counts",
    "fir_causal_batch",
    "fir_causal_batch_plain",
    "phase_vocoder_fused",
    "phase_vocoder_fused_plain",
]

MAX_TAPS = 2048  # kernel A's shared-memory envelope (the equalizer's limit)

LAUNCHES = {"fir_causal_batch": 0, "phase_vocoder_fused": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (csrc file, argtypes)
    "fir_causal_batch": ("fir_causal_batch", [_P, _P, _P, _I, _I, _I, _P]),
    "phase_vocoder_fused": ("phase_vocoder", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
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
    ``(rows, L)``, ``L <= MAX_TAPS``, truncated to ``T`` samples
    (``csrc/fir_causal_batch.cu``)."""
    if x.device.type == "cpu":
        return fir_causal_batch_plain(x, h)
    _check_fir(x, h)
    rows, T = x.shape
    L = h.shape[-1]
    if L > MAX_TAPS:
        raise ValueError(f"fir_causal_batch takes at most {MAX_TAPS} taps, got {L}")
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
    _launch(
        "phase_vocoder_fused", (z, ti0, ti1, tfrac, out), z.data_ptr(), ti0.data_ptr(), ti1.data_ptr(),
        tfrac.data_ptr(), out.data_ptr(), track.data_ptr() if with_phasor else None,
        items, F_bins, T, n_steps,
    )

    def back(t):
        return t.transpose(1, 2).reshape(*lead, F_bins, n_steps)

    return (back(out), back(track)) if with_phasor else back(out)
