"""Time-axis (sequence-parallel) sharded DSP with halo exchange.

Counterpart of ``audiotools_tpu/parallel/timeshard.py``. For signals too long
for one device, the time axis is sharded over a mesh dimension, one process
per device (``torch.distributed``), and filter overlap crosses shard edges by
a *halo exchange*: each shard sends the tail of its block to its right
neighbour (or its head to the left one) and the first and last shards
receive zeros. BS.1770's two gates sum over the mesh with one
``all_reduce`` each.

Inputs and outputs are ``DTensor``s sharded along time (``Shard(-1)``) on
the mesh dimension ``axis_name`` and replicated on any other, the global
shapes of the JAX package's API; frames and spectra are sharded along the
frame axis. Each op works on its shard (``to_local``) with the port's
single-device functions (``ops.filters.causal_fft_conv1d``, ``ops.fft``'s
window and DFT designs and overlap-add, ``ops.resample``'s polyphase
convolution, ``ops.loudness``'s exact FIR), so a sharded op equals the local
op inside the port. :func:`ppermute` is the one place where halos move: it
sends and receives through the process group the caller built (``gloo`` on
the CPU, ``nccl`` across cards) and fails when the backend cannot carry
them. Gradients flow through it (its backward sends them back the other
way) and through ``all_reduce``.

Primitives
----------
* ``sharded_fir_conv`` - causal FIR filtering of a time-sharded signal.
* ``sharded_resample`` - polyphase resampling with a two-sided halo.
* ``sharded_frames`` - frame extraction, each shard's trailing window
  overlap from its right neighbour.
* ``sharded_stft`` / ``sharded_istft`` - the STFT round trip, equal to
  ``ops.fft.stft`` / ``istft`` on the valid frame range.
* ``sharded_loudness`` - the BS.1770-4 meter (K-weighting, absolute and
  relative gates) over sharded time.
"""
import functools
import math
from collections import namedtuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..ops import fft as _fft
from ..ops._fp32 import strict_fp32
from ..ops.filters import causal_fft_conv1d
from ..ops.loudness import CHANNEL_GAINS, _exact_fir
from ..ops.resample import polyphase_conv_diff, resample_kernels

__all__ = [
    "ppermute",
    "sharded_fir_conv",
    "sharded_frames",
    "sharded_resample",
    "sharded_stft",
    "sharded_istft",
    "sharded_loudness",
]

_Axis = namedtuple("_Axis", ["group", "index", "size"])


def _axis(mesh, axis_name: str) -> _Axis:
    """The process group of ``mesh[axis_name]``, this rank's shard index
    along it and the shard count."""
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"the mesh has no dimension {axis_name!r} (it has {names})")
    i = names.index(axis_name)
    return _Axis(mesh.get_group(i), mesh.get_local_rank(i), mesh.size(i))


def _placements(mesh, axis_name: str, dim: int):
    return tuple(Shard(dim) if name == axis_name else Replicate()
                 for name in mesh.mesh_dim_names)


def _local(x, mesh, axis_name: str, dim: int = -1):
    """The shard of ``x``, a DTensor sharded along ``dim`` over
    ``mesh[axis_name]`` and replicated on the mesh's other dimensions, and
    the axis it is sharded over."""
    if not isinstance(x, DTensor):
        raise TypeError(
            f"expected a DTensor sharded along dim {dim} over mesh dimension {axis_name!r} "
            f"(parallel.shard_signal, or DTensor.from_local), got {type(x).__name__}")
    ax = _axis(mesh, axis_name)
    if x.device_mesh != mesh:
        raise ValueError("the DTensor lives on another mesh")
    dim %= x.ndim
    if tuple(x.placements) != _placements(mesh, axis_name, dim):
        raise ValueError(f"expected placements {_placements(mesh, axis_name, dim)} "
                         f"(dim {dim} sharded over {axis_name!r}), got {tuple(x.placements)}")
    return x.to_local(), ax


def _wrap(local: torch.Tensor, mesh, axis_name: str, dim: int = -1) -> DTensor:
    """Even shards, one a rank, as a DTensor sharded along ``dim``."""
    return DTensor.from_local(local, mesh, _placements(mesh, axis_name, dim % local.ndim),
                              run_check=False)


def _exchange(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the shard ``step`` places along the group, receive from
    the shard ``-step`` places; a shard with no such neighbour receives
    zeros. Every shard of the group calls it with the same shapes."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if 0 <= rank + step < n:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, rank + step), group))
    if 0 <= rank - step < n:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, rank - step), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _exchange(x, group, step)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, -ctx.step), None, None


class _AllReduce(torch.autograd.Function):
    """The sum over ``group`` of every shard's ``x``; the gradient of each
    shard's input is the sum of every shard's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def ppermute(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """The non-cyclic neighbour exchange, the only place where halos move:
    each shard of ``group`` sends ``x`` (its local tensor) to the shard
    ``step`` places to its right (``-1``: to its left) and returns what the
    shard ``step`` places to its left sent, zeros at the end of the line.
    The backend is the group's own, and one that cannot carry ``x`` fails
    (``gloo`` with card tensors: its TCP transport cannot read device
    memory); nothing is staged through the host. Differentiable: the
    backward sends the gradient back."""
    return _PPermute.apply(x, group, step)


def _halo_from_left(block: torch.Tensor, halo: int, group) -> torch.Tensor:
    """The last ``halo`` samples of the left neighbour's shard (zeros on the
    first shard). ``block``: ``(..., T_shard)``."""
    return ppermute(block[..., block.shape[-1] - halo:], group, 1)


def _halo_from_right(block: torch.Tensor, halo: int, group) -> torch.Tensor:
    """The first ``halo`` samples of the right neighbour's shard (zeros on
    the last shard)."""
    return ppermute(block[..., :halo], group, -1)


def _check_history(K: int, T: int, n: int):
    if T % n:
        raise ValueError(f"T={T} must divide over {n} shards")
    if K - 1 > T // n:
        # the kernel history may only reach the immediate left neighbour
        raise ValueError(
            f"kernel history K-1={K - 1} must fit in one shard "
            f"(T_shard={T // n}); use fewer shards or a shorter kernel")


def _fir_local(block: torch.Tensor, kernel: torch.Tensor, ax: _Axis) -> torch.Tensor:
    K = kernel.shape[-1]
    ext = torch.cat([_halo_from_left(block, K - 1, ax.group), block], dim=-1)
    return causal_fft_conv1d(ext, kernel)[..., K - 1:]


def sharded_fir_conv(x: DTensor, kernel, mesh, axis_name: str = "sp") -> DTensor:
    """Causal FIR conv of ``(B, C, T)`` audio sharded along T over
    ``axis_name``. The kernel's history crosses shard boundaries through one
    halo exchange; each shard then runs an ordinary local conv."""
    block, ax = _local(x, mesh, axis_name)
    kernel = torch.as_tensor(kernel, dtype=torch.float32).to(block.device)
    K = kernel.shape[-1]
    if K == 1:
        # a pure gain: the halo would be empty
        return _wrap(block * kernel[..., 0], mesh, axis_name)
    _check_history(K, x.shape[-1], ax.size)
    return _wrap(_fir_local(block, kernel, ax), mesh, axis_name)


def sharded_resample(x: DTensor, old_sr: int, new_sr: int, mesh, axis_name: str = "sp",
                     zeros: int = 24, rolloff: float = 0.945) -> DTensor:
    """Polyphase resampling of ``(..., T)`` audio sharded along T.

    Equals ``ops.resample.resample`` on the whole signal: each shard
    convolves locally after a two-sided halo exchange (``width`` samples
    from the left neighbour, ``width + old`` from the right), the global
    edge-replicate padding realized on the first and last shards. Each
    shard's length must be a multiple of the reduced ``old`` rate, so every
    shard starts on the same polyphase phase and yields ``T_shard * new /
    old`` samples.
    """
    if old_sr == new_sr:
        return x
    gcd = math.gcd(int(old_sr), int(new_sr))
    old, new = int(old_sr) // gcd, int(new_sr) // gcd
    block, ax = _local(x, mesh, axis_name)
    T = x.shape[-1]
    if T % ax.size:
        raise ValueError(f"T={T} must divide over {ax.size} shards")
    T_shard = T // ax.size
    if T_shard % old:
        raise ValueError(
            f"shard length {T_shard} must be a multiple of the reduced "
            f"old rate {old} so all shards share the polyphase phase")
    _, width = resample_kernels(old, new, zeros, rolloff)
    if width + old > T_shard:
        raise ValueError(
            f"polyphase halo width+old={width + old} must fit in one "
            f"shard (T_shard={T_shard}); use fewer shards")

    flat = block.reshape(-1, T_shard).float()
    left = _halo_from_left(flat, width, ax.group)
    if ax.index == 0:  # the global edge: replicate the first sample
        left = flat[:, :1].expand(-1, width)
    right = _halo_from_right(flat, width + old, ax.group)
    if ax.index == ax.size - 1:  # and the last
        right = flat[:, -1:].expand(-1, width + old)
    xx = torch.cat([left, flat, right], dim=-1)
    y = polyphase_conv_diff(old, new, int(zeros), float(rolloff), xx.shape[-1],
                            T_shard * new // old)(xx)
    return _wrap(y.reshape(block.shape[:-1] + (y.shape[-1],)), mesh, axis_name)


def _frame_mask(ax: _Axis, nf_local: int, n_valid: int, device) -> torch.Tensor:
    """``(nf_local,)``: which of this shard's frames lie in the global first
    ``n_valid``."""
    return ax.index * nf_local + torch.arange(nf_local, device=device) < n_valid


def sharded_frames(x: DTensor, frame_length: int, hop_length: int, mesh,
                   axis_name: str = "sp"):
    """Frame ``(..., T)`` audio sharded along T into ``(..., n_frames,
    frame_length)`` frames sharded along the frame axis.

    Returns ``(frames, n_valid)``. Each shard makes ``T_shard // hop_length``
    frames; the first ``n_valid = 1 + (T - frame_length) // hop_length``
    equal single-device framing (the overlap crossing each shard boundary
    arrives from the right neighbour) and frames past ``n_valid``, windows
    that would read past the end of the signal, are zeros.
    """
    block, ax = _local(x, mesh, axis_name)
    T = x.shape[-1]
    T_shard = T // ax.size
    if T_shard * ax.size != T:
        raise ValueError("time axis must divide evenly over shards")
    if T_shard % hop_length:
        raise ValueError("shard length must divide into hops")
    overlap = frame_length - hop_length
    if not 0 <= overlap <= T_shard:
        raise ValueError("frame overlap must fit in one shard")
    n_valid = 1 + (T - frame_length) // hop_length
    nf_local = T_shard // hop_length

    ext = torch.cat([block, _halo_from_right(block, overlap, ax.group)], dim=-1)
    frames = ext.unfold(-1, frame_length, hop_length)
    frames = frames.masked_fill(~_frame_mask(ax, nf_local, n_valid, block.device)[:, None], 0.0)
    return _wrap(frames, mesh, axis_name, dim=-2), n_valid


def _stft_geometry(T, n_dev, window_length, hop_length):
    """Shared shard geometry of sharded_stft/istft (``torch.stft``'s
    ``center=True``: a reflect pad of ``cpad = win // 2``, frames at every
    hop of the padded signal, ``1 + T // hop`` in all)."""
    cpad = window_length // 2
    # odd windows reflect-pad win - 1 samples, so every frame count below
    # would report one frame too many as valid
    if window_length % 2:
        raise ValueError("window_length must be even")
    T_shard = T // n_dev
    if T_shard * n_dev != T:
        raise ValueError("time axis must divide evenly over shards")
    if T_shard % hop_length:
        raise ValueError("shard length must divide into hops")
    if cpad % hop_length:
        raise ValueError("window//2 must be a hop multiple (true for hop = win/2 or win/4)")
    if T_shard < window_length:
        raise ValueError("shards must be at least one window")
    nf_local = T_shard // hop_length + 1
    n_valid = T // hop_length + 1
    # right halo: the last frame of shard d starts (in original coords) at
    # d*(T_shard + hop) + T_shard - cpad and extends `window_length`
    right = (n_dev - 1) * hop_length + window_length - cpad
    if right > T_shard:
        raise ValueError("mesh too wide for this shard length")
    # the inverse's last shard ends cpad - n_dev*hop samples short of its
    # output without it
    if n_dev * hop_length < cpad:
        raise ValueError("mesh too narrow for center padding")
    return cpad, T_shard, nf_local, n_valid, right


def _check_method(method: str):
    if method not in _fft._STFT_METHODS:
        raise ValueError(f"method must be 'fft', 'matmul' or 'matmul_bf16', got {method!r}")


def sharded_stft(x: DTensor, window_length: int, hop_length: int, mesh,
                 window_type: str = "hann", axis_name: str = "sp", method: str = "fft"):
    """STFT of ``(..., T)`` audio sharded along T, frames sharded over
    ``axis_name``.

    Equals ``ops.fft.stft`` (``match_stride=False``, reflect center padding)
    on the first ``n_valid`` frames; each shard makes ``T_shard // hop + 1``
    frames and the globally trailing ``n_dev - 1`` surplus frames are zeros.
    The center reflect pad is made on the edge shards and the window overlap
    crosses shards by halos. ``method``: ``"fft"``, ``"matmul"`` (fp32
    window-fused DFT matrices) or ``"matmul_bf16"`` (frames and matrices
    rounded to bf16, summed in fp32).

    Returns ``(spec, n_valid)``, ``spec`` complex64 ``(..., n_freq, n_dev *
    nf_local)`` sharded along the frame axis.
    """
    _check_method(method)
    block, ax = _local(x, mesh, axis_name)
    cpad, T_shard, nf_local, n_valid, right = _stft_geometry(
        x.shape[-1], ax.size, window_length, hop_length)
    b = block.reshape(-1, T_shard)
    left = _halo_from_left(b, cpad, ax.group)
    if ax.index == 0:  # own reflected head
        left = b[:, 1:cpad + 1].flip(-1)
    rightx = _halo_from_right(b, right, ax.group)
    if ax.index == ax.size - 1:  # own reflected tail, then zeros
        tail = b[:, -cpad - 1:-1].flip(-1)
        rightx = F.pad(tail, (0, right - cpad)) if right > cpad else tail[:, :right]
    ext = torch.cat([left, b, rightx], dim=-1)
    seg = ext[:, ax.index * hop_length: ax.index * hop_length + T_shard + window_length]
    frames = seg.unfold(-1, window_length, hop_length)  # (B, nf_local, win)
    frames = frames.masked_fill(
        ~_frame_mask(ax, nf_local, n_valid, b.device)[:, None], 0.0)
    spec = _fft._analysis(frames, window_type, method).transpose(-1, -2)  # (B, n_freq, nf_local)
    return _wrap(spec.reshape(block.shape[:-1] + spec.shape[1:]), mesh, axis_name), n_valid


@functools.lru_cache(maxsize=16)
def _window_square(window_type: str, window_length: int):
    window = _fft.get_window(window_type, window_length)
    return ((window * window).astype("float32"),)


def sharded_istft(spec: DTensor, window_length: int, hop_length: int, mesh,
                  window_type: str = "hann", axis_name: str = "sp", method: str = "fft",
                  n_valid: int = None) -> DTensor:
    """Inverse of :func:`sharded_stft`: ``(..., n_freq, nf)`` frames sharded
    over ``axis_name`` back to ``(..., T)`` audio sharded along T.

    Windowed overlap-add with window-square normalization (``torch.istft``
    semantics). The overlap-add crossing shard boundaries and the re-shard
    from the frame grid to even sample shards each ride halo exchanges; the
    normalization envelope is summed per shard from the same validity-masked
    frames, so the edges equal the single-device path. ``n_valid`` (the
    count :func:`sharded_stft` returned) defaults to ``T // hop + 1``.
    """
    _check_method(method)
    block, ax = _local(spec, mesh, axis_name)
    n_freq, nf = spec.shape[-2], spec.shape[-1]
    nf_local = nf // ax.size
    if nf_local * ax.size != nf:
        raise ValueError("frames must divide evenly over shards")
    T_shard = (nf_local - 1) * hop_length
    T = T_shard * ax.size
    if n_valid is None:
        n_valid = T // hop_length + 1
    cpad = _stft_geometry(T, ax.size, window_length, hop_length)[0]

    S = block.reshape(-1, n_freq, nf_local).transpose(-1, -2)  # (B, nf_local, n_freq)
    B = S.shape[0]
    if method == "fft":
        (window,) = _fft._on_device(_fft._window_design, (window_type, window_length), S.device)
        frames = torch.fft.irfft(S, n=window_length, dim=-1) * window
    else:
        Ci, Si = _fft._on_device(_fft._idft_matrices, (window_type, window_length), S.device)
        re, im = S.real, S.imag
        if method == "matmul_bf16":
            re, im, Ci, Si = map(_fft._bf16, (re, im, Ci, Si))
        with strict_fp32():
            frames = re @ Ci + im @ Si
    mask = _frame_mask(ax, nf_local, n_valid, S.device).to(frames.dtype)[:, None]
    (wsq,) = _fft._on_device(_window_square, (window_type, window_length), S.device)
    # the window-square envelope rides as one more row, so the overlap-add
    # and the first exchange run once
    stacked = torch.cat([frames * mask, (wsq * mask)[None]], dim=0)  # (B + 1, nf, win)
    buf = _fft._overlap_add(stacked, hop_length, T_shard + window_length)

    # exchange 1: shard d's buffer spans padded coords [d (Ts + hop), d (Ts +
    # hop) + Ts + win); its first Ts + hop samples are its own, the tail
    # overlaps the next shard's
    olap = window_length - hop_length
    canon, tail = buf[:, :T_shard + hop_length], buf[:, T_shard + hop_length:]
    recv = ppermute(tail, ax.group, 1)
    canon = torch.cat([canon[:, :olap] + recv, canon[:, olap:]], dim=-1)
    norm = canon[B]
    y = canon[:B] / torch.where(norm > 1e-11, norm, 1.0)

    # exchange 2: re-shard from the frame grid to even sample shards. Shard
    # d's output is padded coords [cpad + d Ts, cpad + (d + 1) Ts), offset
    # cpad - d hop into its own samples: it can reach into the left
    # neighbour's tail or the right neighbour's head
    H_l = max(0, (ax.size - 1) * hop_length - cpad)
    H_r = max(0, cpad - hop_length)
    parts = [y]
    if H_l > 0:
        parts.insert(0, ppermute(y[:, y.shape[-1] - H_l:], ax.group, 1))
    if H_r > 0:
        parts.append(ppermute(y[:, :H_r], ax.group, -1))
    start = H_l + cpad - ax.index * hop_length
    out = torch.cat(parts, dim=-1)[:, start:start + T_shard]
    return _wrap(out.reshape(block.shape[:-2] + (T_shard,)), mesh, axis_name)


@functools.lru_cache(maxsize=16)
def _exact_fir_on(rate: int, filter_class: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_exact_fir(rate, filter_class)).to(device)


def sharded_loudness(x: DTensor, rate: int, mesh, axis_name: str = "sp",
                     filter_class: str = "K-weighting", block_size: float = 0.400) -> DTensor:
    """BS.1770-4 integrated loudness of ``(B, C, T)`` audio sharded along T:
    K-weighting by the halo FIR conv with the cascade's exact impulse
    response, then both gates (absolute at -70 LKFS, relative at the
    ungated mean - 10) with one ``all_reduce`` over the mesh each. Returns
    ``(B,)`` LUFS as a DTensor replicated over the mesh, equal to the
    single-device meter for signals that never fit on one device."""
    block, ax = _local(x, mesh, axis_name)
    B, C, T = x.shape
    T_shard = T // ax.size
    if T_shard * ax.size != T:
        raise ValueError("time axis must divide evenly over shards")
    kn = int(block_size * rate)
    stride = int(block_size * rate * 0.25)
    if T < kn:
        raise ValueError("signal shorter than one gating block")
    if T_shard % stride:
        raise ValueError("shard length must divide into strides")
    if kn - stride > T_shard:
        raise ValueError("gating block overlap must fit one shard")
    kernel = _exact_fir_on(int(rate), filter_class, block.device)
    _check_history(kernel.shape[-1], T, ax.size)

    filtered = _fir_local(block.float(), kernel, ax)
    ext = torch.cat([filtered, _halo_from_right(filtered, kn - stride, ax.group)], dim=-1)
    nf_local = T_shard // stride
    if kn == 4 * stride:
        # a block is four strides: sums of non-overlapping partial sums, as
        # the single-device meter takes them
        s = (ext * ext).reshape(B, C, nf_local + 3, stride).sum(-1)
        z = (s[..., 0:nf_local] + s[..., 1:nf_local + 1] + s[..., 2:nf_local + 2]
             + s[..., 3:nf_local + 3]) / (block_size * rate)
    else:
        frames = ext.unfold(-1, kn, stride)[..., :nf_local, :]
        z = (frames * frames).sum(-1) / (block_size * rate)
    G = torch.from_numpy(CHANNEL_GAINS[:C]).to(z.device)
    l = -0.691 + 10.0 * torch.log10(torch.clamp((G[:, None] * z).sum(1), min=1e-38))
    n_valid = math.ceil((T - kn) / stride) + 1
    valid = _frame_mask(ax, nf_local, n_valid, z.device)[None, :]

    def gated_mean(keep):
        """Mean of ``z`` over the kept blocks of every shard, ``(B, C)``."""
        sums = torch.cat([torch.where(keep[:, None, :], z, 0.0).sum(-1),
                          keep.sum(-1, keepdim=True).to(z.dtype)], dim=-1)
        sums = _AllReduce.apply(sums, ax.group)
        return sums[:, :C] / sums[:, C:]

    above_abs = (l > -70.0) & valid  # absolute gate (eqs. 5-6)
    gamma_r = -0.691 + 10.0 * torch.log10((gated_mean(above_abs) * G).sum(-1)) - 10.0
    above_both = above_abs & (l > gamma_r[:, None])  # relative gate (eq. 7)
    z_avg = torch.nan_to_num(gated_mean(above_both), nan=0.0,
                             posinf=torch.finfo(torch.float32).max,
                             neginf=torch.finfo(torch.float32).min)
    lufs = (-0.691 + 10.0 * torch.log10((G * z_avg).sum(-1))).float()
    return DTensor.from_local(lufs, mesh, [Replicate()] * mesh.ndim, run_check=False)
