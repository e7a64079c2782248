"""Absolute performance accounting: analytic FLOPs, the dispatched work of a
PyTorch program, MFU and HBM-roofline fractions (counterpart of
``audiotools_tpu/ops/perf.py``).

Two independent accountings:

- **analytic**: closed-form MAC counts for the DAC generator's conv /
  matmul core and the discriminators (all shapes are static), the standard
  "model FLOPs" used for MFU. The integers are the JAX package's.
- **dispatched** (:func:`xla_cost`, the JAX package's name): the products'
  FLOPs and the tensor bytes of every operator that a call of the function
  dispatches, covering what the analytic core excludes (losses, optimizer,
  elementwise work). A kernel wrapper decorated with :func:`counts_as`
  counts as its function's own work, whether its kernel or its plain
  version runs.

Ceilings are the published dense peaks of the NVIDIA H100 SXM5 80GB (HBM3,
700 W power limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3.
MFU is reported against the bf16 peak, also for fp32 and TF32 programs,
which cannot reach it by construction.
"""
import functools
import math
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

PEAK_BF16_FLOPS = 989e12  # H100 SXM5 80GB (HBM3, 700 W), dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM5 80GB, HBM3


def _conv_macs(t_out: int, cin: int, cout: int, k: int) -> int:
    """MACs of a 1-D convolution producing ``t_out`` frames."""
    return t_out * cin * cout * k


def _conv_transpose_macs(t_in: int, cin: int, cout: int, k: int) -> int:
    """MACs of a 1-D transposed convolution: every input frame feeds k
    output taps."""
    return t_in * cin * cout * k


def dac_generator_macs(
    T: int,
    encoder_dim: int = 64,
    encoder_rates=(2, 4, 8, 8),
    latent_dim: int = 256,
    decoder_dim: int = 1024,
    n_codebooks: int = 9,
    codebook_size: int = 1024,
    codebook_dim: int = 8,
) -> Dict[str, int]:
    """Per-item forward MACs of the DAC generator (``models/dac.py``), by
    section. Every Conv / ConvTranspose / Dense / codebook-similarity
    matmul is counted; snakes, norms and the argmax are elementwise work and
    excluded (standard MFU convention)."""
    sections = {"encoder": 0, "rvq": 0, "decoder": 0}

    # ---- encoder ----
    t, d = T, encoder_dim
    sections["encoder"] += _conv_macs(t, 1, d, 7)  # stem
    for stride in encoder_rates:
        # EncoderBlock(2d, stride): 3 ResidualUnits at d, then a
        # d -> 2d strided conv with kernel 2*stride
        for _dilation in (1, 3, 9):
            sections["encoder"] += _conv_macs(t, d, d, 7)  # dilated conv
            sections["encoder"] += _conv_macs(t, d, d, 1)  # pointwise
        t //= stride
        sections["encoder"] += _conv_macs(t, d, 2 * d, 2 * stride)
        d *= 2
    sections["encoder"] += _conv_macs(t, d, latent_dim, 3)  # latent proj

    # ---- residual VQ (per stage: in_proj, similarity matmul, out_proj) ----
    for _ in range(n_codebooks):
        sections["rvq"] += t * latent_dim * codebook_dim  # in_proj
        sections["rvq"] += t * codebook_dim * codebook_size  # similarity
        sections["rvq"] += t * codebook_dim * latent_dim  # out_proj

    # ---- decoder ----
    d = decoder_dim
    sections["decoder"] += _conv_macs(t, latent_dim, d, 7)  # stem
    for stride in reversed(encoder_rates):
        # DecoderBlock(d/2, stride): ConvTranspose d -> d/2 kernel
        # 2*stride, then 3 ResidualUnits at d/2
        sections["decoder"] += _conv_transpose_macs(t, d, d // 2, 2 * stride)
        t *= stride
        d //= 2
        for _dilation in (1, 3, 9):
            sections["decoder"] += _conv_macs(t, d, d, 7)
            sections["decoder"] += _conv_macs(t, d, d, 1)
    sections["decoder"] += _conv_macs(t, d, 1, 7)  # waveform head

    return sections


def dac_train_step_flops(batch: int, T: int, **kwargs) -> float:
    """Analytic model-FLOPs of one reconstruction training step:
    2 FLOPs/MAC forward, and backward = 2x forward (input-grad + weight-
    grad convolutions each cost one forward) -> 3x forward total
    (the standard training-MFU convention)."""
    macs = sum(dac_generator_macs(T, **kwargs).values())
    return 3 * 2 * macs * batch


def mpd_macs(T: int, periods=(2, 3, 5, 7, 11),
             channels=(32, 128, 512, 1024)) -> int:
    """Per-item forward MACs of the multi-period discriminator
    (``models/discriminators.py::PeriodDiscriminator``): per period p, the
    signal folds to a (T/p, p) plane judged by 5x1 convs at stride 3x1
    through ``channels``, then a stride-1 5x1 conv and a 3x1 logit head.
    The period axis has kernel 1, so it scales MACs like a batch dim."""
    total = 0
    for p in periods:
        t = -(-T // p)  # fold length (padded up)
        cin = 1
        for ch in channels:
            t = -(-t // 3)  # SAME padding, stride 3
            total += t * p * cin * ch * 5
            cin = ch
        total += t * p * cin * cin * 5  # stride-1 tail conv
        total += t * p * cin * 1 * 3  # logit head
    return total


def mrd_macs(T: int, fft_sizes=(2048, 1024, 512), channels: int = 32,
             n_bands: int = 5) -> int:
    """Per-item forward MACs of the multi-resolution discriminator
    (``models/discriminators.py::BandSpectrogramDiscriminator``): per window
    n, a complex STFT (counted at the FFT convention 5*N*log2(N) per
    transform) feeds five frequency bands; each band runs a 3x9 stem
    (2->ch) plus three 3x9 convs at freq-stride 2 (ch->ch) and a 3x3 conv,
    then the re-joined bands hit a 3x3 logit head. The summed band widths
    at each conv level are taken as F, F/2, F/4, F/8, which approximates
    the real bands (the JAX package's convention)."""
    total = 0
    for n in fft_sizes:
        hop = n // 4
        frames = T // hop + 1
        f_bins = n // 2 + 1
        total += int(frames * 5 * n * math.log2(n)) // 2  # rfft
        # per conv level, the summed band widths are F, F/2, F/4, F/8
        total += frames * f_bins * 2 * channels * 27  # stems
        for level in (1, 2, 3):
            total += (
                frames * (f_bins >> level) * channels * channels * 27
            ) * 1
        total += frames * (f_bins >> 3) * channels * channels * 9  # 3x3
        total += frames * (f_bins >> 3) * channels * 1 * 9  # logit head
    return total


def adversarial_train_step_flops(batch: int, T: int) -> float:
    """Analytic FLOPs of the two-optimizer adversarial step
    (``models/adversarial.py``): the generator runs fwd+bwd once (3x fwd);
    the discriminator ensemble runs D(fake)+D(real) forward in the G
    loss plus an input-gradient pass through D(fake) (~3x fwd), and
    D(real)+D(fake) fwd+bwd in the D loss (~6x fwd)."""
    g = sum(dac_generator_macs(T).values())
    d = mpd_macs(T) + mrd_macs(T)
    return 2 * batch * (3 * g + 9 * d)


# ---------------------------------------------------------------------------
# dispatched work
# ---------------------------------------------------------------------------

# shape queries, which move no data (torch.utils.flop_counter skips them too)
_QUERIES = {getattr(torch.ops.aten, name).default for name in (
    "is_contiguous", "is_strides_like_format", "is_non_overlapping_and_dense", "size",
    "sym_size", "stride", "sym_stride", "storage_offset", "sym_storage_offset", "numel",
    "sym_numel", "dim")} | {torch.ops.prim.layout.default, torch.ops.prim.device.default}
# allocations that write nothing, and the view of a fresh result
_NO_DATA = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
            torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
            torch.ops.aten._unsafe_view}


def _is_view(func) -> bool:
    """An operator whose result aliases an input without writing it."""
    returns = func._schema.returns
    return bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                 for r in returns)


def _tensor_bytes(t) -> int:
    """Bytes of the elements a tensor covers: its logical elements, or its
    strided span where that is smaller (a broadcast view reads each stored
    element once)."""
    n = t.numel()
    if n == 0:
        return 0
    span = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()))
    return min(n, span) * t.element_size()


class _Counts(TorchDispatchMode):
    """FLOPs of the products (``torch.utils.flop_counter``'s formulas: mm,
    addmm, bmm, convolutions and their backwards) and bytes of every
    dispatched operator, each tensor input read once and each output
    written once; views and allocations count nothing."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.opaque = 0  # > 0 inside a function counted as its own work

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES or self.opaque:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry:
            # a composite operator counts as what it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet not in _NO_DATA and not _is_view(func):
            read = [a for k, a in kwargs.items() if k != "out"]
            self.bytes += sum(_tensor_bytes(t) for t in tree_leaves((args, read))
                              if isinstance(t, torch.Tensor))
            self.bytes += sum(_tensor_bytes(t) for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
        return out


def _active_count():
    """The innermost count of :func:`xla_cost` on this thread's mode stack."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _Counts):
            return mode
    return None


def counts_as(work):
    """Decorator of a kernel wrapper: under :func:`xla_cost`, a call counts
    as ``work(*args, **kwargs)`` (``{"flops", "bytes"}``, the function's own
    work), whether its kernel or its plain version runs, and nothing that it
    dispatches is counted again. The decorated function keeps ``work`` as
    its ``work`` attribute."""

    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            counter = _active_count()
            if counter is None:
                return fn(*args, **kwargs)
            counter.opaque += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                counter.opaque -= 1
            if not counter.opaque:
                own = work(*args, **kwargs)
                counter.flops += own["flops"]
                counter.bytes += own["bytes"]
            return out

        counted.work = work
        return counted

    return wrap


def xla_cost(fn, *args) -> Dict[str, float]:
    """FLOPs and bytes of one call of ``fn(*args)``, counted as it runs
    (the JAX package's name; there it is XLA's cost model of the compiled
    program). The FLOPs are the products' (mm, addmm, bmm, convolutions and
    their backwards, at ``torch.utils.flop_counter``'s formulas); the bytes
    are every dispatched operator's tensor inputs and outputs, each once,
    with views and allocations counting nothing. That is eager PyTorch's
    real traffic, larger than XLA's post-fusion count for an elementwise
    chain. A kernel wrapper counts as its function's own work
    (:func:`counts_as`). ``fn`` runs once, on its arguments' device; an
    error raises (the JAX version returned zeros)."""
    with _Counts() as counter:
        fn(*args)
    return {"flops": float(counter.flops), "bytes": float(counter.bytes)}


def mfu(flops: float, seconds: float) -> float:
    """Fraction of the H100's dense bf16 peak achieved."""
    return flops / seconds / PEAK_BF16_FLOPS


def hbm_roofline_frac(bytes_accessed: float, seconds: float) -> float:
    """Fraction of the H100's HBM3 bandwidth ceiling achieved."""
    return bytes_accessed / seconds / HBM_BYTES_PER_S


def summarize(label: str, seconds: float, analytic_flops: float = None,
              cost: Dict[str, Any] = None) -> Dict[str, float]:
    """Roofline summary dict for a bench line."""
    out = {}
    if analytic_flops:
        out["mfu"] = round(mfu(analytic_flops, seconds), 4)
    if cost and cost.get("flops"):
        out["mfu_xla"] = round(mfu(cost["flops"], seconds), 4)
    if cost and cost.get("bytes"):
        out["hbm_frac"] = round(hbm_roofline_frac(cost["bytes"], seconds), 4)
    return out


def stage_roofline(name: str, fn, arg, iters: int = 5) -> Dict[str, Any]:
    """Roofline position of ONE pipeline stage: its measured time
    (:func:`~audiotools_tpu_torch.ops.benchmark.device_time`), the bytes
    and FLOPs it dispatches (:func:`xla_cost`), and the resulting HBM and
    tensor-core fractions. Localizes a chain's headroom to the stage that
    owns it."""
    from .benchmark import device_time

    t = device_time(fn, arg, iters=iters)
    cost = xla_cost(fn, arg)
    return {
        "stage": name,
        "ms": round(t * 1e3, 2),
        "gbytes": round(cost["bytes"] / 1e9, 3),
        "hbm_frac": round(hbm_roofline_frac(cost["bytes"], t), 3)
        if cost["bytes"]
        else 0.0,
        "gflops": round(cost["flops"] / 1e9, 1),
        "mfu_xla": round(mfu(cost["flops"], t), 4) if cost["flops"] else 0.0,
    }
