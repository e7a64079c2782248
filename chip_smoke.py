"""Each of the port's CUDA kernels alone on one card: the kernel table.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``audiotools_tpu_torch/csrc`` and
runs, on card 0:

1. the device, its name and power limit (``nvidia-smi``), and the kernel
   build (one nvcc per source, all at once, with ptxas's registers and
   spills);
2. kernel A (per-item causal FIR) at the equalizers' shapes (64 rows of 5 s
   or 1 s at 44.1 kHz; 641 or 231 taps) and at the multitrack EQs' (64 rows
   of 5 s time-stretched by 1.25 and 0.8);
3. kernel B (fused phase vocoder) at the pitch shift's shape (64 x 1 x
   1025 bins, 384 frames -> 432 steps), read in place from a time-major
   spectrum as the chains give it, without the phasor track (the chains'
   launch, which the kernel table reports) and with it (the differentiable
   vocoder's forward), and at the multitrack stretches' (431 frames -> 345
   and 539 steps);
4. kernel C (causal FIR, one shared kernel) at the FIR meter's shapes (64
   or 128 rows of 5 s, 1023 or 4095 taps) and at its 8192-tap limit;
5. kernel D (exclusive complex cumprod) at 65,600 rows x 432 steps;
6. kernel E (fused bf16 iSTFT synthesis) at the pitch shift's synthesis
   (64 x 432 frames of 2048, hop 512) and at n_fft 512, hop 128, with its
   peak-memory increment against ``istft(method="matmul_bf16")``, with and
   without ``match_stride``;
7. kernel F (the exact meter's block-state recurrence) at the meter's 64
   and 128 rows x 431 blocks x 4 states, in fp32 and fp64, against its
   plain version, the loop of one ``addmm`` a block that it replaced, and
   one exact meter call of 128 rows through each: host time to enqueue,
   device time and device operations;
8. kernel G (DAC's Snake) forward and backward at the codec decoder's last
   Snake at 30 s, the training cell's first and its deepest, against the
   eager expression and autograd's backward of it, with the memory autograd
   keeps for one Snake under each;
9. kernel D's own path, its public entry point ``rotation_cumprod`` (no
   library path calls it), with its launches counted.

Each kernel is held against its plain version (B and D bit for bit) and
timed in turns with it by CUDA events, beside its bound (the larger of its
operations over the card's peak rate for their type and its bytes, each
input read once and each output written once, over the memory rate) and
beside the one PyTorch call that computes the same function, where there
is one (the port never calls it); the bound's flops and bytes are the
wrapper's registered work (``wrapper.work``, what ``ops.perf.xla_cost``
counts for it). The paths that call the kernels are checked by
``tests/test_torch_cuda.py`` and timed by the benchmark (``perfbench/``).
Any failed check exits non-zero. The last lines are the kernel table, the
card's name and power limit, and ``{"ok": true, "device": ...}``. Without a
CUDA device the script exits non-zero and prints no result.
"""
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from audiotools_tpu_torch.ops import perf as PERF

SR = 44100
BATCH = 64
DURATION = 5.0
N_ITER = 5
MT_FACTORS = (1.25, 0.8)  # the multitrack path's time stretches

# published peaks of an H100 SXM (dense): fp32 outside the tensor cores;
# bf16 tensor cores and HBM3 from the port's accounting (ops/perf.py)
FP32_FLOPS = 67e12
BF16_FLOPS = PERF.PEAK_BF16_FLOPS
HBM_BYTES = PERF.HBM_BYTES_PER_S

# kernel vs plain version on the card, relative to the largest output. All
# sum in fp32; E rounds its operands to bf16 as its plain version does and
# sums the exact products in another order (measured 2e-6)
KERNEL_RTOL = 1e-5
# kernel E's peak-memory increment at the chain's shape: its output (57 MB)
# and nothing of the size of the spectrum or the frames
E_PEAK_LIMIT = 60e6


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


FAILED = []  # failed expectations: the run goes on and exits non-zero at the end


def expect(cond, msg):
    if not cond:
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        FAILED.append(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, n):
    """Mean milliseconds per call of ``fn`` over ``n`` calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(flops, peak, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def yardsticks(ms, flops, peak, nbytes, library=None, library_fn=None, n_library=3):
    """The kernel line's keys for one shape: bound, what bounds it, the share
    of it reached, and the library call's time (``library_fn``, timed here)."""
    bound_ms, bound_by = bound(flops, peak, nbytes)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "library": library,
            "library_ms": time_ms(library_fn, n_library) if library_fn is not None else None}


def compare_kernel(name, kernel, plain, n_kernel, n_plain):
    """Kernel vs plain on the same inputs: error and times, measured in
    turns (plain, kernel, kernel, plain)."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
    expect(all(bool(torch.isfinite(g).all()) for g in got), f"{name}: non-finite output")
    p1 = time_ms(plain, n_plain)
    k1 = time_ms(kernel, n_kernel)
    k2 = time_ms(kernel, n_kernel)
    p2 = time_ms(plain, n_plain)
    return abs_err, rel_err, (k1 + k2) / 2, (p1 + p2) / 2


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    from audiotools_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    expect(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = (smi.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {card}")
    t0 = time.perf_counter()
    _build.build_all()  # one nvcc per source, all started together
    print(f"[build] all sources: {time.perf_counter() - t0:.2f} s")
    for source in _build.SOURCES:
        ptxas = [ln.split(":", 1)[-1].strip() for ln in _build.build_log(source).splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"[build] {source}: nvcc {_build.BUILD_SECONDS.get(source, 0.0):.2f} s "
              f"{' | '.join(ptxas)}")
    return card


def phase_kernel_a(dev):
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops._fp32 import strict_fp32

    rng = np.random.RandomState(1)
    results = {}
    # (rows, padded length, taps): Equalizer, noise EQ (3 bands), IR EQ
    for label, (rows, T, L) in {
        "equalizer": (BATCH, int(SR * DURATION) + 640, 641),
        "noise_eq": (BATCH, int(SR * DURATION) + 230, 231),
        "ir_eq": (BATCH, SR + 640, 641),
        # the multitrack EQs: 5 s time-stretched by each factor
        **{f"multitrack {f:g}": (BATCH, round(SR * DURATION / f) + 640, 641)
           for f in MT_FACTORS},
    }.items():
        x = torch.from_numpy(rng.randn(rows, T).astype(np.float32)).to(dev)
        h = torch.from_numpy((rng.randn(rows, L) * 0.05).astype(np.float32)).to(dev)
        abs_err, rel_err, ms, plain_ms = compare_kernel(
            "fir_causal_batch", lambda: HK.fir_causal_batch(x, h),
            lambda: HK.fir_causal_batch_plain(x, h), 10, 3,
        )
        work = HK.fir_causal_batch.work(x, h)
        gflop = work["flops"] / 1e9
        xpad, hflip = F.pad(x, (L - 1, 0))[None], h.flip(-1)[:, None, :].contiguous()
        with strict_fp32():
            yard = yardsticks(ms, work["flops"], FP32_FLOPS, work["bytes"],
                              "F.conv1d (cuDNN, TF32 off)",
                              lambda: F.conv1d(xpad, hflip, groups=rows))
        print(f"[kernel A] {label} ({rows}, {T}) x {L} taps: max_abs_err {abs_err:.3e} "
              f"rel {rel_err:.3e} (tol {KERNEL_RTOL:g}) | kernel {ms:.4f} ms "
              f"({gflop / ms:.2f} TFLOP/s) | plain {plain_ms:.4f} ms | bound "
              f"{yard['bound_ms']:.4f} ms ({yard['bound_by']}, {yard['share_of_bound']:.1%}) | "
              f"{yard['library']} {yard['library_ms']:.4f} ms")
        expect(rel_err < KERNEL_RTOL, f"kernel A disagrees with its plain version ({label})")
        results[label] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard)
    return results


def pv_main_case(dev):
    """Kernel B's input at the pitch shift's shape, (64, 1, 1025, 384) at +2
    semitones -> 432 steps: a spectrum that is a transposed view of a
    time-major tensor (as ``ops.fft.stft`` returns it) and its step tables."""
    from audiotools_tpu_torch.ops import stretch as PS

    rng = np.random.RandomState(2)
    tm = (BATCH, 1, 384, 1025)
    z = torch.from_numpy(
        (rng.randn(*tm) + 1j * rng.randn(*tm)).astype(np.complex64)
    ).to(dev).transpose(-1, -2)
    return (z, *PS._pv_indices(tm[2], 2.0 ** (-2.0 / 12.0)))


def rotation_main_case(dev):
    """Kernel D's input at the pitch shift's rows x steps, 65,600 x 432:
    unit rotations and seeds as real planes ``(ur, ui, cr, ci)``."""
    rng = np.random.RandomState(4)
    rows, n = BATCH * 1025, 432
    ang = rng.uniform(-np.pi, np.pi, (rows, n))
    seed = rng.uniform(-np.pi, np.pi, rows)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        np.cos(ang), np.sin(ang), np.cos(seed), np.sin(seed)))


def phase_kernel_b(dev):
    """Kernel B at the pitch shift's shape, as the chains launch it: on a
    time-major spectrum read in place, in both variants: without the phasor
    track (the path's) and with it (the forward of the differentiable
    vocoder); then at the multitrack stretches' shapes, without the track.
    Each is held bit for bit against its plain version and timed beside its
    own bound."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import stretch as PS

    main = pv_main_case(dev)
    rng = np.random.RandomState(8)
    tm = (BATCH, 1, 1 + int(SR * DURATION) // 512, 1025)
    z = torch.from_numpy((rng.randn(*tm) + 1j * rng.randn(*tm)).astype(np.complex64)).to(
        dev).transpose(-1, -2)
    cases = {"with_phasor": (main, True), "path": (main, False),
             **{f"multitrack {f:g}": ((z, *PS._pv_indices(tm[2], f)), False) for f in MT_FACTORS}}
    results = {}
    for label, ((z, i0, i1, frac), with_phasor) in cases.items():
        shape = tuple(z.shape)
        rows, n = int(np.prod(shape[:-1])), len(i0)
        abs_err, _, ms, plain_ms = compare_kernel(
            "phase_vocoder_fused",
            lambda: HK.phase_vocoder_fused(z, i0, i1, frac, with_phasor=with_phasor),
            lambda: HK.phase_vocoder_fused_plain(z, i0, i1, frac, with_phasor=with_phasor), 10, 2,
        )
        work = HK.phase_vocoder_fused.work(z, i0, i1, frac, with_phasor)
        nbytes = work["bytes"]
        yard = yardsticks(ms, work["flops"], FP32_FLOPS, nbytes)
        plan = HK.pv_plan(rows, with_phasor)
        sync = f"a barrier every {plan.sync_every} steps" if plan.sync_every else "no barrier"
        print(f"[kernel B] {shape} -> {n} steps, {label} (plan {plan.threads} threads, "
              f"frames {plan.depth} steps ahead, {sync}): max_abs_err "
              f"{abs_err:.3e} (must be 0) | kernel {ms:.4f} ms ({nbytes / ms / 1e9:.2f} TB/s) | "
              f"plain {plain_ms:.4f} ms | bound {yard['bound_ms']:.4f} ms ({yard['bound_by']}, "
              f"{nbytes / 1e6:.1f} MB, {yard['share_of_bound']:.1%})")
        expect(abs_err == 0.0, f"kernel B ({label}) differs from its plain version")
        results[label] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard)
    print("[kernel B] library: none; no PyTorch call computes the phasor vocoder's "
          "step recurrence")
    return results


def phase_kernel_c(dev):
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import loudness as PL
    from audiotools_tpu_torch.ops._fp32 import strict_fp32

    rng = np.random.RandomState(3)
    n = int(SR * DURATION)
    meter = {z: PL._composed_fir(SR, "K-weighting", z) for z in (512, 2048)}
    results = {}
    # (rows, T, taps): the final LUFS and VolumeNorm; BackgroundNoise's
    # stacked signal + noise call; the zeros=2048 meter; the 8192-tap limit
    for label, (rows, T, h) in {
        "meter": (BATCH, n, meter[512]),
        "meter_stacked": (2 * BATCH, n, meter[512]),
        "meter_zeros2048": (BATCH, n, meter[2048]),
        "max_taps": (8, SR, (rng.randn(HK.MAX_TAPS) * 0.01).astype(np.float32)),
    }.items():
        L = len(h)
        x = torch.from_numpy(rng.randn(rows, T).astype(np.float32) * 0.1).to(dev)
        ht = torch.from_numpy(h).to(dev)
        abs_err, rel_err, ms, plain_ms = compare_kernel(
            "fir_causal", lambda: HK.fir_causal(x, ht), lambda: HK.fir_causal_plain(x, ht), 5, 2,
        )
        work = HK.fir_causal.work(x, ht)
        gflop = work["flops"] / 1e9
        xpad, hflip = F.pad(x[:, None], (L - 1, 0)), ht.flip(0)[None, None].contiguous()
        with strict_fp32():
            yard = yardsticks(ms, work["flops"], FP32_FLOPS, work["bytes"],
                              "F.conv1d (cuDNN, TF32 off)", lambda: F.conv1d(xpad, hflip), 2)
        print(f"[kernel C] {label} ({rows}, {T}) x {L} taps: max_abs_err {abs_err:.3e} "
              f"rel {rel_err:.3e} (tol {KERNEL_RTOL:g}) | kernel {ms:.4f} ms "
              f"({gflop / ms:.2f} TFLOP/s) | plain {plain_ms:.4f} ms "
              f"({gflop / plain_ms:.2f} TFLOP/s) | bound {yard['bound_ms']:.4f} ms "
              f"({yard['bound_by']}, {yard['share_of_bound']:.1%}) | {yard['library']} "
              f"{yard['library_ms']:.4f} ms")
        expect(rel_err < KERNEL_RTOL, f"kernel C disagrees with its plain version ({label})")
        results[label] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard)
    return results


def phase_kernel_d(dev):
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    ur, ui, cr, ci = rotation_main_case(dev)
    rows, n = ur.shape
    abs_err, _, ms, plain_ms = compare_kernel(
        "rotation_cumprod", lambda: HK.rotation_cumprod(ur, ui, cr, ci),
        lambda: HK.rotation_cumprod_plain(ur, ui, cr, ci), 10, 2,
    )
    gbytes = 4.0 * rows * n * 4 / 1e9
    # the library call: torch.cumprod of the complex rotations, built
    # outside the timed region; it is inclusive (no seed), D exclusive
    u = torch.complex(ur, ui)
    work = HK.rotation_cumprod.work(ur, ui, cr, ci)
    yard = yardsticks(ms, work["flops"], FP32_FLOPS, work["bytes"],
                      "torch.cumprod (complex64, inclusive)", lambda: torch.cumprod(u, dim=-1), 10)
    del u
    plan = HK.rotation_plan(rows, n)
    print(f"[kernel D] ({rows}, {n}) (plan {plan.rows_per_block} rows a block, {plan.stages} "
          f"stages of {plan.steps} steps, {16 if plan.wide else 4}-byte copies): max_abs_err "
          f"{abs_err:.3e} (must be 0) | kernel {ms:.4f} ms ({gbytes / ms:.2f} TB/s) | plain "
          f"{plain_ms:.4f} ms | bound {yard['bound_ms']:.4f} ms ({yard['bound_by']}, "
          f"{yard['share_of_bound']:.1%}) | {yard['library']} {yard['library_ms']:.4f} ms")
    expect(abs_err == 0.0, "kernel D differs from its plain version")
    return dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard), (ur, ui, cr, ci)


def phase_rotation(planes):
    """Kernel D's own path: no library path calls it, so it is driven
    through its public entry point, ``rotation_cumprod``, on the pitch
    shift's rows x steps of unit rotations. Launch counts are set to 0 just
    before and read just after."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    HK.reset_launch_counts()
    for _ in range(N_ITER + 1):
        pr, pi = HK.rotation_cumprod(*planes)
    torch.cuda.synchronize()
    launches = dict(HK.LAUNCHES)
    # products of unit rotations stay on the unit circle
    drift = float((torch.sqrt(pr * pr + pi * pi) - 1.0).abs().max())
    print(f"[entry rotation_cumprod] {tuple(pr.shape)}: |P| - 1 at most {drift:.3e} "
          f"(tol 1e-4) | kernel launches ({N_ITER + 1} calls): {launches}")
    expect(launches["rotation_cumprod"] > 0, f"rotation_cumprod: kernel D not launched: {launches}")
    expect(drift < 1e-4, "rotation_cumprod left the unit circle")


# kernel F's chain bound: each of its n_blk - 1 steps is ns dependent FMAs,
# at the FMA's latency (4 cycles fp32, 8 fp64 on Hopper, microbenchmarked
# figures, an assumption here) and the H100 SXM's top SM clock
FMA_CYCLES = {4: 4, 8: 8}
SM_CLOCK_HZ = 1.98e9


def scan_main_case(dev, rows, dtype=torch.float32):
    """Kernel F's arguments at the exact meter's shapes: the K-weighting
    cascade's u and (A^L)^T for ``rows`` rows of 5 s (431 blocks of 512, 4
    states), from seeded noise."""
    from audiotools_tpu_torch.ops import filters as PFL
    from audiotools_tpu_torch.ops import loudness as PL
    from audiotools_tpu_torch.ops._fp32 import strict_fp32

    n = int(SR * DURATION)
    stages = [(b, a, g) for (b, a), g in PL.design_filters(SR)]
    key = tuple((tuple(map(float, b)), tuple(map(float, a)), float(g)) for b, a, g in stages)
    _, _, psi_x_t, a_l_t = PFL._iir_operators_on(key, 512, dev, dtype)
    x = torch.from_numpy(np.random.RandomState(rows).randn(rows, n) * 0.1).to(dev, dtype)
    with strict_fp32():
        return F.pad(x, (0, -n % 512)).reshape(rows, -1, 512) @ psi_x_t, a_l_t


@contextlib.contextmanager
def addmm_loop():
    """Every block-state recurrence through the loop of one ``addmm`` a
    block that kernel F replaced (its plain version), on the card too."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    kernel = HK.iir_block_scan
    HK.iir_block_scan = HK.iir_block_scan_plain
    try:
        yield
    finally:
        HK.iir_block_scan = kernel


def phase_kernel_f(dev):
    """Kernel F against its plain version (the addmm loop, also the
    yardstick: no single PyTorch call computes the recurrence) at the exact
    meter's shapes, beside its two bounds (bytes; the chain of dependent
    FMAs); then one exact meter call of 128 stacked rows through F and
    through the loop: host ms to enqueue it, device ms, and the device
    operations it launches (torch.profiler)."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import loudness as PL
    from audiotools_tpu_torch.ops.ragged_shapes import SCAN_RTOL, SCAN_VS_PLAIN_ERROR

    results = {}
    # VolumeNorm's and the features' meter (64 rows), the mix's stacked
    # signal and noise (128), and the float64 biquads' type at 128
    for label, (rows, dtype) in {"meter": (BATCH, torch.float32),
                                 "meter_stacked": (2 * BATCH, torch.float32),
                                 "float64": (2 * BATCH, torch.float64)}.items():
        u, a_l_t = scan_main_case(dev, rows, dtype)
        _, n_blk, ns = u.shape
        kernel = lambda: HK.iir_block_scan(u, a_l_t)  # noqa: E731
        abs_err, rel_err, events_ms, plain_ms = compare_kernel(
            "iir_block_scan", kernel, lambda: HK.iir_block_scan_plain(u, a_l_t), 50, 3)
        if dtype == torch.float32:  # each against the float64 recurrence
            ref = HK.iir_block_scan_plain(u.cpu().double(), a_l_t.cpu().double())
            scale = ref.abs().max()
            err = {k: float((out.cpu().double() - ref).abs().max() / scale) for k, out in (
                ("kernel", kernel()), ("plain", HK.iir_block_scan_plain(u, a_l_t)))}
            accurate = err["kernel"] <= SCAN_VS_PLAIN_ERROR * err["plain"]
            against = (f"against the float64 recurrence: kernel {err['kernel']:.3e}, plain "
                       f"{err['plain']:.3e} (kernel within {SCAN_VS_PLAIN_ERROR:g}x)")
        else:
            accurate = rel_err < SCAN_RTOL[dtype]
            against = f"(tol {SCAN_RTOL[dtype]:g})"
        # the profiler's device time: F is shorter than its wrapper's host
        # time, so events around a loop of calls time the host
        busy_ms, count = profile_kernels(lambda: [kernel() for _ in range(50)])
        expect(count == 50, f"kernel F: the profiler saw {count} of 50 launches")
        ms = busy_ms / max(count, 1)
        work = HK.iir_block_scan.work(u, a_l_t)
        yard = yardsticks(ms, work["flops"], FP32_FLOPS if dtype == torch.float32 else FP32_FLOPS / 2,
                          work["bytes"], "none: no PyTorch call computes the block recurrence")
        chain_ms = (n_blk - 1) * ns * FMA_CYCLES[u.element_size()] / SM_CLOCK_HZ * 1e3
        plan = HK.scan_plan(rows, ns, u.element_size())
        print(f"[kernel F] {label} {tuple(u.shape)} {str(dtype)[6:]} (plan {plan.threads} rows a "
              f"block, {plan.blocks} blocks, inputs {plan.depth} steps ahead in a ring in shared "
              f"memory): kernel - plain max_abs_err {abs_err:.3e} rel {rel_err:.3e}; {against} | "
              f"kernel {ms * 1e3:.2f} us (profiler, mean of 50) | CUDA events over 50 calls "
              f"{events_ms * 1e3:.2f} us a call | plain (addmm "
              f"loop) {plain_ms:.4f} ms | bound {yard['bound_ms'] * 1e3:.3f} us ({yard['bound_by']}, "
              f"{yard['share_of_bound']:.1%}) | chain bound {chain_ms * 1e3:.2f} us "
              f"({chain_ms / ms:.1%})")
        expect(accurate, f"kernel F is less accurate than its plain version ({label})")
        results[label] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard)

    x = torch.from_numpy(np.random.RandomState(11).randn(2 * BATCH, 1, int(SR * DURATION))
                         .astype(np.float32) * 0.1).to(dev)
    meter = {}
    for path, ctx in (("kernel F", contextlib.nullcontext), ("addmm loop", addmm_loop)):
        with ctx():
            before = HK.LAUNCHES["iir_block_scan"]
            PL.loudness(x, SR, use_fir=False)  # warm
            torch.cuda.synchronize()
            launched = HK.LAUNCHES["iir_block_scan"] - before
            host = []
            for _ in range(N_ITER):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                PL.loudness(x, SR, use_fir=False)
                host.append((time.perf_counter() - t0) * 1e3)
            device_ms = time_ms(lambda: PL.loudness(x, SR, use_fir=False), N_ITER)
            _, ops = profile_kernels(lambda: PL.loudness(x, SR, use_fir=False))
        meter[path] = dict(host_ms=float(np.median(host)), device_ms=device_ms, ops=ops,
                           f_launches=launched)
        print(f"[kernel F] exact meter call {tuple(x.shape)} through the {path}: host "
              f"{meter[path]['host_ms']:.3f} ms to enqueue (median of {N_ITER}) | device "
              f"{device_ms:.3f} ms | {ops} device operations (profiler) | kernel F launches "
              f"{launched}")
    expect(meter["kernel F"]["f_launches"] == 1 and meter["addmm loop"]["f_launches"] == 0,
           f"exact meter call: kernel F launches {meter}")
    return results


# kernel G's shapes: the codec decoder's last Snake at 30 s (the largest a
# round trip runs), the training cell's first (18 x 64 x 16,896) and its
# deepest (18 x 1536 x 33 frames)
SNAKE_SHAPES = {"codec": (1, 96, 1_323_008), "training": (18, 64, 16_896),
                "training_deep": (18, 1536, 33)}


def snake_main_case(dev, shape, seed=12):
    """Kernel G's input at ``shape``: activations of 2 RMS, one positive
    alpha a channel around 1 (DAC initializes them at 1), a gradient."""
    rng = np.random.RandomState(seed)
    B, C, T = shape
    x = torch.from_numpy((rng.randn(B, C, T) * 2.0).astype(np.float32)).to(dev)
    alpha = torch.from_numpy(np.exp(rng.randn(1, C, 1) * 0.5).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(B, C, T).astype(np.float32)).to(dev)
    return x, alpha, g


def phase_kernel_g(dev):
    """Kernel G (DAC's Snake) at the codec's and the training cell's shapes.
    Forward: against the eager expression (its plain version, also the
    yardstick: eager is what the port ran), bit for bit. Backward: against
    autograd's backward of the expression, its forward excluded (x's
    gradient within a few ulp, alpha's relative to its largest value), and
    two runs bit-equal. Each timed by CUDA events beside its byte bound,
    and the device memory autograd keeps for one Snake under each."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    results = {}
    eps = torch.finfo(torch.float32).eps
    for label, shape in SNAKE_SHAPES.items():
        x, alpha, g = snake_main_case(dev, shape)
        abs_err, _, ms, plain_ms = compare_kernel(
            "snake", lambda: HK.snake(x, alpha), lambda: HK.snake_plain(x, alpha), 20, 5)
        expect(abs_err == 0.0, f"kernel G's forward is not the expression's bits ({label}: "
                               f"max_abs_err {abs_err:.3e})")
        work = HK.snake.work(x, alpha)
        yard = yardsticks(ms, work["flops"], FP32_FLOPS, work["bytes"],
                          "none: eager's five kernels are its plain version")

        xe, ae = x.clone().requires_grad_(True), alpha.clone().requires_grad_(True)
        ye = HK.snake_plain(xe, ae)
        want = torch.autograd.grad(ye, (xe, ae), g, retain_graph=True)
        got = HK.snake_backward(x, alpha, g)
        again = HK.snake_backward(x, alpha, g)
        torch.cuda.synchronize()
        size = g.abs() + (want[0] - g).abs()
        gx_abs = float((got[0] - want[0]).abs().max())
        gx_ulp = float(((got[0] - want[0]).abs() / (eps * size).clamp_min(1e-30)).max())
        ga_rel = float((got[1] - want[1]).abs().max() / want[1].abs().max())
        same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        expect(gx_ulp <= 4 and ga_rel < 1e-5 and same,
               f"kernel G's backward ({label}): gx {gx_ulp:.2f} ulp, g_alpha rel {ga_rel:.3e}, "
               f"repeatable {same}")
        eager_bwd = lambda: torch.autograd.grad(ye, (xe, ae), g, retain_graph=True)  # noqa: E731
        b_plain1 = time_ms(eager_bwd, 5)
        b_ms1 = time_ms(lambda: HK.snake_backward(x, alpha, g), 20)
        b_ms2 = time_ms(lambda: HK.snake_backward(x, alpha, g), 20)
        b_plain2 = time_ms(eager_bwd, 5)
        b_ms, b_plain = (b_ms1 + b_ms2) / 2, (b_plain1 + b_plain2) / 2
        b_work = HK.snake_backward.work(x, alpha, g)
        b_yard = yardsticks(b_ms, b_work["flops"], FP32_FLOPS, b_work["bytes"],
                            "none: autograd's backward of the eager chain is its yardstick")
        del ye, want, got, again

        saved = {}
        for path, fn in (("kernel G", HK.snake), ("eager", HK.snake_plain)):
            xs = x.clone().requires_grad_(True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            y = fn(xs, ae)
            torch.cuda.synchronize()
            saved[path] = torch.cuda.memory_allocated() - base - y.numel() * y.element_size()
            del y, xs
        print(f"[kernel G] {label} {tuple(x.shape)}: forward {ms:.4f} ms (CUDA events) | "
              f"eager chain {plain_ms:.4f} ms | bound {yard['bound_ms']:.4f} ms "
              f"({yard['bound_by']}, {yard['share_of_bound']:.1%}) | bit-equal "
              f"{abs_err == 0.0} || backward {b_ms:.4f} ms | eager autograd backward "
              f"{b_plain:.4f} ms | bound {b_yard['bound_ms']:.4f} ms ({b_yard['bound_by']}, "
              f"{b_yard['share_of_bound']:.1%}) | gx {gx_ulp:.2f} ulp, g_alpha rel "
              f"{ga_rel:.3e}, repeatable {same} || kept for backward: kernel G "
              f"{saved['kernel G'] / 2**20:.1f} MiB, eager {saved['eager'] / 2**20:.1f} MiB")
        results[label] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard)
        results[f"{label} backward"] = dict(abs_err=gx_abs, ms=b_ms, plain_ms=b_plain,
                                            gx_ulp=gx_ulp, g_alpha_rel=ga_rel, saved=saved,
                                            **b_yard)
        del x, alpha, g, xe, ae
    return results


def peak_increment(fn):
    """Bytes that ``fn`` adds to the device's peak allocation."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def phase_kernel_e(dev):
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    rng = np.random.RandomState(5)
    out_len = int(SR * DURATION)
    results = {}
    # the chain's synthesis at +2 st (64 x 432 frames of 2048, hop 512), and
    # the same audio at n_fft 512, hop 128
    for label, (n_fft, hop, nt) in {
        "chain": (2048, 512, 432),
        "n_fft512": (512, 128, 1 + 4 * 432),
    }.items():
        n_freq = n_fft // 2 + 1
        shape = (BATCH, nt, n_freq)
        spec = torch.from_numpy(
            ((rng.randn(*shape) + 1j * rng.randn(*shape)) * 0.05).astype(np.complex64)).to(dev)
        (w,) = PF._on_device(PF._synthesis_design, ("hann", n_fft, hop), dev)
        (env,) = PF._on_device(PF._inverse_envelope, ("hann", n_fft, hop, nt), dev)
        abs_err, rel_err, ms, plain_ms = compare_kernel(
            "istft_synthesis_fused", lambda: HK.istft_synthesis_fused(spec, w, hop, env),
            lambda: HK.istft_synthesis_fused_plain(spec, w, hop, env), 10, 3,
        )
        work = HK.istft_synthesis_fused.work(spec, w, hop, env)
        gflop = work["flops"] / 1e9
        # the library call: torch.istft of the same spectrum (frequency-major,
        # copied outside the timed region), Hann window, hop, the same
        # samples after the center trim, fp32 (cuFFT)
        spec_fm = spec.transpose(1, 2).contiguous()
        window = torch.hann_window(n_fft, device=dev)
        yard = yardsticks(ms, work["flops"], BF16_FLOPS, work["bytes"], "torch.istft (fp32, cuFFT)",
                          lambda: torch.istft(spec_fm, n_fft, hop, window=window, center=True,
                                              length=hop * (nt - 1)), 10)
        del spec_fm
        print(f"[kernel E] {label} {shape} x ({n_fft}, hop {hop}): max_abs_err {abs_err:.3e} "
              f"rel {rel_err:.3e} (tol {KERNEL_RTOL:g}) | kernel {ms:.4f} ms "
              f"({gflop / ms:.2f} TFLOP/s) | plain {plain_ms:.4f} ms | bound "
              f"{yard['bound_ms']:.4f} ms ({yard['bound_by']}, {yard['share_of_bound']:.1%}) | "
              f"{yard['library']} {yard['library_ms']:.4f} ms")
        expect(rel_err < KERNEL_RTOL, f"kernel E disagrees with its plain version ({label})")
        results[label] = dict(abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yard)

    # peak memory at the chain's shape (432 synthesis frames): E against the
    # unfused bf16 iSTFT, on a spectrum laid out as kernel B writes it
    # (time-major, read in place); and with match_stride, whose two zero
    # frames at each end E reads as zeros instead of padding a copy
    frames = BATCH * 432 * 2048 * 4
    peaks = {}
    for match_stride in (False, True):
        nt = 432 - 4 * match_stride
        shape = (BATCH, 1, nt, 1025)
        stft_data = torch.from_numpy(
            ((rng.randn(*shape) + 1j * rng.randn(*shape)) * 0.05).astype(np.complex64)
        ).to(dev).transpose(-1, -2)
        kw = dict(match_stride=True, original_length=nt * 512) if match_stride else dict(
            length=out_len)
        for m in ("matmul_bf16_fused", "matmul_bf16"):
            PF.istft(stft_data, 2048, 512, method=m, **kw)  # warm-up: the cached designs
            peaks[m, match_stride] = peak_increment(
                lambda: PF.istft(stft_data, 2048, 512, method=m, **kw))
        print(f"[kernel E] peak-memory increment at {shape}, match_stride {match_stride}: "
              f"fused {peaks['matmul_bf16_fused', match_stride] / 1e6:.1f} MB, matmul_bf16 "
              f"{peaks['matmul_bf16', match_stride] / 1e6:.1f} MB (frame tensor "
              f"{frames / 1e6:.1f} MB)")
        expect(peaks["matmul_bf16_fused", match_stride] < frames,
               f"kernel E's peak-memory increment (match_stride {match_stride}) is not below "
               f"the frame tensor it never builds")
        expect(peaks["matmul_bf16_fused", match_stride] <= E_PEAK_LIMIT,
               f"kernel E's peak-memory increment (match_stride {match_stride}) is above "
               f"{E_PEAK_LIMIT / 1e6:g} MB")
    return results


def profile_kernels(fn):
    """One call of ``fn`` under ``torch.profiler``: the kernels' summed
    device ms and their count (user annotations, which span kernels, left
    out). A first profiling session in a process once saw 49 of kernel F's
    50 launches, so a throwaway session around one launch comes first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    return (sum(e.self_device_time_total for e in kernels) / 1000,
            sum(e.count for e in kernels))


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port's kernels on the card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_device()
    a = phase_kernel_a(dev)
    b = phase_kernel_b(dev)
    c = phase_kernel_c(dev)
    d, planes = phase_kernel_d(dev)
    e = phase_kernel_e(dev)
    f = phase_kernel_f(dev)
    g = phase_kernel_g(dev)
    phase_rotation(planes)
    del planes
    if FAILED:
        fail(f"{len(FAILED)} failed checks: {FAILED}")

    def row(name, source, replaces, results, key=None):
        """``results``: {shape label: measurements}, reported at ``key``, or
        the measurements of one shape; ``replaces``: a line of
        ``pallas_kernels.py``, or the file and line of what else the kernel
        replaces."""
        if key is None:
            results, key = {key: results}, key
        at = results[key]
        if isinstance(replaces, int):
            replaces = f"ops/pallas_kernels.py:{replaces}"
        return {"name": name, "route": "cuda", "source": f"audiotools_tpu_torch/csrc/{source}",
                "replaces": f"audiotools_tpu/{replaces}",
                "max_abs_err": max(v["abs_err"] for v in results.values()),
                **{k: at[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                                      "library", "library_ms")}}

    kernels = [
        row("fir_causal_batch", "fir_causal_batch.cu", 182, a, "equalizer"),
        row("phase_vocoder_fused", "phase_vocoder.cu", 309, b, "path"),
        row("fir_causal", "fir_causal_batch.cu", 100, c, "meter"),
        row("rotation_cumprod", "rotation_cumprod.cu", 417, d),
        row("istft_synthesis_fused", "istft_synthesis.cu", 527, e, "chain"),
        # F replaces no Pallas kernel but the JAX package's lax.scan over block states
        row("iir_block_scan", "iir_block_scan.cu", "ops/filters.py:597 (lax.scan)", f,
            "meter_stacked"),
        # G replaces no Pallas kernel but the eager Snake (XLA fuses the JAX one)
        row("snake", "snake.cu", "models/dac.py:27 (snake)", g, "codec"),
        row("snake_backward", "snake.cu", "models/dac.py:27 (snake)", g, "codec backward"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
