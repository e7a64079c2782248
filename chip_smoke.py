"""Smoke run of the PyTorch port's augmentation path on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``audiotools_tpu_torch/csrc`` and
runs, on card 0:

1. the device, its name and power limit (``nvidia-smi``), the kernel build
   (one nvcc per source, all at once, with ptxas's registers and spills),
   and the default device of signals and loaders (the card);
2. kernel A (per-item causal FIR) against its plain PyTorch version at the
   equalizers' shapes (64 rows of 5 s or 1 s at 44.1 kHz; 641 or 231 taps);
3. kernel B (fused phase vocoder) against its plain version at the pitch
   shift's shape (64 x 1 x 1025 bins, 384 frames -> 432 steps), read in
   place from a time-major spectrum as the chains give it, in both
   variants: with the phasor track and without it (the chains' launch,
   which the kernel table reports);
4. kernel C (causal FIR, one shared kernel) at the FIR meter's shapes
   (64 or 128 rows of 5 s, 1023 or 4095 taps) and at its 8192-tap limit;
   kernel D (exclusive complex cumprod) at 65,600 rows x 432 steps; kernel
   E (fused bf16 iSTFT synthesis) at the pitch shift's synthesis (64 x 432
   frames of 2048, hop 512) and at n_fft 512, hop 128, with its
   peak-memory increment against ``istft(method="matmul_bf16")``, with and
   without ``match_stride``; then kernel D's own path, its public entry
   point ``rotation_cumprod`` (no library path calls it), with its launches
   counted;
5. two paths on one staged batch of 64 clips of 5 s at 44.1 kHz
   (AudioDataset -> DataLoader -> Compose(RoomImpulseResponse,
   BackgroundNoise, Equalizer, VolumeNorm) -> pitch_shift(+2 st) -> mel-80
   -> BS.1770 loudness), each timed per stage with CUDA events and checked
   to have launched its kernels: the main path (exact meter, bf16
   synthesis: A and B) and the reference-parity path (the FIR meter of
   ``set_fast_meter(True)`` and the fused synthesis: A, B, C and E);
6. the same chains on the card and on the CPU (plain versions) for the
   first 4 clips, against stated tolerances.

Every kernel is also held against its plain version at ragged shapes of
its tiling (B and D bit for bit), and timed beside its bound (the larger
of its operations over the card's peak rate for their type and its bytes,
each input read once and each output written once, over the memory rate)
and beside the one PyTorch call that computes the same function, where
there is one (the port never calls it). Any failed check exits non-zero.
The last lines are the kernel table, the card's name and power limit, and
``{"ok": true, "device": ...}``. Without a CUDA device the script exits
non-zero and prints no result.
"""
import contextlib
import csv
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SR = 44100
BATCH = 64
DURATION = 5.0
N_ITER = 5
N_CHECK = 4

# published peaks of an H100 SXM (dense): fp32 outside the tensor cores,
# bf16 tensor cores, HBM3
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12

# kernel vs plain version on the card, relative to the largest output. All
# sum in fp32; E rounds its operands to bf16 as its plain version does and
# sums the exact products in another order (measured 2e-6)
KERNEL_RTOL = 1e-5
# chain on the card vs on the CPU (first N_CHECK clips). With fp32
# synthesis both sides sum in fp32 in different orders. With the path's
# bf16 synthesis, a spectrum value that lies within fp32 rounding of a bf16
# rounding boundary goes to different bf16 neighbours on the two sides,
# which moves it by one bf16 ulp, 2**-8 ~ 3.9e-3 of itself: the bound for
# the largest outputs.
# kernel E's peak-memory increment at the chain's shape: its output (57 MB)
# and nothing of the size of the spectrum or the frames
E_PEAK_LIMIT = 60e6
CHAIN_TOL = {
    "matmul": {"audio_abs": 1e-4, "mel_rel": 1e-4, "lufs_db": 0.01},
    "matmul_bf16": {"audio_abs": 4e-3, "mel_rel": 4e-3, "lufs_db": 0.01},
}


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


FAILED = []  # failed expectations: the run goes on and exits non-zero at the end


def expect(cond, msg):
    if not cond:
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        FAILED.append(msg)


# ---------------------------------------------------------------------------
# fixtures: deterministic speech-like, noise and impulse-response WAVs
# ---------------------------------------------------------------------------


def speech_like(seed, duration=12.0):
    rng = np.random.RandomState(seed)
    n = int(duration * SR)
    t = np.arange(n) / SR
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.4 * t + rng.rand() * 6)
    phase = np.cumsum(2 * np.pi * f0 / SR)
    sig = np.zeros(n)
    for h, a in [(1, 1.0), (2, 0.6), (3, 0.4), (4, 0.25), (5, 0.12)]:
        sig += a * np.sin(h * phase + rng.rand() * 6)
    noise = rng.randn(n) * 0.15
    am = 0.5 * (1 + np.sin(2 * np.pi * 2.5 * t + rng.rand() * 6))
    am = am * (rng.rand(n) < 0.999)
    return ((sig * am + noise * am) * 0.15).astype(np.float32)


def noise_like(seed, duration=12.0):
    rng = np.random.RandomState(seed)
    b = np.exp(-np.arange(64) / 16.0)
    return (np.convolve(rng.randn(int(duration * SR)), b / b.sum(), mode="same") * 0.2).astype(np.float32)


def ir_like(seed, duration=1.0):
    rng = np.random.RandomState(seed)
    n = int(duration * SR)
    out = np.zeros(n, dtype=np.float32)
    out[64] = 1.0
    out[65:] = 0.25 * rng.randn(n - 65) * np.exp(-np.linspace(0, 9, n - 65))
    return out


def build_fixture_tree(root: Path):
    from audiotools_tpu_torch.io import write_wav

    groups = {
        "spk": [speech_like(i) for i in range(3)],
        "nz": [noise_like(100 + i) for i in range(2)],
        "ir": [ir_like(200 + i) for i in range(2)],
    }
    for name, sigs in groups.items():
        (root / name).mkdir()
        with open(root / f"{name}.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["path"])
            writer.writeheader()
            for i, s in enumerate(sigs):
                path = root / name / f"{name}_{i}.wav"
                write_wav(path, s[None, :], SR)
                writer.writerow({"path": str(path)})


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


def phase_defaults():
    """Signals built from arrays go to the card unless told ``device="cpu"``;
    tensors stay where they are."""
    from audiotools_tpu_torch import AudioSignal

    x = np.zeros((1, 1, 100), np.float32)
    devices = (AudioSignal(x, SR).device.type, AudioSignal(x, SR, device="cpu").device.type,
               AudioSignal(torch.from_numpy(x), SR).device.type)
    print(f"[defaults] AudioSignal from numpy: {devices[0]}; with device='cpu': {devices[1]}; "
          f"from a CPU tensor: {devices[2]}")
    expect(devices == ("cuda", "cpu", "cpu"), f"default devices {devices}")


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
    }.items():
        x = torch.from_numpy(rng.randn(rows, T).astype(np.float32)).to(dev)
        h = torch.from_numpy((rng.randn(rows, L) * 0.05).astype(np.float32)).to(dev)
        abs_err, rel_err, ms, plain_ms = compare_kernel(
            "fir_causal_batch", lambda: HK.fir_causal_batch(x, h),
            lambda: HK.fir_causal_batch_plain(x, h), 10, 3,
        )
        gflop = 2.0 * rows * T * L / 1e9
        xpad, hflip = F.pad(x, (L - 1, 0))[None], h.flip(-1)[:, None, :].contiguous()
        with strict_fp32():
            yard = yardsticks(ms, gflop * 1e9, FP32_FLOPS, 4.0 * rows * (2 * T + L),
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
    vocoder). Each is held bit for bit against its plain version and timed
    beside its own bound."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    z, i0, i1, frac = pv_main_case(dev)
    shape = tuple(z.shape)
    rows, n = int(np.prod(shape[:-1])), len(i0)
    results = {}
    for label, with_phasor in (("with_phasor", True), ("path", False)):
        abs_err, _, ms, plain_ms = compare_kernel(
            "phase_vocoder_fused",
            lambda: HK.phase_vocoder_fused(z, i0, i1, frac, with_phasor=with_phasor),
            lambda: HK.phase_vocoder_fused_plain(z, i0, i1, frac, with_phasor=with_phasor), 10, 2,
        )
        # each input frame read once, the output (and the track) written once,
        # the step tables read once; ~31 fp32 operations a bin and step (two
        # magnitudes, the interpolated magnitude, the rotation, its
        # normalisation, the phasor update)
        nbytes = 8.0 * rows * (shape[-1] + n * (1 + with_phasor)) + 12.0 * n
        yard = yardsticks(ms, 31.0 * rows * n, FP32_FLOPS, nbytes)
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
        gflop = 2.0 * rows * T * L / 1e9
        xpad, hflip = F.pad(x[:, None], (L - 1, 0)), ht.flip(0)[None, None].contiguous()
        with strict_fp32():
            yard = yardsticks(ms, gflop * 1e9, FP32_FLOPS, 4.0 * (2 * rows * T + L),
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
    yard = yardsticks(ms, 6.0 * rows * n, FP32_FLOPS, 4.0 * rows * (4 * n + 2),
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
    return launches


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
        gflop = 2.0 * BATCH * nt * 2 * n_freq * n_fft / 1e9
        # the library call: torch.istft of the same spectrum (frequency-major,
        # copied outside the timed region), Hann window, hop, the same
        # samples after the center trim, fp32 (cuFFT)
        spec_fm = spec.transpose(1, 2).contiguous()
        window = torch.hann_window(n_fft, device=dev)
        nbytes = spec.numel() * 8 + w.numel() * 2 + env.numel() * 4 + BATCH * env.numel() * 4
        yard = yardsticks(ms, gflop * 1e9, BF16_FLOPS, nbytes, "torch.istft (fp32, cuFFT)",
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
    return results, peaks


def phase_ragged(dev):
    """Every kernel against its plain version at the shapes of
    ``ops.ragged_shapes``, which do not fill their tiles: A, C and E within
    the relative tolerance, B (both variants) and D bit for bit."""
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import ragged_shapes as RAGGED

    rng = np.random.RandomState(6)
    worst = {}
    for kind, rows, T, L in ([("A", *s) for s in RAGGED.FIR_BATCH]
                             + [("C", *s) for s in RAGGED.FIR_SHARED]):
        x = torch.from_numpy(rng.randn(rows, T).astype(np.float32)).to(dev)
        if kind == "A":
            h = torch.from_numpy((rng.randn(rows, L) * 0.05).astype(np.float32)).to(dev)
            got, want = HK.fir_causal_batch(x, h), HK.fir_causal_batch_plain(x, h)
        else:
            h = torch.from_numpy((rng.randn(L) * 0.05).astype(np.float32)).to(dev)
            got, want = HK.fir_causal(x, h), HK.fir_causal_plain(x, h)
        err = float((got - want).abs().max() / want.abs().max())
        worst[kind] = max(worst.get(kind, 0.0), err)
    for B, nt, n_fft, hop in RAGGED.SYNTHESIS:
        n_freq = n_fft // 2 + 1
        spec = torch.from_numpy(((rng.randn(B, nt, n_freq) + 1j * rng.randn(B, nt, n_freq)) * 0.1)
                                .astype(np.complex64)).to(dev)
        (w,) = PF._on_device(PF._synthesis_design, ("hann", n_fft, hop), dev)
        for edge in (0, 2):
            (env,) = PF._on_device(PF._inverse_envelope, ("hann", n_fft, hop, nt + 2 * edge), dev)
            got = HK.istft_synthesis_fused(spec, w, hop, env, edge)
            want = HK.istft_synthesis_fused_plain(spec, w, hop, env, edge)
            err = float((got - want).abs().max() / want.abs().max())
            worst["E"] = max(worst.get("E", 0.0), err)
    exact = {}  # B and D: max abs error, which must be 0
    for case, (shape, rate) in enumerate(RAGGED.PV):
        z, i0, i1, frac = RAGGED.pv_case(shape, rate, seed=case)
        z = torch.from_numpy(z).to(dev)
        for with_phasor in (False, True):
            got = HK.phase_vocoder_fused(z, i0, i1, frac, with_phasor=with_phasor)
            want = HK.phase_vocoder_fused_plain(z, i0, i1, frac, with_phasor=with_phasor)
            got, want = (got, want) if with_phasor else ((got,), (want,))
            key = "B with phasor" if with_phasor else "B"
            exact[key] = max([exact.get(key, 0.0)] + [float((g - w).abs().max())
                                                      for g, w in zip(got, want)])
    for shape in RAGGED.ROTATION:
        ang = rng.uniform(-np.pi, np.pi, shape)
        seed = rng.uniform(-np.pi, np.pi, shape[:-1])
        planes = [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (
            np.cos(ang), np.sin(ang), np.cos(seed), np.sin(seed))]
        got, want = HK.rotation_cumprod(*planes), HK.rotation_cumprod_plain(*planes)
        exact["D"] = max([exact.get("D", 0.0)] + [float((g - w).abs().max())
                                                  for g, w in zip(got, want)])
    torch.cuda.synchronize()
    print("[ragged] worst rel. err against the plain versions: " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()) + f" (tol {KERNEL_RTOL:g}); max abs err: "
        + ", ".join(f"{k} {v:.3e}" for k, v in exact.items())
        + f" (must be 0; {len(RAGGED.PV)} B and {len(RAGGED.ROTATION)} D shapes)")
    for k, v in worst.items():
        expect(v < KERNEL_RTOL, f"kernel {k} disagrees with its plain version at a ragged shape")
    for k, v in exact.items():
        expect(v == 0.0, f"kernel {k} differs from its plain version at a ragged shape")


def make_dataset(root, n_examples):
    from audiotools_tpu_torch.data import transforms as tfm
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader

    transform = tfm.Compose(
        tfm.RoomImpulseResponse(sources=[str(root / "ir.csv")]),
        tfm.BackgroundNoise(sources=[str(root / "nz.csv")]),
        tfm.Equalizer(),
        tfm.VolumeNorm(),
    )
    return AudioDataset(AudioLoader(sources=[str(root / "spk.csv")]), sample_rate=SR,
                        n_examples=n_examples, duration=DURATION, transform=transform)


def run_chain(ds, batch, synthesis_method="matmul_bf16", marks=None):
    """The main path on a staged batch; ``marks`` collects a CUDA event
    after each stage (chain, pitch shift, mel, loudness). The meter is the
    process-wide default (``loudness.set_fast_meter``)."""
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import loudness as PL
    from audiotools_tpu_torch.ops import stretch as PS

    def mark():
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

    mark()
    out = ds.transform(batch["signal"].clone(), **batch["transform_args"])
    mark()
    audio = PS.pitch_shift(out.audio_data, 2.0, SR, synthesis_method=synthesis_method,
                           pv_formulation="phasor_fused")
    mark()
    mel = PF.mel_spectrogram(audio, SR, 80, method="matmul")
    mark()
    lufs = PL.loudness(audio, SR)
    mark()
    return audio, mel, lufs


@contextlib.contextmanager
def meter(fast: bool):
    """The process-wide meter for one path; the exact meter is restored
    on the way out, whatever happens inside."""
    from audiotools_tpu_torch.ops import loudness as PL

    PL.set_fast_meter(fast)
    try:
        yield
    finally:
        PL.set_fast_meter(False)


# (label, fast meter, synthesis method, kernels the path must launch)
PATHS = [
    ("main", False, "matmul_bf16", ("fir_causal_batch", "phase_vocoder_fused")),
    ("parity", True, "matmul_bf16_fused",
     ("fir_causal_batch", "phase_vocoder_fused", "fir_causal", "istft_synthesis_fused")),
]


def phase_chain(ds, batch, label, fast_meter, synthesis_method, must_launch):
    """One path on the staged batch: a warm-up run, then N_ITER timed runs.
    Launch counts are set to 0 just before the path and read just after."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    with meter(fast_meter):
        HK.reset_launch_counts()
        run_chain(ds, batch, synthesis_method)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stages = np.zeros(4)
        t0 = time.perf_counter()
        for _ in range(N_ITER):
            marks = []
            audio, mel, lufs = run_chain(ds, batch, synthesis_method, marks=marks)
            torch.cuda.synchronize()
            stages += [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        wall_ms = (time.perf_counter() - t0) * 1000 / N_ITER
        launches = dict(HK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    stages /= N_ITER
    ms = float(stages.sum())
    tag = f"[chain {label}]"
    print(f"{tag} meter {'FIR through kernel C' if fast_meter else 'exact'}, synthesis "
          f"{synthesis_method}: {BATCH} x {DURATION:g} s @ {SR} Hz: {ms:.3f} ms/batch (CUDA "
          f"events; host wall {wall_ms:.3f} ms) | {BATCH / ms * 1000:.1f} clips/s | "
          f"{BATCH * DURATION / ms * 1000:.0f}x real time | peak {peak / 2**30:.3f} GiB")
    print(f"{tag} stages (ms): " + ", ".join(
        f"{n} {v:.3f}" for n, v in zip(("transforms", "pitch_shift", "mel", "loudness"), stages)))
    print(f"{tag} kernel launches ({N_ITER + 1} runs): {launches}")
    expect(all(launches[k] > 0 for k in must_launch),
           f"{label}: a kernel of the path was not launched: {launches}")
    n_frames = 1 + int(SR * DURATION) // 512
    expect(tuple(audio.shape) == (BATCH, 1, int(SR * DURATION)), f"audio shape {tuple(audio.shape)}")
    expect(tuple(mel.shape) == (BATCH, 1, 80, n_frames), f"mel shape {tuple(mel.shape)}")
    expect(tuple(lufs.shape) == (BATCH,), f"lufs shape {tuple(lufs.shape)}")
    for name, t in (("audio", audio), ("mel", mel), ("lufs", lufs)):
        expect(bool(torch.isfinite(t).all()), f"non-finite {name}")
    expect(bool(((lufs > -40) & (lufs < -10)).all()), f"implausible loudness {lufs.tolist()}")
    return launches


def phase_card_vs_cpu(ds, dev):
    from audiotools_tpu_torch.core import util

    items = util.collate([ds[i] for i in range(N_CHECK)])
    for fast_meter, method, tol in (
        (False, "matmul", CHAIN_TOL["matmul"]),
        (False, "matmul_bf16", CHAIN_TOL["matmul_bf16"]),
        (True, "matmul_bf16_fused", CHAIN_TOL["matmul_bf16"]),
    ):
        with meter(fast_meter):
            a_gpu, m_gpu, l_gpu = (t.cpu() for t in run_chain(
                ds, util.prepare_batch(items, dev), synthesis_method=method))
            a_cpu, m_cpu, l_cpu = run_chain(
                ds, util.prepare_batch(items, "cpu"), synthesis_method=method)
        err = {
            "audio_abs": float((a_gpu - a_cpu).abs().max()),
            "mel_rel": float((m_gpu - m_cpu).abs().max() / m_cpu.abs().max()),
            "lufs_db": float((l_gpu - l_cpu).abs().max()),
        }
        print(f"[card vs cpu] {N_CHECK} clips, meter {'FIR' if fast_meter else 'exact'}, "
              f"synthesis {method}: " + ", ".join(
                  f"{k} {v:.3e} (tol {tol[k]:g})" for k, v in err.items()))
        for k, v in err.items():
            expect(v <= tol[k], f"card vs CPU {k} {v:.3e} > {tol[k]:g} ({method})")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_device()
    phase_defaults()
    a = phase_kernel_a(dev)
    b = phase_kernel_b(dev)
    c = phase_kernel_c(dev)
    d, planes = phase_kernel_d(dev)
    e, _ = phase_kernel_e(dev)
    phase_ragged(dev)
    launches = {"rotation": phase_rotation(planes)}
    del planes
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        build_fixture_tree(root)
        ds = make_dataset(root, BATCH)
        from audiotools_tpu_torch.data import DataLoader

        t0 = time.perf_counter()
        batch = next(iter(DataLoader(ds, batch_size=BATCH, num_workers=8)))  # to the card by default
        torch.cuda.synchronize()
        print(f"[chain] first batch through DataLoader (8 workers, staged to the card): "
              f"{time.perf_counter() - t0:.2f} s")
        expect(batch["signal"].device.type == "cuda",
               f"the loader staged the batch on {batch['signal'].device}, not the card")
        launches.update({label: phase_chain(ds, batch, label, *rest) for label, *rest in PATHS})
        phase_card_vs_cpu(ds, dev)
    if FAILED:
        fail(f"{len(FAILED)} failed checks: {FAILED}")

    def row(name, source, line, path, results, key=None):
        """``results``: {shape label: measurements}, reported at ``key``, or
        the measurements of one shape."""
        if key is None:
            results, key = {key: results}, key
        at = results[key]
        return {"name": name, "route": "cuda", "source": f"audiotools_tpu_torch/csrc/{source}",
                "replaces": f"audiotools_tpu/ops/pallas_kernels.py:{line}",
                "launches": launches[path][name],
                "max_abs_err": max(v["abs_err"] for v in results.values()),
                **{k: at[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                                      "library", "library_ms")}}

    kernels = [
        row("fir_causal_batch", "fir_causal_batch.cu", 182, "main", a, "equalizer"),
        row("phase_vocoder_fused", "phase_vocoder.cu", 309, "main", b, "path"),
        row("fir_causal", "fir_causal_batch.cu", 100, "parity", c, "meter"),
        # D has no caller in the library: its own path is its entry point
        row("rotation_cumprod", "rotation_cumprod.cu", 417, "rotation", d),
        row("istft_synthesis_fused", "istft_synthesis.cu", 527, "parity", e, "chain"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
