"""Smoke run of the PyTorch port's augmentation path on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``audiotools_tpu_torch/csrc`` and
runs, on card 0:

1. the device, its name and power limit (``nvidia-smi``), the kernel build;
2. kernel A (per-item causal FIR) against its plain PyTorch version at the
   equalizers' shapes (64 rows of 5 s or 1 s at 44.1 kHz; 641 or 231 taps);
3. kernel B (fused phase vocoder) against its plain version at the pitch
   shift's shape (64 x 1 x 1025 bins, 384 frames -> 432 steps);
4. the main path: AudioDataset -> DataLoader -> Compose(RoomImpulseResponse,
   BackgroundNoise, Equalizer, VolumeNorm) -> pitch_shift(+2 st) -> mel-80
   -> BS.1770 loudness on 64 clips of 5 s at 44.1 kHz, timed with CUDA
   events, and checks that it launched both kernels;
5. the same chain on the card and on the CPU (plain versions) for the
   first 4 clips, against stated tolerances.

Any failed check exits non-zero. The last lines are the kernel table, the
card's name and power limit, and ``{"ok": true, "device": ...}``. Without a
CUDA device the script exits non-zero and prints no result.
"""
import csv
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SR = 44100
BATCH = 64
DURATION = 5.0
N_ITER = 5
N_CHECK = 4

# kernel vs plain version on the card, relative to the largest output
KERNEL_RTOL = 1e-5
# chain on the card vs on the CPU (first N_CHECK clips). With fp32
# synthesis both sides sum in fp32 in different orders. With the path's
# bf16 synthesis, a spectrum value that lies within fp32 rounding of a bf16
# rounding boundary goes to different bf16 neighbours on the two sides,
# which moves it by one bf16 ulp, 2**-8 ~ 3.9e-3 of itself: the bound for
# the largest outputs.
CHAIN_TOL = {
    "matmul": {"audio_abs": 1e-4, "mel_rel": 1e-4, "lufs_db": 0.01},
    "matmul_bf16": {"audio_abs": 4e-3, "mel_rel": 4e-3, "lufs_db": 0.01},
}


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


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


def compare_kernel(name, kernel, plain, n_kernel, n_plain):
    """Kernel vs plain on the same inputs: error and times, measured in
    turns (plain, kernel, kernel, plain)."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
    check(all(bool(torch.isfinite(g).all()) for g in got), f"{name}: non-finite output")
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
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {card}")
    for source in ("fir_causal_batch", "phase_vocoder"):
        t0 = time.perf_counter()
        _build.library(source)
        ptxas = [ln.strip() for ln in _build.build_log(source).splitlines() if "registers" in ln]
        print(f"[build] {source}: {time.perf_counter() - t0:.2f} s (nvcc "
              f"{_build.BUILD_SECONDS.get(source, 0.0):.2f} s) {' | '.join(ptxas)}")
    return card


def phase_kernel_a(dev):
    from audiotools_tpu_torch.ops import hopper_kernels as HK

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
        print(f"[kernel A] {label} ({rows}, {T}) x {L} taps: max_abs_err {abs_err:.3e} "
              f"rel {rel_err:.3e} (tol {KERNEL_RTOL:g}) | kernel {ms:.4f} ms "
              f"({gflop / ms:.2f} TFLOP/s) | plain {plain_ms:.4f} ms")
        check(rel_err < KERNEL_RTOL, f"kernel A disagrees with its plain version ({label})")
        results[label] = (abs_err, ms, plain_ms)
    return results


def phase_kernel_b(dev):
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops import stretch as PS

    rng = np.random.RandomState(2)
    shape = (BATCH, 1, 1025, 384)
    z = torch.from_numpy(
        (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    ).to(dev)
    i0, i1, frac = PS._pv_indices(shape[-1], 2.0 ** (-2.0 / 12.0))
    abs_err, rel_err, ms, plain_ms = compare_kernel(
        "phase_vocoder_fused",
        lambda: HK.phase_vocoder_fused(z, i0, i1, frac, with_phasor=True),
        lambda: HK.phase_vocoder_fused_plain(z, i0, i1, frac, with_phasor=True), 10, 2,
    )
    gbytes = 8.0 * np.prod(shape[:-1]) * (2 * len(i0) + 2 * len(i0)) / 1e9
    print(f"[kernel B] {shape} -> {len(i0)} steps (with phasor): max_abs_err {abs_err:.3e} "
          f"rel {rel_err:.3e} (tol {KERNEL_RTOL:g}) | kernel {ms:.4f} ms "
          f"(~{gbytes / ms:.1f} TB/s of frame traffic) | plain {plain_ms:.4f} ms")
    check(rel_err < KERNEL_RTOL, "kernel B disagrees with its plain version")
    return abs_err, ms, plain_ms


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
    after each stage (chain, pitch shift, mel, loudness)."""
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


def phase_chain(ds, dev):
    from audiotools_tpu_torch.data import DataLoader
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    HK.reset_launch_counts()
    t0 = time.perf_counter()
    batch = next(iter(DataLoader(ds, batch_size=BATCH, num_workers=8, device=dev)))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    run_chain(ds, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stages = np.zeros(4)
    t0 = time.perf_counter()
    for _ in range(N_ITER):
        marks = []
        audio, mel, lufs = run_chain(ds, batch, marks=marks)
        torch.cuda.synchronize()
        stages += [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    wall_ms = (time.perf_counter() - t0) * 1000 / N_ITER
    launches = dict(HK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    stages /= N_ITER
    ms = float(stages.sum())
    print(f"[chain] first batch through DataLoader (8 workers, staged to the card): {load_s:.2f} s")
    print(f"[chain] {BATCH} x {DURATION:g} s @ {SR} Hz: {ms:.3f} ms/batch (CUDA events; "
          f"host wall {wall_ms:.3f} ms) | {BATCH / ms * 1000:.1f} clips/s | "
          f"{BATCH * DURATION / ms * 1000:.0f}x real time | peak {peak / 2**30:.3f} GiB")
    print("[chain] stages (ms): " + ", ".join(
        f"{n} {v:.3f}" for n, v in zip(("transforms", "pitch_shift", "mel", "loudness"), stages)))
    print(f"[chain] kernel launches in the main path ({N_ITER + 1} runs): {launches}")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    n_frames = 1 + int(SR * DURATION) // 512
    check(tuple(audio.shape) == (BATCH, 1, int(SR * DURATION)), f"audio shape {tuple(audio.shape)}")
    check(tuple(mel.shape) == (BATCH, 1, 80, n_frames), f"mel shape {tuple(mel.shape)}")
    check(tuple(lufs.shape) == (BATCH,), f"lufs shape {tuple(lufs.shape)}")
    for name, t in (("audio", audio), ("mel", mel), ("lufs", lufs)):
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    check(bool(((lufs > -40) & (lufs < -10)).all()), f"implausible loudness {lufs.tolist()}")
    return launches


def phase_card_vs_cpu(ds, dev):
    from audiotools_tpu_torch.core import util

    items = util.collate([ds[i] for i in range(N_CHECK)])
    for method, tol in CHAIN_TOL.items():
        a_gpu, m_gpu, l_gpu = (t.cpu() for t in run_chain(
            ds, util.prepare_batch(items, dev), synthesis_method=method))
        a_cpu, m_cpu, l_cpu = run_chain(
            ds, util.prepare_batch(items, "cpu"), synthesis_method=method)
        err = {
            "audio_abs": float((a_gpu - a_cpu).abs().max()),
            "mel_rel": float((m_gpu - m_cpu).abs().max() / m_cpu.abs().max()),
            "lufs_db": float((l_gpu - l_cpu).abs().max()),
        }
        print(f"[card vs cpu] {N_CHECK} clips, synthesis {method}: " + ", ".join(
            f"{k} {v:.3e} (tol {tol[k]:g})" for k, v in err.items()))
        for k, v in err.items():
            check(v <= tol[k], f"card vs CPU {k} {v:.3e} > {tol[k]:g} ({method})")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_device()
    a = phase_kernel_a(dev)
    b = phase_kernel_b(dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        build_fixture_tree(root)
        ds = make_dataset(root, BATCH)
        launches = phase_chain(ds, dev)
        phase_card_vs_cpu(ds, dev)

    kernels = [
        {"name": "fir_causal_batch", "route": "cuda",
         "source": "audiotools_tpu_torch/csrc/fir_causal_batch.cu",
         "replaces": "audiotools_tpu/ops/pallas_kernels.py:182",
         "launches": launches["fir_causal_batch"],
         "max_abs_err": max(v[0] for v in a.values()),
         "ms": a["equalizer"][1], "plain_ms": a["equalizer"][2]},
        {"name": "phase_vocoder_fused", "route": "cuda",
         "source": "audiotools_tpu_torch/csrc/phase_vocoder.cu",
         "replaces": "audiotools_tpu/ops/pallas_kernels.py:309",
         "launches": launches["phase_vocoder_fused"],
         "max_abs_err": b[0], "ms": b[1], "plain_ms": b[2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
