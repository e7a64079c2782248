"""Seeded clip generators, copied from ``chip_smoke.py`` (speech-like,
noise-like and impulse-response-like signals at 44.1 kHz), and the writer of
a fixture tree of WAV files that the program's ``AudioLoader`` reads.

Every generator takes a 32-bit seed; ``sub_seeds`` derives them from the
run's ``--seed``, which may be larger.
"""
import csv
from pathlib import Path

import numpy as np

SR = 44100


def sub_seeds(seed: int, n: int, salt: int = 0):
    """``n`` 32-bit seeds drawn from ``seed`` (any non-negative integer)."""
    rng = np.random.default_rng([int(seed), int(salt)])
    return [int(s) for s in rng.integers(0, 2**31 - 1, size=n)]


def speech_like(seed, duration=12.0, sr=SR):
    rng = np.random.RandomState(seed)
    n = int(duration * sr)
    t = np.arange(n) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.4 * t + rng.rand() * 6)
    phase = np.cumsum(2 * np.pi * f0 / sr)
    sig = np.zeros(n)
    for h, a in [(1, 1.0), (2, 0.6), (3, 0.4), (4, 0.25), (5, 0.12)]:
        sig += a * np.sin(h * phase + rng.rand() * 6)
    noise = rng.randn(n) * 0.15
    am = 0.5 * (1 + np.sin(2 * np.pi * 2.5 * t + rng.rand() * 6))
    am = am * (rng.rand(n) < 0.999)
    return ((sig * am + noise * am) * 0.15).astype(np.float32)


def noise_like(seed, duration=12.0, sr=SR):
    rng = np.random.RandomState(seed)
    b = np.exp(-np.arange(64) / 16.0)
    return (np.convolve(rng.randn(int(duration * sr)), b / b.sum(), mode="same") * 0.2).astype(
        np.float32)


def ir_like(seed, duration=1.0, sr=SR):
    rng = np.random.RandomState(seed)
    n = int(duration * sr)
    out = np.zeros(n, dtype=np.float32)
    out[64] = 1.0
    out[65:] = 0.25 * rng.randn(n - 65) * np.exp(-np.linspace(0, 9, n - 65))
    return out


def tone_like(seed, duration=12.0, sr=SR):
    """A few steady partials with a slow vibrato: a music-like clip."""
    rng = np.random.RandomState(seed)
    n = int(duration * sr)
    t = np.arange(n) / sr
    sig = np.zeros(n)
    for _ in range(4):
        f = 110.0 * 2 ** (rng.rand() * 4)
        sig += rng.rand() * np.sin(2 * np.pi * f * t + 0.002 * f * np.sin(2 * np.pi * 5 * t)
                                   + rng.rand() * 6)
    return (0.1 * sig / max(1e-9, np.abs(sig).max())).astype(np.float32)


GENERATORS = {"speech": speech_like, "noise": noise_like, "ir": ir_like, "tone": tone_like}


def write_fixture_tree(root: Path, groups: dict, seed: int, sr: int = SR):
    """Write ``groups`` (``{name: {"kind", "count", "seconds"}}``) as WAV files
    under ``root/<name>/`` with a ``root/<name>.csv`` list each, generated
    from ``seed``. Returns ``{name: csv path}``."""
    from audiotools_tpu_torch.io import write_wav

    lists = {}
    for g, (name, spec) in enumerate(sorted(groups.items())):
        seeds = sub_seeds(seed, spec["count"], salt=1000 + g)
        (root / name).mkdir(parents=True)
        lists[name] = root / f"{name}.csv"
        with open(lists[name], "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["path"])
            writer.writeheader()
            for i, s in enumerate(seeds):
                clip = GENERATORS[spec["kind"]](s, spec["seconds"], sr)
                path = root / name / f"{name}_{i}.wav"
                write_wav(path, clip[None, :], sr)
                writer.writerow({"path": str(path)})
    return lists
