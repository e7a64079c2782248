"""Build the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, cached in ``_build/``
under a hash of the source and the flags, and loaded with ``ctypes``.
A failed build raises with nvcc's output: nothing falls back.
``build_all`` runs one nvcc per source, all at once.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("fir_causal_batch", "phase_vocoder", "rotation_cumprod", "istft_synthesis")
# Per-source flags. The phasor recurrences (kernels B and D) compound
# rounding over every step, so their products and sums round one by one,
# as in the plain PyTorch versions (no FMA contraction); no source uses
# fast math.
EXTRA_FLAGS = {"phase_vocoder": ["--fmad=false"], "rotation_cumprod": ["--fmad=false"]}

BUILD_SECONDS = {}  # name -> seconds spent in nvcc by this process
_libs = {}
_locks = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from csrc/ on a machine "
        "with the CUDA toolkit (PATH or /usr/local/cuda/bin)"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to for the current source and flags."""
    flags = FLAGS + EXTRA_FLAGS.get(name, [])
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _compile(name: str, out: Path):
    cmd = [_nvcc(), *FLAGS, *EXTRA_FLAGS.get(name, [])]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd += ["-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<name>.cu``, built if needed.
    Different sources build concurrently; one source builds once."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _libs:
            out = library_path(name)
            if not out.exists():
                _compile(name, out)
            _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]


def build_all(names=SOURCES) -> dict:
    """Build and load every source in ``names`` with one nvcc each, all
    started together; raises the first failure."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(library, names)))
