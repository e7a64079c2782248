"""Build the port's CUDA kernels and host codec libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``),
and each ``native/<name>.cpp`` (the WAV, FLAC and libav readers) by the
host's ``g++``, into a shared library with a plain C interface, cached in
``_build/`` under a hash of the source and the flags, and loaded with
``ctypes``. A failed build raises with the compiler's output: nothing
falls back. ``build_all`` runs one nvcc per source, all at once.
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
NATIVE = _PKG / "native"
BUILD_DIR = _PKG / "_build"

FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("fir_causal_batch", "phase_vocoder", "rotation_cumprod", "istft_synthesis",
           "iir_block_scan", "snake")
# Per-source flags. The phasor recurrences (kernels B and D) compound
# rounding over every step, so their products and sums round one by one,
# as in the plain PyTorch versions (no FMA contraction); no source uses
# fast math. Snake (kernel G) rounds each of its own products by intrinsic
# and keeps the default, so that its sinf compiles as PyTorch's does.
EXTRA_FLAGS = {"phase_vocoder": ["--fmad=false"], "rotation_cumprod": ["--fmad=false"]}
# Compile-time geometry of kernels B, D, F and G, passed to nvcc as -D
# flags. The launch plans (ops/hopper_kernels.py::pv_plan, rotation_plan,
# scan_plan, snake_plan) read it here, so that a kernel and its plan take it
# from one place: B's rows a block and prefetch depth in steps; D's rows a
# block, steps a tile and tiles in its ring; F's rows a block, bytes of its
# input ring a thread and deepest prefetch in steps; G's threads a block and
# 16-byte loads a lane.
DEFINES = {
    "phase_vocoder": {"PV_THREADS": 512, "PV_DEPTH": 16},
    "rotation_cumprod": {"ROT_ROWS": 128, "ROT_STEPS": 32, "ROT_STAGES": 3},
    "iir_block_scan": {"SCAN_THREADS": 32, "SCAN_RING_BYTES": 512, "SCAN_DEPTH": 32},
    "snake": {"SNAKE_THREADS": 256, "SNAKE_UNROLL": 4},
}

# The host libraries: g++'s flags and link libraries for each
# ``native/<name>.cpp``, those the JAX package builds its copies with.
HOST_FLAGS = {
    "wavio": ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC", "-std=c++17",
              "-pthread"],
    "flacio": ["-O3", "-shared", "-fPIC", "-std=c++17"],
    "avio": ["-O3", "-shared", "-fPIC", "-std=c++17"],
}
HOST_LIBS = {"avio": ["-lavformat", "-lavcodec", "-lavutil"]}

BUILD_SECONDS = {}  # name -> seconds spent in nvcc or g++ by this process
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


def gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError(
        "g++ not found: the host codec libraries are built from native/ with the "
        "system C++ compiler"
    )


def flags(name: str) -> list:
    """nvcc's flags for ``csrc/<name>.cu``: the common ones, its own, and its
    geometry as -D flags."""
    geometry = [f"-D{k}={v}" for k, v in DEFINES.get(name, {}).items()]
    return FLAGS + EXTRA_FLAGS.get(name, []) + geometry


def _cached(source: Path, args: list) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(args).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to for the current source and flags."""
    return _cached(CSRC / f"{name}.cu", flags(name))


def host_library_path(name: str) -> Path:
    """Where ``native/<name>.cpp`` builds to for the current source and flags."""
    return _cached(NATIVE / f"{name}.cpp", HOST_FLAGS[name] + HOST_LIBS.get(name, []))


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _compile(name: str, out: Path, head: list, tail: list):
    """Run ``head -o <tmp> tail`` and move the library to ``out``; the
    compiler's output goes beside it in ``<out>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [*head, "-o", tmp, *tail]
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(head[0]).name} failed building {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(name: str, command) -> ctypes.CDLL:
    """The loaded library ``name``; on the first call, built (if its cached
    file is missing) by ``command()`` -> ``(out, head, tail)``. A loaded
    library returns at once: a kernel's wrapper asks for it every launch."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _libs:
            out, head, tail = command()
            if not out.exists():
                _compile(name, out, head, tail)
            _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<name>.cu``, built if needed.
    Different sources build concurrently; one source builds once."""
    return _load(name, lambda: (library_path(name), [_nvcc(), *flags(name)],
                                [str(CSRC / f"{name}.cu")]))


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library for ``native/<name>.cpp``, built with g++ if
    needed; a failed build raises with g++'s output."""
    return _load(name, lambda: (host_library_path(name), [gxx(), *HOST_FLAGS[name]],
                                [str(NATIVE / f"{name}.cpp"), *HOST_LIBS.get(name, [])]))


def build_all(names=SOURCES) -> dict:
    """Build and load every source in ``names`` with one nvcc each, all
    started together; raises the first failure."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(library, names)))
