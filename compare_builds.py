"""Time experiment builds of kernels B and D beside the committed ones, on one card.

    python3 compare_builds.py DIR [--out FILE] [--sass DIR]

Each ``DIR/pv_*.cu`` is built as kernel B and each ``DIR/rot_*.cu`` as kernel
D, with the committed source's nvcc flags (``_build.flags``, the geometry's
-D flags included), and must export the committed C entry point with its
signature (a copy of an earlier design takes the launch plan's arguments
and ignores them). At the main path's shapes (``chip_smoke.pv_main_case``:
B at (64, 1, 1025, 384) -> 432 steps, with and without the phasor track;
``chip_smoke.rotation_main_case``: D at 65,600 x 432) every build and the
committed kernel run with the committed launch plan. Each output is held
against the plain version and its max abs error printed; a build that
computes something else (a loads-and-stores-only copy) is timed all the
same. Every build is timed with ``chip_smoke.time_ms`` in turns, all builds
in order and then in reverse, beside a ``copy_`` of the same bytes and, for
D, ``torch.cumprod``. ``--out`` writes the results as JSON; ``--sass``
writes ``cuobjdump -sass`` of every library into a directory.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as CS
from audiotools_tpu_torch import _build
from audiotools_tpu_torch.ops import hopper_kernels as HK

N_TIMED = 20
ENTRY = {"phase_vocoder": "phase_vocoder_fused", "rotation_cumprod": "rotation_cumprod"}


def build(src: Path, kind: str, out_dir: Path) -> Path:
    out = out_dir / f"lib{src.stem}.so"
    cmd = [_build._nvcc(), *_build.flags(kind), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    print(f"[build] {src.name}: {ptxas(proc.stdout + proc.stderr)}", flush=True)
    return out


def ptxas(log: str) -> str:
    return " | ".join(ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                      if "Used" in ln or "spill" in ln)


def entry(lib_path, kind):
    name = ENTRY[kind]
    fn = getattr(ctypes.CDLL(str(lib_path)), name)
    fn.argtypes = HK._SIGNATURES[name][1]
    fn.restype = ctypes.c_int
    return fn


def checked(err):
    if err != 0:
        raise RuntimeError(f"kernel launch failed with CUDA error {err}")


def copy_ms(label, nbytes, dev):
    """A device-to-device copy that reads and writes ``nbytes`` in all."""
    src = torch.empty(int(nbytes) // 8, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    ms = CS.time_ms(lambda: dst.copy_(src), N_TIMED)
    print(f"[{label}] copy_ of {nbytes / 2e6:.1f} MB (the same bytes read and written): "
          f"{ms:.4f} ms", flush=True)
    return ms


def pv_cases(dev):
    """(label, launch(fn), outputs, reference, bytes) for B's two variants."""
    z, i0, i1, frac = CS.pv_main_case(dev)
    *lead, F, T = z.shape
    items, n = int(np.prod(lead)), len(i0)
    zt = z.reshape(items, F, T).transpose(1, 2).contiguous()
    t0, t1, tf = (torch.from_numpy(a).to(dev) for a in (i0, i1, frac))
    cases = []
    for with_phasor in (False, True):
        want = HK.phase_vocoder_fused_plain(z, i0, i1, frac, with_phasor=with_phasor)
        want = [w.reshape(items, F, n).transpose(1, 2) for w in (want if with_phasor else (want,))]
        outs = [torch.empty(items, n, F, dtype=torch.complex64, device=dev) for _ in want]
        plan = HK.pv_plan(items * F, with_phasor)

        def launch(fn, outs=outs, plan=plan, with_phasor=with_phasor):
            return lambda: checked(fn(
                zt.data_ptr(), t0.data_ptr(), t1.data_ptr(), tf.data_ptr(), outs[0].data_ptr(),
                outs[1].data_ptr() if with_phasor else None, items, F, T, n, plan.sync_every,
                plan.smem, plan.blocks, torch.cuda.current_stream().cuda_stream))

        nbytes = 8.0 * items * F * (T + n * (1 + with_phasor)) + 12.0 * n
        cases.append(("B with_phasor" if with_phasor else "B path", launch, outs, want, nbytes))
    return cases


def rotation_case(dev):
    ur, ui, cr, ci = CS.rotation_main_case(dev)
    rows, n = ur.shape
    want = HK.rotation_cumprod_plain(ur, ui, cr, ci)
    outs = [torch.empty_like(ur), torch.empty_like(ui)]
    plan = HK.rotation_plan(rows, n)

    def launch(fn):
        return lambda: checked(fn(
            ur.data_ptr(), ui.data_ptr(), cr.data_ptr(), ci.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), rows, n, int(plan.wide), plan.smem, plan.blocks,
            torch.cuda.current_stream().cuda_stream))

    u = torch.complex(ur, ui)
    library_ms = CS.time_ms(lambda: torch.cumprod(u, dim=-1), N_TIMED)
    del u
    return ("D", launch, outs, want, 4.0 * rows * (4 * n + 2)), library_ms


def compare(label, builds, launch, outs, want, nbytes):
    """builds: [(name, fn)]; every build checked, then timed in turns."""
    calls, results = {}, {}
    for name, fn in builds:
        call = launch(fn)
        call()
        torch.cuda.synchronize()
        calls[name] = call
        results[name] = {"max_abs_err": max(float((o - w).abs().max()) for o, w in zip(outs, want)),
                         "ms": []}
    for name in list(calls) + list(reversed(calls)):
        results[name]["ms"].append(CS.time_ms(calls[name], N_TIMED))
    bound_ms = nbytes / CS.HBM_BYTES * 1e3
    for name, r in results.items():
        r["mean_ms"] = float(np.mean(r["ms"]))
        r["share_of_bound"] = bound_ms / r["mean_ms"]
        turns = ", ".join(f"{m:.4f}" for m in r["ms"])
        print(f"[{label}] {name:24s}: {r['mean_ms']:.4f} ms ({turns}) | {r['share_of_bound']:.1%} "
              f"of {bound_ms:.4f} | max_abs_err {r['max_abs_err']:.3e}", flush=True)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dir", type=Path)
    parser.add_argument("--out", type=Path)
    parser.add_argument("--sass", type=Path)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("compare_builds: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} | {smi}", flush=True)

    out_dir = args.dir / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"phase_vocoder": sorted(args.dir.glob("pv_*.cu")),
               "rotation_cumprod": sorted(args.dir.glob("rot_*.cu"))}
    _build.build_all(tuple(sources))
    for kind in sources:
        print(f"[build] committed {kind}: {ptxas(_build.build_log(kind))}", flush=True)
    with ThreadPoolExecutor(max_workers=8) as pool:
        libs = {kind: list(zip(srcs, pool.map(lambda s, k=kind: build(s, k, out_dir), srcs)))
                for kind, srcs in sources.items()}
    if args.sass:
        args.sass.mkdir(parents=True, exist_ok=True)
        cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
        paths = [_build.library_path(k) for k in sources] + [p for v in libs.values() for _, p in v]
        for p in paths:
            dump = subprocess.run([str(cuobjdump), "-sass", str(p)], capture_output=True, text=True)
            (args.sass / f"{p.stem}.sass").write_text(dump.stdout + dump.stderr)

    def builds(kind):
        return [(src.stem, entry(p, kind)) for src, p in libs[kind]] + [
            ("committed", entry(_build.library_path(kind), kind))]

    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    for label, launch, outs, want, nbytes in pv_cases(dev):
        report[label] = compare(label, builds("phase_vocoder"), launch, outs, want, nbytes)
        report[label]["copy_"] = {"mean_ms": copy_ms(label, nbytes, dev)}
    (label, launch, outs, want, nbytes), library_ms = rotation_case(dev)
    report[label] = compare(label, builds("rotation_cumprod"), launch, outs, want, nbytes)
    report[label]["copy_"] = {"mean_ms": copy_ms(label, nbytes, dev)}
    report[label]["torch.cumprod"] = {"mean_ms": library_ms}
    print(f"[{label}] torch.cumprod (complex64, inclusive): {library_ms:.4f} ms", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
