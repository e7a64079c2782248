"""Run one cell of the benchmark of ``audiotools_tpu_torch`` on the CUDA card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json``; its configuration
(``perfbench/configs/<config>.json``) holds the sizes; its traffic mix
(``perfbench/mixes/<traffic>.json``) holds the mix's parameters and names the
driver (``perfbench/drivers/<driver>.py``) that sets the path up, runs it in a
closed loop for ``--seconds`` and checks what the window produced against
the plain reference. With ``--trace 0`` the result holds the cell's
end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` and the result holds the cell's per-layer metrics, each
read by ``perfbench/metrics/<metric>.py``, which may find nothing to read.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: every number compared with its limit);
the last lines of standard error repeat the numbers compared. A run without a
CUDA card, with fewer cards than the cell asks for, or whose process holds JAX
or the JAX package once the window has closed exits non-zero and prints no
result.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audiotools_tpu")


def fail(message: str, code: int = 2):
    print(f"perfbench: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, workload: str):
    """The cell, its configuration, its mix and the metric entries it
    reports, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        fail(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    mix = load_json(BENCH / "mixes" / f"{cell['traffic']}.json")

    def reported(metrics):
        return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]

    return cell, config, mix, reported(bench["end_to_end"]), reported(bench["per_layer"])


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def set_environment():
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into ``audiotools_tpu_torch/_build``), and one
    thread for the host's math libraries: the load is this process's one
    thread dispatching to the card."""
    cache = ROOT / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "1"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None):
    args = parse_args(argv)
    set_environment()
    sys.path.insert(0, str(ROOT))
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, config, mix, end_to_end, per_layer = cell_of(bench, args.workload)

    import torch

    torch.set_num_threads(1)
    imported = time.perf_counter() - START
    if not torch.cuda.is_available():
        fail("no CUDA card: this benchmark runs only on the card")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell needs {cell['chips']} cards, {torch.cuda.device_count()} present")
    torch.cuda.set_device(0)
    print(f"perfbench: set-up: imports {imported:.2f} s", file=sys.stderr)
    result, compared = execute(args, cell, config, mix, end_to_end, per_layer)
    found = forbidden_modules()
    if found:
        fail(f"the process holds {found} after the window; the benchmark runs the "
             "PyTorch port alone", code=3)
    for name, v, limit in compared:
        print(f"compared {name} {v:.6g} limit {limit:.6g}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def execute(args, cell, config, mix, end_to_end, per_layer):
    """Set up, run the window, check it and read the metrics: ``(result,
    compared)``. Runs on whatever device ``harness.device`` finds; ``main``
    has made sure it is the card."""
    from perfbench.harness import device as dev
    from perfbench.harness import trace as _trace
    from perfbench.harness.spans import Spans

    driver = load_module(BENCH / "drivers" / f"{mix['driver']}.py",
                         f"perfbench.drivers.{mix['driver']}")
    spans = Spans(traced=bool(args.trace))
    state = driver.setup(config, mix, args.seed, spans)
    dev.synchronize()
    setup_s = time.perf_counter() - START
    setup_peak = dev.peak_bytes()
    dev.reset_peak()
    # the set-up's objects leave the collector's young generations
    gc.collect()
    gc.freeze()

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.on_card() else [])
        prof = profile(activities=activities)
        prof.__enter__()
    try:
        with spans.span(_trace.WINDOW):
            window = driver.window(state, args.seconds, spans)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    window_peak = dev.peak_bytes()
    trace = _trace.read(prof) if prof is not None else None
    try:
        compared = driver.check(state, window)  # [(name, value, limit)]
        correct = all(math.isfinite(v) and v <= limit for _, v, limit in compared)

        device = {"platform": "gpu", "kind": dev.name(), "count": cell["chips"],
                  "memory_peak_bytes": max(setup_peak, window_peak)}
        result = {"correct": bool(correct), "attempted": int(window["attempted"]),
                  "failed": int(window["failed"]) + (0 if correct else 1)}
        if args.trace:
            context = dict(trace=trace, spans=spans, window=window, config=config, mix=mix,
                           cell=cell, state=state)
            metrics = {}
            for m in per_layer:
                reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                     f"perfbench.metrics.{m['name']}")
                value = reader.read(context)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            device["busy_s"] = trace.busy_s()
            device["window_s"] = trace.window_s
            result["metrics"] = metrics
            result["device"] = device
            result["breakdown"] = {"device_ops": trace.top_device_ops(),
                                   "idle_gaps": trace.idle_gaps()}
        else:
            values = dict(window["metrics"], setup_s=setup_s,
                          peak_mem_gib=window_peak / 2**30)
            result["metrics"] = {m["name"]: {"value": float(values[m["name"]]),
                                             "unit": m["unit"]} for m in end_to_end}
            result["device"] = device
        result["compared"] = {name: {"value": float(v), "limit": float(limit)}
                              for name, v, limit in compared}
    finally:
        driver.close(state)
    return result, compared


if __name__ == "__main__":
    main()
