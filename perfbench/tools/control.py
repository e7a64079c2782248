"""Readings that set a cell's limits: for each seed, in one process, the
program's numbers after a short window at the cell's own size, and the
control's (the reference computed a precision lower, in the program's
place), each beside the cell's limit.

    python3 perfbench/tools/control.py --workload <name> --seeds 1 2 3 \
        [--seconds 3] [--out chiprun_out/control.jsonl]

Not part of a benchmark run; run it on the card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--faults", action="store_true", help="also the driver's planted faults")
    ap.add_argument("--out", default="chiprun_out/control.jsonl")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from perfbench import run
    from perfbench.harness import device as dev
    from perfbench.harness.spans import Spans

    run.set_environment()
    bench = run.load_json(ROOT / "BENCHMARK.json")
    cell, config, mix, _, _ = run.cell_of(bench, args.workload)
    driver = run.load_module(run.BENCH / "drivers" / f"{mix['driver']}.py",
                             f"perfbench.drivers.{mix['driver']}")
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        state = driver.setup(config, mix, seed, Spans(False))
        try:
            window = driver.window(state, args.seconds, Spans(False))
            program = {name: v for name, v, _ in driver.check(state, window)}
            control = {} if args.no_control else driver.control(state)
            faults = driver.faults(state) if args.faults and hasattr(driver, "faults") else {}
            look = state.get("look")
        finally:
            driver.close(state)
        dev.empty_cache()
        rec = {"workload": args.workload, "seed": seed, "device": dev.name(),
               "attempted": window["attempted"], "program": program, "look": look,
               "control": control, "faults": faults,
               "limits": mix["limits"], "seconds": time.perf_counter() - t0}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
