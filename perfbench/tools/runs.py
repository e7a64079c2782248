"""Run a cell of the benchmark several times, one process after another, and
summarise the runs: each run's result line, then for every metric the
median and the spread (the distance between the first and the third
quartile of ``statistics.quantiles(values, n=4)`` over the median).

    python3 perfbench/tools/runs.py --workload <name> --seeds 11 12 13 \
        [--seconds 10] [--trace 0] [--out chiprun_out/runs.jsonl]

Each run is ``python3 perfbench/run.py`` from the checkout's root. The
results are appended to ``--out`` as JSON lines with the seed, the exit code
and the tail of standard error.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("nan")


def run_once(workload, seed, seconds, trace):
    cmd = [sys.executable, "perfbench/run.py", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    result = None
    if p.returncode == 0 and lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    return {"workload": workload, "seed": seed, "seconds": seconds, "trace": trace,
            "rc": p.returncode, "wall_s": wall, "result": result,
            "stderr_tail": p.stderr[-3000:]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/runs.jsonl")
    args = ap.parse_args()
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    records = []
    for seed in args.seeds:
        rec = run_once(args.workload, seed, args.seconds, args.trace)
        records.append(rec)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        r = rec["result"]
        print(f"[{args.workload} seed {seed} trace {args.trace}] rc {rec['rc']} wall "
              f"{rec['wall_s']:.1f} s " + (json.dumps(r) if r else rec["stderr_tail"][-1500:]),
              flush=True)
    values = {}
    for rec in records:
        if rec["result"]:
            for k, v in rec["result"]["metrics"].items():
                values.setdefault(k, []).append(v["value"])
    for k, vs in values.items():
        print(f"[{args.workload}] {k}: n {len(vs)} median {statistics.median(vs):.6g} "
              f"spread {spread(vs):.4%} values {vs}", flush=True)


if __name__ == "__main__":
    main()
