"""Dump the raw profiler events of one traced window of a cell, for reading
the trace offline (``harness.trace.from_events``).

    python3 perfbench/tools/trace_dump.py --workload <name> --seed <n> \
        [--out chiprun_out/trace_events.json]
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="chiprun_out/trace_events.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from perfbench import run
    from perfbench.harness import trace as T
    from perfbench.harness.spans import Spans

    run.set_environment()
    cell, config, mix, _, _ = run.cell_of(run.load_json(ROOT / "BENCHMARK.json"), args.workload)
    driver = run.load_module(run.BENCH / "drivers" / f"{mix['driver']}.py",
                             f"perfbench.drivers.{mix['driver']}")
    spans = Spans(traced=True)
    state = driver.setup(config, mix, args.seed, spans)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with spans.span(T.WINDOW):
                driver.window(state, 60.0, spans)
        events = T.events_of(prof)
    finally:
        driver.close(state)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"keys": T.EVENT_KEYS, "events": events,
                               "calls": {k: v for k, v in spans.calls.items()}}))
    trace = T.from_events(events)
    print(json.dumps({"n_events": len(events), "unlinked": trace.unlinked,
                      "range_ms": {k: v / 1e6 for k, v in trace.range_device_ns.items()},
                      "busy_s": trace.busy_s(), "window_s": trace.window_s}))


if __name__ == "__main__":
    main()
