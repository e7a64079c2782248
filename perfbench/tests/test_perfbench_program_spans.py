"""The program's own spans in a traced window.

Synthetic event lists hold the benchmark's ranges, the program's ranges
(``audiotools.*``) and the program ranges' device-side annotation copies:
the existing readers and ``busy_s`` read the same with and without the
program's. ``harness.program`` maps the program's record of its spans onto
the trace's clock and its helpers add up by hand; a program without that
record reads nothing. On a tiny traced CPU run of each cell, the new
metrics find the program's spans.
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

from perfbench.harness import program  # noqa: E402
from perfbench.harness import trace as T  # noqa: E402
from perfbench.harness.spans import Spans  # noqa: E402

BENCH = Path(__file__).resolve().parents[1]
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
MAIN, AUTOGRAD = 1, 2
US = 1000  # ns


class Events:
    """Builds raw events (``trace.EVENT_KEYS``) in microseconds."""

    def __init__(self):
        self.events, self.corr = [], 100

    def range(self, name, start, end, thread=MAIN, device_copy=False):
        prefix = "perfbench." if not name.startswith("audiotools.") else ""
        self.corr += 1
        self.events.append((prefix + name, "user_annotation", False, start * US,
                            (end - start) * US, self.corr, 0, thread))
        if device_copy:  # the profiler's device-side copy of a range
            self.events.append((prefix + name, "gpu_user_annotation", True, start * US + 5 * US,
                                (end - start) * US, 0, self.corr, 0))

    def launch(self, at, start, duration, thread=MAIN, kernel="kernel"):
        """A runtime call at ``at`` on ``thread`` whose device operation runs
        from ``start`` for ``duration``."""
        self.corr += 1
        self.events.append(("cudaLaunchKernel", "cuda_runtime", False, at * US, 2 * US,
                            self.corr, 0, thread))
        self.events.append((kernel, "kernel", True, start * US, duration * US, self.corr, 0, 0))


def chain_like():
    """A window of two batches. Batch 1: transforms (Compose, VolumeNorm and
    its meter inside), then features (the features' meter); the device idles
    from 300 to 400 while the host is in the meter. Batch 2: a step on the
    backward thread. Returns the events with and without the program's
    ranges."""
    bench, prog = Events(), Events()
    bench.range("window", 0, 1000)
    bench.range("batch", 10, 600)
    bench.range("transforms", 10, 450, device_copy=True)
    bench.range("features", 450, 600, device_copy=True)
    bench.range("kernel.fir_causal_batch", 20, 60)
    prog.range("audiotools.transform.Compose", 15, 440, device_copy=True)
    prog.range("audiotools.transform.VolumeNorm", 200, 430, device_copy=True)
    prog.range("audiotools.loudness", 250, 420, device_copy=True)
    prog.range("audiotools.loudness", 460, 580, device_copy=True)
    prog.range("audiotools.backward", 650, 900)
    prog.range("audiotools.loudness", 295, 310, thread=AUTOGRAD)  # another thread
    bench.launch(30, 40, 100, kernel="fir")  # inside kernel.fir_causal_batch
    bench.launch(100, 150, 50)  # Compose, before VolumeNorm
    bench.launch(260, 270, 30)  # the meter: 270-300
    bench.launch(280, 400, 20)  # the meter: 400-420
    bench.launch(470, 480, 40)  # the features' meter: 480-520
    bench.launch(590, 600, 10)  # features, outside the meter
    bench.launch(700, 720, 80, thread=AUTOGRAD)  # the backward's, from autograd: 720-800
    events = bench.events + prog.events
    return events, bench.events


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


NEW = {"meter_host_ms.chain", "meter_host_ms.fir_chain", "meter_idle_ms.chain",
       "meter_idle_ms.fir_chain", "forward_idle_ms.train", "backward_idle_ms.train",
       "artifact_idle_ms.codec"}
EXISTING = sorted(m["name"] for m in SPEC["per_layer"] if m["name"] not in NEW)


def _context(trace):
    spans = Spans(traced=True)
    spans.records += [("batch", 0.0, 0.05), ("batch", 0.05, 0.08)]
    # one call of kernel A's entry point: 4 rows of 4,096 samples, 641 taps
    spans.calls["fir_causal_batch"].append(
        ([((4, 4096), "torch.float32"), ((4, 641), "torch.float32")], {}))
    return dict(trace=trace, spans=spans, window={"iterations": 2, "model_flops": 1e9},
                config={}, mix={}, cell={}, state={})


def test_the_new_metrics_are_the_issues():
    assert NEW <= {m["name"] for m in SPEC["per_layer"]}
    assert len(EXISTING) == 20


def test_existing_readers_read_the_same_with_the_programs_ranges():
    with_program, without = chain_like()
    a, b = T.from_events(with_program), T.from_events(without)
    assert a.window_ns == b.window_ns and a.device == b.device and a.unlinked == b.unlinked
    assert a.busy_s() == b.busy_s() and a.top_device_ops() == b.top_device_ops()
    for name in b.range_count:
        assert a.range_count[name] == b.range_count[name]
        assert a.range_device_ns.get(name) == b.range_device_ns.get(name)
    read = 0
    for name in EXISTING:
        reader = _reader(name)
        got, want = reader.read(_context(a)), reader.read(_context(b))
        assert got == want, name
        read += want is not None
    assert read >= 5  # the window's readers found something to read
    # the device-side copies are no device operations
    assert len(a.device) == 7 and not any(n.startswith("audiotools.") for _, _, n in a.device)


def _program_context(monkeypatch, host_at_s=5.0, drift=2e-4):
    """The synthetic window as a run's context: the benchmark's spans timed
    on the host's counter, which reads ``host_at_s`` where the trace's clock
    reads 0 and runs ``drift`` slower, and the program's record of its spans
    on that counter."""
    from audiotools_tpu_torch import _hostprof

    def host_ns(us):
        return host_at_s * 1e9 + us * US * (1 - drift)

    trace = T.from_events(chain_like()[1])
    context = _context(trace)
    context["spans"].records[:] = [
        (name, host_ns(start) / 1e9, host_ns(end) / 1e9) for name, start, end in (
            ("window", 0, 1000), ("batch", 10, 600), ("transforms", 10, 450),
            ("features", 450, 600), ("kernel.fir_causal_batch", 20, 60))]
    kept = [("transform.Compose", 15, 440, MAIN), ("transform.VolumeNorm", 200, 430, MAIN),
            ("loudness", 250, 420, MAIN), ("loudness", 460, 580, MAIN),
            ("backward", 650, 900, MAIN), ("loudness", 295, 310, AUTOGRAD),
            ("loudness", -900, -800, MAIN)]  # an earlier window's: left out
    monkeypatch.setattr(_hostprof, "ranges", lambda: [
        (name, round(host_ns(start)), round(host_ns(end)), tid)
        for name, start, end, tid in kept])
    return context


def test_program_ranges_map_onto_the_traces_clock(monkeypatch):
    ranges = program.program_ranges(_program_context(monkeypatch))
    assert [r[0] for r in ranges] == ["transform.Compose", "transform.VolumeNorm", "loudness",
                                      "loudness", "backward", "loudness"]
    # the drift is a line through the offsets at the benchmark's spans' starts
    assert ranges[2][1:] == (pytest.approx(250 * US, abs=1), pytest.approx(420 * US, abs=1))
    assert ranges[4][1:] == (pytest.approx(650 * US, abs=1), pytest.approx(900 * US, abs=1))


def test_one_late_offset_does_not_move_the_map(monkeypatch):
    context = _program_context(monkeypatch)
    records = context["spans"].records
    # six more spans on the host; the profiler opened one of them 2 ms late
    for i in range(6):
        host_start = records[0][1] + (100 + 100 * i) * 1e-6 * (1 - 2e-4)
        records.append((f"extra{i}", host_start, host_start + 1e-6))
        late = 2000 if i == 2 else 0
        context["trace"].ranges.append((f"extra{i}", (100 + 100 * i + late) * US,
                                        (101 + 100 * i + late) * US, MAIN))
    ranges = program.program_ranges(context)
    assert ranges[2][1:] == (pytest.approx(250 * US, abs=10), pytest.approx(420 * US, abs=10))


def test_program_helpers_add_up_by_hand(monkeypatch):
    context = _program_context(monkeypatch)  # 2 iterations
    meter = ["loudness"]
    # 250-420 and 460-580 on the main thread, 295-310 inside the first on
    # another: a union of 170 + 120 us
    assert program.host_ms(context, meter) == pytest.approx(0.290 / 2, rel=1e-3)
    # busy: 40-140, 150-200, 270-300, 400-420, 480-520, 600-610, 720-800
    # idle in the meter: 250-270, 300-400, 460-480, 520-580
    assert program.idle_ms(context, meter) == pytest.approx((0.020 + 0.100 + 0.020 + 0.060) / 2,
                                                            rel=1e-3)
    # Compose 15-440, less VolumeNorm 200-430: idle in 15-40, 140-150, 430-440
    assert program.idle_ms(context, ["transform.Compose"],
                           minus=["transform.VolumeNorm"]) == pytest.approx(0.045 / 2, rel=1e-3)
    # the backward: 650-900, busy 720-800 from the autograd thread
    assert program.idle_ms(context, ["backward"]) == pytest.approx(0.170 / 2, rel=1e-3)
    assert program.host_ms(context, ["dac.decoder"]) is None


def test_a_program_without_the_record_reads_nothing(monkeypatch):
    from audiotools_tpu_torch import _hostprof

    context = _program_context(monkeypatch)
    monkeypatch.delattr(_hostprof, "ranges")
    for name in sorted(NEW):
        assert _reader(name).read(context) is None, name


def test_the_mapped_spans_are_the_profilers_ranges():
    """On the CPU's profiler: the program's record, mapped through the
    benchmark's spans, lands within 0.5 ms of the ranges the trace holds (a
    first range's exit took 0.2 ms on a loaded CPU)."""
    from torch.profiler import ProfilerActivity, profile

    from audiotools_tpu_torch._hostprof import span

    spans = Spans(traced=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span(T.WINDOW):
            for _ in range(3):
                with spans.span("batch"):
                    with span("loudness"):
                        torch.ones(1000).sum()
                    torch.ones(1000).cumsum(0)
    events = T.events_of(prof)
    trace = T.from_events(events)
    context = dict(trace=trace, spans=spans, window={"iterations": 3})
    got = [r[1:] for r in program.program_ranges(context) if r[0] == "loudness"]
    want = sorted((e[3], e[3] + e[4]) for e in events if e[0] == "audiotools.loudness")
    assert len(got) == len(want) == 3
    for (a, b), (c, d) in zip(got, want):
        assert abs(a - c) < 5e5 and abs(b - d) < 5e5


def test_interval_arithmetic():
    merged = program._merged([(5, 9), (1, 3), (2, 4), (9, 10), (7, 7)])
    assert merged == [[1, 4], [5, 10]]
    assert program._subtract([[0, 10], [20, 30]], [[2, 3], [5, 22], [29, 40]]) == [
        [0, 2], [3, 5], [22, 29]]
    assert program._overlap_ns([[0, 10], [20, 30]], [[5, 25]]) == 10


def _new_metrics_of(cell):
    return {m["name"] for m in SPEC["per_layer"]
            if m["name"] in NEW and cell in m.get("workloads", [])}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_tiny_traced_run_reads_the_programs_ranges(cell):
    from perfbench.tests.test_perfbench_checks import execute

    result, _ = execute(cell, trace=1)
    assert result["correct"]
    new = _new_metrics_of(cell)
    assert new and new <= set(result["metrics"])
    if cell.startswith("augment."):
        host = result["metrics"][next(n for n in new if n.startswith("meter_host_ms."))]
        assert host["value"] > 0
