"""The benchmark's files: every cell resolves its configuration, mix, driver
and metric readers by name; every per-layer metric's end-to-end metric is
reported where it is; the whole benchmark fits the time a check allows; no
file imports JAX or the JAX package, and the yardstick imports nothing of
the program."""
import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[k]}) == len(SPEC[k])
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_check_fits_its_time_at_full_size():
    """2 + 14 x cells runs of run_seconds + 60 s, 2 x 90 s of compiling a
    cell and 1200 s spare fit in 43200 s with 24 cells."""
    t = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (t + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_its_files(cell):
    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    config = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert (ROOT / config["file"]).is_file() and config["file"].startswith("perfbench/")
    mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text())
    assert (BENCH / "drivers" / f"{mix['driver']}.py").is_file()
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    e2e = [m["name"] for m in SPEC["end_to_end"] if _reported(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"] if _reported(m, cell)]
    assert layer
    for m in layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] in e2e, (m["name"], cell)


def test_config_files_are_their_own():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_and_a_yardstick_of_its_own(path):
    names = set(_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "audiotools_tpu"}, names
    if path.parent.name in ("reference", "work"):
        assert "audiotools_tpu_torch" not in names, names
