"""The port's training-harness decorators (``Mean``, ``when``, ``timer``,
``Tracker``), ``Experiment`` and ``_hostprof`` against the JAX package on
the CPU.

Tolerances: the Tracker's running means, history and ``is_best`` are held
equal (both sum the same Python floats in the same order); the host profiler
is held as the JAX package's own test holds it (sleeps of 20 ms, exclusive
totals within 18-60 ms).
"""
import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu_torch import _hostprof as hostprof
from audiotools_tpu_torch import ml
from audiotools_tpu_torch.ml import decorators as PD

SR = 44100


def _jd():
    from audiotools_tpu.ml import decorators as JD

    return JD


# -- Mean, when, timer ---------------------------------------------------------


@pytest.mark.parametrize("values", [[2.0, 4.0, float("nan"), 1.5], [float("inf"), -1.0, 3],
                                    [], [float("nan")]])
def test_mean_matches_jax(values):
    """Non-finite samples are dropped; an empty accumulator reads 0."""
    JD = _jd()
    ours, theirs = PD.Mean(), JD.Mean()
    for v in values:
        ours.update(v)
        theirs.update(v)
        assert ours() == theirs()
    ours.reset()
    assert ours() == 0


def test_when_gates_calls_like_jax():
    JD = _jd()
    calls = {"port": [], "jax": []}
    i = 0
    gated = {"port": PD.when(lambda: i % 3 == 0)(lambda: calls["port"].append(i) or "ran"),
             "jax": JD.when(lambda: i % 3 == 0)(lambda: calls["jax"].append(i) or "ran")}
    results = {"port": [], "jax": []}
    for i in range(7):
        for key, fn in gated.items():
            results[key].append(fn())
    assert calls["port"] == calls["jax"] == [0, 3, 6]
    assert results["port"] == results["jax"]


def test_timer_stamps_and_refuses_non_dicts():
    @PD.timer()
    def step():
        time.sleep(0.01)
        return {"loss": 1.0}

    @PD.timer("t")
    def bad():
        return 3

    out = step()
    assert set(out) == {"loss", "time/step"} and out["time/step"] >= 0.009
    with pytest.raises(TypeError):
        bad()
    assert ml.profiling.timer is PD.timer


# -- Tracker -------------------------------------------------------------------

def _feed(D, tracker, values, val_values):
    """Drive ``tracker`` through a train label logged by value and a val
    label logged by mean, as a training loop does."""

    @tracker.log("train", "value")
    @tracker.track("train", len(values), multihost_average=False)
    @D.timer()
    def train_step(step, v):
        tracker.step = step
        return dict(v)

    @tracker.log("val", "mean")
    @tracker.track("val", len(val_values), multihost_average=False)
    def val_step(v):
        return dict(v)

    outs = []
    with tracker.live:
        for step, v in enumerate(values):
            outs.append(train_step(step, v))
        for v in val_values:
            val_step(v)
        tracker.done("train", "epoch 0")
    return outs


def _train_values(array):
    """Per step: a Python float, an int, a one-element array of the package
    and a NaN now and then (dropped from the running mean)."""
    rng = np.random.RandomState(0)
    out = []
    for i in range(8):
        loss = float(1.0 / (i + 1) + 0.01 * rng.rand())
        out.append({"loss": array(np.float32(loss).reshape(1)), "count": i,
                    "acc": float("nan") if i % 3 == 2 else float(rng.rand()),
                    "note": "text"})
    return out


def _val_values(array):
    return [{"vloss": array(np.asarray([0.1 * (k + 1)], np.float32))} for k in range(3)]


def _plain(history):
    return {label: {k: list(v) for k, v in series.items()} for label, series in history.items()}


def _strip_time(history):
    return {label: {k: v for k, v in series.items() if not k.startswith("time/")}
            for label, series in history.items()}


def _assert_same_history(got, want):
    """Equal label by label and key by key, NaN equal to NaN."""
    assert {k: sorted(v) for k, v in got.items()} == {k: sorted(v) for k, v in want.items()}
    for label, series in want.items():
        for key, values in series.items():
            np.testing.assert_array_equal(np.asarray(got[label][key]), np.asarray(values))


def test_tracker_matches_jax():
    """The same values through both Trackers: history, latest values,
    running means and ``is_best`` equal (a tensor and a jax array of the
    same float32 give the same Python float)."""
    import jax.numpy as jnp

    JD = _jd()
    ours, theirs = PD.Tracker(), JD.Tracker()
    out_p = _feed(PD, ours, _train_values(torch.from_numpy), _val_values(torch.from_numpy))
    out_j = _feed(JD, theirs, _train_values(jnp.asarray), _val_values(jnp.asarray))
    _assert_same_history(_strip_time(_plain(ours.history)), _strip_time(_plain(theirs.history)))
    assert ours.history["train"]["step"] == list(range(8))
    assert len(ours.history["val"]["vloss"]) == 3
    for got, want in zip(out_p, out_j):
        assert isinstance(got["loss"], float) and got["loss"] == want["loss"]
        assert got["note"] == want["note"] == "text"  # non-scalars pass through
    for label in ("train", "val"):
        for name, value in theirs.metrics[label]["value"].items():
            if not name.startswith("time/"):
                assert ours.metrics[label]["value"][name] == value
    assert ours.is_best("train", "loss") == theirs.is_best("train", "loss") is True
    assert ours.is_best("train", "count") == theirs.is_best("train", "count") is False
    # done() zeroed the running means of every label, as in the JAX package
    assert all(m() == 0 for scalars in ours.metrics.values() for m in scalars["mean"].values())


def test_tracker_running_means_match_jax_before_done():
    import jax.numpy as jnp

    JD = _jd()
    trackers = {"port": PD.Tracker(), "jax": JD.Tracker()}
    arrays = {"port": torch.from_numpy, "jax": jnp.asarray}
    for key, tracker in trackers.items():
        step = tracker.track("train", 8, multihost_average=False)(lambda v: dict(v))
        for v in _train_values(arrays[key]):
            step(v)
    for name in ("loss", "count", "acc"):
        got = trackers["port"].metrics["train"]["mean"][name]()
        want = trackers["jax"].metrics["train"]["mean"][name]()
        assert got == want and math.isfinite(got)


@pytest.mark.parametrize("value,want", [(3, 3.0), (2.5, 2.5), (np.ones(1) * 4, 4.0),
                                        (np.ones((1, 1), np.float32), 1.0),
                                        (torch.tensor(0.25), 0.25), (torch.ones(1, 1) * 2, 2.0),
                                        (np.ones(2), None), (torch.ones(3), None), ("x", None)])
def test_to_scalar_takes_numbers_and_one_element_arrays(value, want):
    assert PD._to_scalar(value) == want


def test_tracker_state_dict_round_trip(tmp_path):
    tracker = PD.Tracker()
    _feed(PD, tracker, _train_values(torch.from_numpy), _val_values(torch.from_numpy))
    path = tmp_path / "tracker.pt"
    torch.save(tracker.state_dict(), path)
    restored = PD.Tracker().load_state_dict(torch.load(path, weights_only=False))
    assert restored.step == tracker.step == 7
    _assert_same_history(_plain(restored.history), _plain(tracker.history))
    assert restored.is_best("train", "loss")


def test_tracker_non_dict_output_and_rank():
    tracker = PD.Tracker(rank=1)
    fn = tracker.track("x", 2, multihost_average=False)(lambda: 42)
    with tracker.live:
        assert fn() == 42
    tracker.print("not shown on rank 1")
    with pytest.raises(ValueError):
        tracker.log("x", "median")


def test_tracker_without_rich_writes_plain_lines(tmp_path, monkeypatch, capsys):
    """With ``rich`` unimportable the display is plain text lines to the
    terminal and the log file; the metrics and history are those of the
    ``rich`` display."""
    reference = PD.Tracker()
    _feed(PD, reference, _train_values(torch.from_numpy), _val_values(torch.from_numpy))
    capsys.readouterr()

    monkeypatch.setitem(sys.modules, "rich", None)
    log = tmp_path / "log.txt"
    with PD.Tracker(log_file=str(log)) as tracker:
        assert not tracker.rich and tracker.pbar is None
        _feed(PD, tracker, _train_values(torch.from_numpy), _val_values(torch.from_numpy))
        tracker.print("hello from the run")
    out = capsys.readouterr().out
    _assert_same_history(_strip_time(_plain(tracker.history)),
                         _strip_time(_plain(reference.history)))
    text = log.read_text()
    for where in (out, text):
        assert "train_step() train 8/8 step 7 | loss " in where
        assert "val_step() val 3/3" in where
        assert "== epoch 0 ==" in where and "hello from the run" in where
    assert tracker.tasks["train"]["completed"] == 0  # done() rewound the pass
    tracker.close()  # idempotent


def test_tracker_closes_its_log_file(tmp_path):
    log = tmp_path / "log.txt"
    with PD.Tracker(log_file=str(log)) as tracker:
        tracker.print("hello")
        handle = tracker._log_handle
        assert "hello" in log.read_text()
    assert handle.closed
    PD.Tracker().close()


# -- Experiment ----------------------------------------------------------------


def test_experiment_matches_jax(tmp_path):
    from audiotools_tpu.ml import Experiment as JExperiment
    from audiotools_tpu_torch.core.util import chdir

    with chdir(tmp_path):
        exp = ml.Experiment(exp_name="run-a")
        assert exp.exp_dir.exists() and exp.exp_dir == Path("runs") / "run-a"
        expected = exp.exp_dir.absolute()
        with exp:
            assert Path.cwd() == expected
        assert Path.cwd() == tmp_path
        name = ml.Experiment.generate_exp_name()
        j_name = JExperiment.generate_exp_name()
        assert len(name.split("-")) == len(j_name.split("-")) == 3
        assert name.split("-")[0] == j_name.split("-")[0]  # the date stamp


def test_experiment_snapshot_copies_tracked_files(tmp_path):
    from audiotools_tpu_torch.core.util import chdir

    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "a.py").write_text("x = 1\n")
    with chdir(tmp_path):
        exp = ml.Experiment(exp_directory="runs", exp_name="snap")
        exp.git_tracked_files = ["src/a.py"]
        with exp:
            exp.snapshot()
    assert (tmp_path / "runs" / "snap" / "src" / "a.py").read_text() == "x = 1\n"


# -- _hostprof -----------------------------------------------------------------


def test_hostprof_exclusive_accounting():
    """Mirror of the JAX package's test: off by default, exclusive totals."""
    hostprof.reset()
    hostprof.disable()
    with hostprof.span("off"):
        time.sleep(0.01)
    assert hostprof.totals() == {}

    hostprof.enable()
    try:
        with hostprof.span("outer"):
            time.sleep(0.02)
            with hostprof.span("inner"):
                time.sleep(0.02)
    finally:
        hostprof.disable()
    t = hostprof.totals()
    # exclusive: outer's total excludes inner's time
    assert t["inner"] >= 0.018
    assert 0.015 <= t["outer"] <= 0.06
    hostprof.reset()
    assert hostprof.totals() == {}


def test_hostprof_is_the_data_packages_profiler():
    from audiotools_tpu_torch import data

    assert data.hostprof is hostprof
    assert hostprof.__all__ == _jd_hostprof().__all__


def _jd_hostprof():
    from audiotools_tpu import _hostprof

    return _hostprof


def test_hostprof_six_spans_fire_under_one_loader_batch(tmp_path):
    """decode, salient_meter, resample, instantiate, collate and device_put
    all accumulate over one batch of the loader: 44.1 kHz files read at 16
    kHz, excerpts above a loudness cutoff, a transform, staging."""
    from audiotools_tpu_torch.data import DataLoader
    from audiotools_tpu_torch.data import transforms as tfm
    from audiotools_tpu_torch.data.datasets import AudioDataset, AudioLoader
    from audiotools_tpu_torch.examples.train_dac import write_fixtures

    manifest = write_fixtures(tmp_path)
    ds = AudioDataset(AudioLoader(sources=[manifest]), sample_rate=16000, n_examples=2,
                      duration=0.5, transform=tfm.Compose(tfm.VolumeNorm(), tfm.LowPass()))
    hostprof.reset()
    hostprof.enable()
    try:
        batches = list(DataLoader(ds, batch_size=2, num_workers=0, device="cpu"))
    finally:
        hostprof.disable()
    t = hostprof.totals()
    hostprof.reset()
    assert len(batches) == 1 and batches[0]["signal"].sample_rate == 16000
    for name in ("decode", "salient_meter", "resample", "instantiate", "collate", "device_put"):
        assert name in t, f"span {name!r} never fired: {sorted(t)}"
        assert t[name] >= 0.0
