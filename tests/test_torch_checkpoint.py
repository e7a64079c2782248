"""The port's ``Checkpointer`` (``torch.save`` folders a step) on the CPU:
round trip into modules and optimizers bit for bit, retention, a missing
checkpoint, a save interrupted before its rename, and the host state's keys
against the JAX package's orbax ``Checkpointer``.

Tolerance: none; a restore is held equal bit for bit.
"""
import pickle

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores
from torch import nn

from audiotools_tpu_torch.ml import Checkpointer
from audiotools_tpu_torch.ml import checkpoint as PC
from audiotools_tpu_torch.ml.decorators import Tracker


def _nets(seed):
    """Two small nets and their AdamW optimizers, each stepped twice."""
    torch.manual_seed(seed)
    nets = {"g": nn.Sequential(nn.Conv1d(1, 4, 3), nn.Tanh(), nn.Conv1d(4, 1, 3)),
            "d": nn.Linear(6, 2)}
    opts = {k: torch.optim.AdamW(m.parameters(), lr=1e-3, weight_decay=1e-4)
            for k, m in nets.items()}
    for _ in range(2):
        loss = nets["g"](torch.randn(2, 1, 12)).pow(2).mean() + nets["d"](torch.randn(3, 6)).abs().mean()
        loss.backward()
        for opt in opts.values():
            opt.step()
            opt.zero_grad()
    return nets, opts


def _flat(obj, prefix=""):
    """Every tensor (and number) of a state tree, by path."""
    if isinstance(obj, (nn.Module, torch.optim.Optimizer)):
        obj = obj.state_dict()
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(obj, (list, tuple)):
        out = {}
        for i, v in enumerate(obj):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: obj}


def _assert_bit_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert torch.equal(g.cpu(), w.cpu()), key
        else:
            assert g == w, key


def _tracker():
    tracker = Tracker()
    step = tracker.log("train")(tracker.track("train", 5, multihost_average=False)(
        lambda v: {"loss": v}))
    for i in range(5):
        tracker.step = i + 1
        step(1.0 / (i + 1))
    return tracker


def test_round_trip_into_modules_and_optimizers(tmp_path):
    nets, opts = _nets(0)
    tracker = _tracker()
    ckpt = Checkpointer(tmp_path / "ckpt")
    folder = ckpt.save(5, nets, opts, tracker=tracker, data_idx=20, extra={"note": "a"})
    assert folder == tmp_path / "ckpt" / "5"
    assert sorted(p.name for p in folder.iterdir()) == ["host_state.pkl", "state.pt"]
    assert ckpt.latest_step() == 5

    fresh_nets, fresh_opts = _nets(1)
    state, meta = ckpt.restore(template={"params": fresh_nets, "opt_state": fresh_opts})
    assert state["params"]["g"] is fresh_nets["g"] and state["opt_state"]["d"] is fresh_opts["d"]
    _assert_bit_equal(fresh_nets, nets)
    _assert_bit_equal(fresh_opts, opts)  # both moments and the step counts
    assert meta == {"step": 5, "data_idx": 20, "tracker": tracker.state_dict(),
                    "extra": {"note": "a"}}
    restored = Tracker().load_state_dict(meta["tracker"])
    assert restored.history["train"]["loss"] == tracker.history["train"]["loss"]

    # without a template: the host state dicts
    host, _ = ckpt.restore(5)
    _assert_bit_equal(host["params"], {k: m.state_dict() for k, m in nets.items()})
    _assert_bit_equal(host["opt_state"], {k: o.state_dict() for k, o in opts.items()})
    ckpt.close()


def test_round_trip_of_a_state_dict_template(tmp_path):
    nets, _ = _nets(0)
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, nets["d"].state_dict())
    target = nn.Linear(6, 2)
    state, meta = ckpt.restore(template={"params": target.state_dict()})
    _assert_bit_equal(target, nets["d"])
    assert meta["tracker"] is None and meta["extra"] == {} and "opt_state" not in state


def test_the_saved_state_is_a_copy(tmp_path):
    """Training on after a save leaves the saved state as it was."""
    nets, opts = _nets(0)
    before = {k: v.clone() for k, v in nets["d"].state_dict().items()}
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, nets, opts)
    with torch.no_grad():
        nets["d"].weight.add_(1.0)
    host, _ = ckpt.restore(1)
    _assert_bit_equal(host["params"]["d"], before)


def test_retention_keeps_the_newest(tmp_path):
    nets, opts = _nets(0)
    ckpt = Checkpointer(tmp_path, max_to_keep=2)
    for step in (1, 2, 3, 4):
        ckpt.save(step, nets, opts, data_idx=step)
    assert ckpt.steps() == [3, 4]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3", "4"]
    assert ckpt.restore()[1]["data_idx"] == 4
    assert ckpt.restore(3)[1]["data_idx"] == 3


def test_saving_a_step_again_replaces_it(tmp_path):
    nets, opts = _nets(0)
    ckpt = Checkpointer(tmp_path)
    ckpt.save(2, nets, opts, data_idx=1)
    ckpt.save(2, nets, opts, data_idx=7)
    assert ckpt.steps() == [2] and sorted(p.name for p in tmp_path.iterdir()) == ["2"]
    assert ckpt.restore(2)[1]["data_idx"] == 7


def test_missing_checkpoints_raise(tmp_path):
    ckpt = Checkpointer(tmp_path / "empty")
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    nets, _ = _nets(0)
    ckpt.save(1, nets)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(2)


def test_an_interrupted_save_leaves_the_previous_step_whole(tmp_path, monkeypatch):
    """A save cut before its rename (here: the rename raises) leaves the
    previous latest step whole and restorable, and no step folder of its
    own; a crash's leftover folder is ignored and cleared by the next save."""
    nets, opts = _nets(0)
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, nets, opts, data_idx=1)
    saved = {k: {n: t.clone() for n, t in m.state_dict().items()} for k, m in nets.items()}

    with torch.no_grad():
        nets["g"][0].weight.add_(1.0)

    def cut(src, dst):
        raise KeyboardInterrupt("killed during the save")

    monkeypatch.setattr(PC.os, "replace", cut)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save(2, nets, opts, data_idx=2)
    monkeypatch.undo()

    assert ckpt.latest_step() == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["1"]
    fresh, _ = _nets(1)
    _, meta = ckpt.restore(template={"params": fresh})
    assert meta["data_idx"] == 1
    _assert_bit_equal({k: m.state_dict() for k, m in fresh.items()}, saved)

    # a process killed mid-write leaves a hidden folder without host state
    crashed = tmp_path / ".tmp-3-dead"
    crashed.mkdir()
    (crashed / "state.pt").write_bytes(b"partial")
    assert ckpt.latest_step() == 1
    ckpt.save(3, nets, opts, data_idx=3)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["1", "3"]


def test_host_state_keys_match_jax(tmp_path):
    """The host state beside the weights carries the JAX package's keys."""
    import jax.numpy as jnp

    from audiotools_tpu.ml.checkpoint import Checkpointer as JCheckpointer

    tracker = _tracker()
    jckpt = JCheckpointer(tmp_path / "jax")
    jdir = jckpt.save(3, {"w": jnp.ones((2,))}, tracker=tracker, data_idx=6, extra={"a": 1})
    jckpt.close()
    with open(jdir / "host_state.pkl", "rb") as f:
        want = pickle.load(f)
    nets, _ = _nets(0)
    pdir = Checkpointer(tmp_path / "port").save(3, nets, tracker=tracker, data_idx=6,
                                                extra={"a": 1})
    with open(pdir / "host_state.pkl", "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want) == ["data_idx", "extra", "step", "tracker"]
    assert got == want
    assert np.asarray(got["tracker"]["history"]["train"]["loss"]).shape == (5,)
