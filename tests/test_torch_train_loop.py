"""The port's canonical training loop (``audiotools_tpu_torch.examples.
train_dac``) on the CPU at the toy widths: both steps, the command line,
and mid-epoch resume.

Tolerance: none. With ``torch.use_deterministic_algorithms(True)``, 4 steps
in one run and 2 steps, a restore and 2 more end at the same parameters and
optimizer state bit for bit, fed the same dataset indices.
"""
import copy
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu_torch.examples import train_dac

ROOT = Path(__file__).resolve().parents[1]
# the JAX example's smoke test sizes: 16 kHz, 0.2 s (3,200 samples, 25 hops)
SMALL = ["--toy", "--batch-size", "4", "--sample-rate", "16000", "--duration", "0.2",
         "--device", "cpu"]


def _run(tmp_path, steps, *extra):
    args = train_dac.parse_args(SMALL + ["--steps", str(steps), "--ckpt-every", "2",
                                         "--ckpt-dir", str(tmp_path / "ckpt"), *extra])
    return train_dac.main(args)


class _Fed:
    """The dataset indices of every batch a loader yields."""

    def __init__(self, loader, out):
        self.loader, self.out = loader, out

    def __iter__(self):
        for batch in self.loader:
            self.out.append([int(i) for i in batch["idx"]])
            yield batch


@pytest.fixture
def fed(monkeypatch):
    """Each run's batches by dataset index, one list a run."""
    runs = []
    build = train_dac.build

    def recording_build(args):
        run = build(args)
        prepare, idx = run.accel.prepare_dataloader, []
        runs.append(idx)
        run.accel.prepare_dataloader = lambda *a, **kw: _Fed(prepare(*a, **kw), idx)
        return run

    monkeypatch.setattr(train_dac, "build", recording_build)
    return runs


@pytest.fixture
def deterministic():
    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(previous)


@pytest.mark.parametrize("extra", [(), ("--adversarial",)], ids=["reconstruction", "adversarial"])
def test_toy_loop_trains_and_checkpoints(tmp_path, extra, fed):
    run = _run(tmp_path, 3, *extra)
    history = run.tracker.history["train"]
    assert history["step"] == [1, 2, 3]
    losses = ["loss", "loss/mel", "loss/stft", "loss/waveform"]
    if extra:
        losses += ["loss/adv", "loss/feature", "loss/discriminator"]
    for name in losses:
        assert len(history[name]) == 3 and all(math.isfinite(v) for v in history[name]), name
    assert fed == [[[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]]
    assert run.T == 3200 and run.model.hop_length == 128
    # saved at step 2 (every 2) and at the end
    assert run.ckpt.steps() == [2, 3]
    _, meta = run.ckpt.restore()
    assert meta["data_idx"] == 12 and meta["tracker"]["step"] == 3
    nets = run.params.values() if extra else [run.params]
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for net in nets for p in net.parameters())


def test_amp_loop_runs_in_bf16(tmp_path):
    run = _run(tmp_path, 2, "--adversarial", "--amp")
    assert run.model.dtype == torch.bfloat16 and run.params["d"].mpd[0].dtype == torch.bfloat16
    assert run.accel.amp
    history = run.tracker.history["train"]
    assert all(math.isfinite(v) for v in history["loss"] + history["loss/discriminator"])


def test_command_line_runs_on_the_cpu(tmp_path):
    done = subprocess.run(
        [sys.executable, "-m", "audiotools_tpu_torch.examples.train_dac", *SMALL, "--steps", "2",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["2"]


def _state(params, opt_state):
    """Copies of both nets' and both optimizers' state dicts."""
    nets = {k: {n: t.detach().clone() for n, t in m.state_dict().items()}
            for k, m in params.items()}
    opts = {k: copy.deepcopy(o.state_dict()) for k, o in opt_state.items()}
    return nets, opts


def _assert_equal(got, want, path=""):
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    elif isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str), path
        for k in want:
            _assert_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{path}/{i}")
    else:
        assert got == want, path


def test_resume_mid_epoch_is_bit_equal(tmp_path, deterministic, fed, monkeypatch):
    """4 adversarial steps in one run against 2 steps, a fresh process's
    restore (new models, optimizers and tracker) and 2 more."""
    whole = _run(tmp_path / "whole", 4, "--adversarial")
    first = _run(tmp_path / "resumed", 2, "--adversarial")
    restored = {}

    class Recording(train_dac.Checkpointer):
        def restore(self, step=None, template=None):
            state, meta = super().restore(step, template)
            restored.update(meta=meta, state=_state(template["params"], template["opt_state"]))
            return state, meta

    monkeypatch.setattr(train_dac, "Checkpointer", Recording)
    second = _run(tmp_path / "resumed", 4, "--adversarial")
    assert restored["meta"]["step"] == 2 and restored["meta"]["data_idx"] == 8
    assert restored["meta"]["tracker"]["step"] == 2
    _assert_equal(restored["state"], _state(first.params, first.opt_state))  # the restore is the saved state
    assert fed[2] == fed[0][2:]  # the resumed run was fed steps 3-4 of the whole run
    _assert_equal(_state(second.params, second.opt_state), _state(whole.params, whole.opt_state))
    assert second.tracker.history["train"]["loss"] == whole.tracker.history["train"]["loss"]
    assert second.tracker.history["train"]["step"] == [1, 2, 3, 4]
