"""Checkpoint and resume of a training state.

Counterpart of ``audiotools_tpu/ml/checkpoint.py``, on ``torch.save``: a
bundle of the models' and optimizers' state dicts (moved to the host), the
tracker's state and the data position, with a retention policy. Each step
is a folder ``<directory>/<step>/`` holding ``state.pt`` (the state dicts)
and ``host_state.pkl`` (``step``, ``data_idx``, ``tracker``, ``extra``, as
in the JAX package). A save is written to a hidden temporary folder and
renamed into place, so a crash during a save leaves the earlier steps
whole.
"""
import os
import pickle
import shutil
import uuid
from pathlib import Path

import torch
from torch import nn

__all__ = ["Checkpointer"]

STATE_FILE = "state.pt"
HOST_FILE = "host_state.pkl"
_TMP_PREFIX = ".tmp-"


def _host_state(obj):
    """The state of ``obj`` on the host: modules and optimizers become their
    ``state_dict()``, tensors detached copies on the CPU, and dicts, lists and
    tuples are walked."""
    if isinstance(obj, (nn.Module, torch.optim.Optimizer)):
        obj = obj.state_dict()
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_state(v) for v in obj)
    return obj


def _load_into(target, state):
    """Load ``state`` into ``target`` (modules, optimizers, tensors, or dicts
    of them) in place; returns ``target``."""
    if isinstance(target, (nn.Module, torch.optim.Optimizer)):
        target.load_state_dict(state)
    elif isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(state)
    elif isinstance(target, dict):
        missing = set(target) ^ set(state)
        if missing:
            raise KeyError(f"checkpoint and template differ in keys {sorted(missing, key=str)}")
        for k in target:
            target[k] = _load_into(target[k], state[k])
    elif isinstance(target, (list, tuple)):
        target = type(target)(_load_into(t, s) for t, s in zip(target, state))
    else:
        target = state
    return target


class Checkpointer:
    """Save and restore (params, opt_state, tracker, data position) bundles.

    ``params`` and ``opt_state`` may each be an ``nn.Module``, an
    ``Optimizer``, a state dict, or a dict of those (``{"g": gen, "d":
    disc}``).

    Parameters
    ----------
    directory : str
        Root folder for checkpoints (one subfolder per step).
    max_to_keep : int, optional
        Retention count, by default 5.
    """

    def __init__(self, directory, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self):
        """The complete checkpoints' steps, oldest first."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / HOST_FILE).exists())

    def save(
        self,
        step: int,
        params,
        opt_state=None,
        tracker=None,
        data_idx: int = None,
        extra: dict = None,
    ):
        """Checkpoint a training state bundle at ``step``; returns its folder."""
        for stale in self.directory.glob(_TMP_PREFIX + "*"):
            shutil.rmtree(stale, ignore_errors=True)  # a save that crashed
        state = {"params": _host_state(params)}
        if opt_state is not None:
            state["opt_state"] = _host_state(opt_state)
        meta = {
            "step": step,
            "data_idx": data_idx,
            "tracker": tracker.state_dict() if tracker is not None else None,
            "extra": extra or {},
        }
        tmp = self.directory / f"{_TMP_PREFIX}{step}-{uuid.uuid4().hex}"
        tmp.mkdir()
        try:
            torch.save(state, tmp / STATE_FILE)
            # the host state is written last: its presence marks a whole step
            with open(tmp / HOST_FILE, "wb") as f:
                pickle.dump(meta, f)
            self._commit(tmp, self.directory / str(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))
        return self.directory / str(step)

    def _commit(self, tmp: Path, step_dir: Path):
        """Rename the written folder into place (one ``rename``); a folder of
        the same step is moved aside first and removed after."""
        aside = None
        if step_dir.exists():
            aside = self.directory / f"{_TMP_PREFIX}old-{step_dir.name}-{uuid.uuid4().hex}"
            os.replace(step_dir, aside)
        os.replace(tmp, step_dir)
        if aside is not None:
            shutil.rmtree(aside)

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int = None, template=None):
        """Restore a bundle. With ``template`` (e.g. ``{"params": {"g": gen,
        "d": disc}, "opt_state": {"g": g_opt, "d": d_opt}}``) the state is
        loaded into its modules, optimizers and tensors, which keep their
        devices; without one, the state dicts are returned on the host.

        Returns
        -------
        (state, meta) : the restored state and the host metadata dict.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        step_dir = self.directory / str(step)
        if not (step_dir / HOST_FILE).exists():
            raise FileNotFoundError(f"no checkpoint of step {step} under {self.directory}")
        state = torch.load(step_dir / STATE_FILE, map_location="cpu", weights_only=True)
        if template is not None:
            state = _load_into(template, {k: state[k] for k in template})
        with open(step_dir / HOST_FILE, "rb") as f:
            meta = pickle.load(f)
        return state, meta

    def close(self):
        """Nothing to flush: every save is written before it returns."""
