"""Checkpoint and resume of a training state.

Counterpart of ``audiotools_tpu/ml/checkpoint.py``, on ``torch.save``: a
bundle of the models' and optimizers' state dicts (moved to the host), the
tracker's state and the data position, with a retention policy. Each step
is a folder ``<directory>/<step>/`` holding ``state.pt`` (the state dicts)
and ``host_state.pkl`` (``step``, ``data_idx``, ``tracker``, ``extra``, as
in the JAX package). A save is written to a hidden temporary folder and
renamed into place, so a crash during a save leaves the earlier steps
whole.

Several processes (``torch.distributed``) save one step together: every
rank takes part in gathering the sharded state, then rank 0 alone clears
stale temporary folders and writes the step, and every rank returns once
it is renamed into place. A ``DTensor`` (a parameter or an optimizer state
of a model placed on a mesh, ``models.train.shard_params``) is written as
its global tensor, so a step restores onto any mesh shape or into an
unsharded model; a restore places each tensor as its template's is.
"""
import os
import pickle
import shutil
import uuid
from pathlib import Path

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from ..parallel.tensor import local_slice

__all__ = ["Checkpointer"]

STATE_FILE = "state.pt"
HOST_FILE = "host_state.pkl"
_TMP_PREFIX = ".tmp-"


def _host_state(obj):
    """The state of ``obj`` on the host: modules and optimizers become their
    ``state_dict()``, tensors detached copies on the CPU (a ``DTensor`` its
    global tensor: every rank of its mesh calls this), and dicts, lists and
    tuples are walked."""
    if isinstance(obj, (nn.Module, torch.optim.Optimizer)):
        obj = obj.state_dict()
    if isinstance(obj, DTensor):
        obj = obj.full_tensor()
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_state(v) for v in obj)
    return obj


def _placed_like(value, like):
    """A global tensor from a checkpoint placed as ``like`` is: this rank's
    slice as a ``DTensor`` with ``like``'s mesh and placements; as it is
    when ``like`` is no ``DTensor``."""
    if not isinstance(like, DTensor) or not isinstance(value, torch.Tensor):
        return value
    shard = local_slice(value, like.device_mesh, like.placements)
    return DTensor.from_local(shard.to(like.device).contiguous(), like.device_mesh,
                              like.placements, run_check=False)


def _optimizer_state_like(optimizer, state):
    """An optimizer's saved state with each per-parameter tensor of the
    parameter's shape placed as the parameter is (the saved ids follow the
    parameters' order, as ``load_state_dict`` pairs them)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    ids = [i for group in state["param_groups"] for i in group["params"]]
    by_id = dict(zip(ids, params))
    placed = {}
    for i, entries in state["state"].items():
        param = by_id.get(i)
        placed[i] = {k: _placed_like(v, param) if (
            param is not None and isinstance(v, torch.Tensor) and v.shape == param.shape) else v
            for k, v in entries.items()}
    return dict(state, state=placed)


def _load_into(target, state):
    """Load ``state`` into ``target`` (modules, optimizers, tensors, or dicts
    of them) in place, each tensor placed as the target's is; returns
    ``target``."""
    if isinstance(target, nn.Module):
        own = target.state_dict()
        target.load_state_dict({k: _placed_like(v, own.get(k)) for k, v in state.items()})
    elif isinstance(target, torch.optim.Optimizer):
        target.load_state_dict(_optimizer_state_like(target, state))
    elif isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(_placed_like(state, target))
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
        """Checkpoint a training state bundle at ``step``; returns its folder.
        With several processes every rank calls it; rank 0 writes."""
        state = {"params": _host_state(params)}
        if opt_state is not None:
            state["opt_state"] = _host_state(opt_state)
        meta = {
            "step": step,
            "data_idx": data_idx,
            "tracker": tracker.state_dict() if tracker is not None else None,
            "extra": extra or {},
        }
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return self._write(step, state, meta)
        dist.barrier()  # no rank is still reading a step this save may replace
        error = None
        if dist.get_rank() == 0:
            try:
                self._write(step, state, meta)
            except BaseException as e:
                error = e
        said = [None if error is None else f"{type(error).__name__}: {error}"]
        dist.broadcast_object_list(said, src=0)  # every rank waits for the rename
        if error is not None:
            raise error
        if said[0] is not None:
            raise RuntimeError(f"rank 0 failed to save step {step}: {said[0]}")
        return self.directory / str(step)

    def _write(self, step, state, meta):
        """Write one step folder (one process): clear the temporary folders of
        saves that crashed, write, rename into place, apply the retention."""
        for stale in self.directory.glob(_TMP_PREFIX + "*"):
            shutil.rmtree(stale, ignore_errors=True)
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
