"""Accelerator: models, batches and loaders for one card or several
processes.

Counterpart of ``audiotools_tpu/ml/accelerator.py`` on
``torch.distributed``. One process per card: with more than one process in
the default group, ``prepare_model`` wraps the model in
``DistributedDataParallel`` (the gradient all-reduce runs in its backward)
and ``prepare_dataloader`` gives each process its share of the indices.

Mixed precision is bfloat16 and needs no loss scaling, so the scaler is a
pass-through kept for the API: ``backward(loss)`` is ``loss.backward()``
and ``step(optimizer)`` is ``optimizer.step()``. ``amp=True`` turns on the
``autocast`` context and ``cast_for_compute``; the DAC models take their
own compute ``dtype`` instead (``DAC(dtype=torch.bfloat16)``).
"""
import contextlib
import typing

import torch
from torch.nn.parallel import DataParallel, DistributedDataParallel

from ..core import util
from ..data.datasets import ResumableDistributedSampler, ResumableSequentialSampler, _process_group
from ..data.loader import DataLoader


class _PassThroughScaler:
    """bf16 needs no loss scaling; the ``GradScaler`` surface, doing nothing
    but the optimizer's step."""

    def step(self, optimizer, *args, **kwargs):
        return optimizer.step(*args, **kwargs)

    def scale(self, loss):
        return loss

    def unscale_(self, optimizer):
        return optimizer

    def update(self):
        pass


class Accelerator:
    """Prepares models, batches and loaders for one card, or for one card a
    process under ``torch.distributed``.

    Parameters
    ----------
    amp : bool, optional
        bfloat16 autocast and compute casts, by default False.
    device : optional
        The device to compute on; by default the card (``util.
        default_device``, which raises without one), the process's own card
        when there are several processes. ``"cpu"`` computes on the host.
    """

    def __init__(self, amp: bool = False, device=None):
        self.amp = amp
        self.world_size, self.local_rank = _process_group()
        self.num_processes = self.world_size
        if device is None:
            device = util.default_device()
            if self.num_processes > 1:
                device = torch.device("cuda", self.local_rank % torch.cuda.device_count())
        self.device = torch.device(device)
        self.scaler = _PassThroughScaler()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        pass

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def prepare_model(self, model, rules: dict = None, **kwargs):
        """Move ``model`` to the device; with more than one process, wrap it
        in ``DistributedDataParallel`` (``kwargs`` go to it)."""
        if rules is not None:
            raise NotImplementedError(
                "model-parallel partition rules wait for the port's parallel/ package "
                "(ROADMAP Queue 1 item 9)")
        model = model.to(self.device)
        if self.num_processes > 1:
            device_ids = [self.device.index] if self.device.type == "cuda" else None
            model = DistributedDataParallel(model, device_ids=device_ids, **kwargs)
        return model

    def prepare_batch(self, batch, device=None):
        """Move a collated batch to the device (``util.prepare_batch``)."""
        return util.prepare_batch(batch, device or self.device)

    def shard(self, tree):
        """The identity: each process holds its own share of the batch."""
        return tree

    def jit_step(self, fn, donate_argnums=(), **jit_kwargs):
        """``fn`` itself: steps run eagerly."""
        return fn

    # ------------------------------------------------------------------
    # mixed precision
    # ------------------------------------------------------------------

    def autocast(self, *args, **kwargs):
        """``torch.autocast`` to bfloat16 when ``amp`` is set, else a null
        context."""
        if self.amp:
            return torch.autocast(self.device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def cast_for_compute(self, tree):
        """Floating tensors of ``tree`` (dicts, lists, tuples) cast to
        bfloat16 when ``amp`` is set."""
        if not self.amp:
            return tree
        if isinstance(tree, torch.Tensor):
            return tree.to(torch.bfloat16) if tree.is_floating_point() else tree
        if isinstance(tree, dict):
            return {k: self.cast_for_compute(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_for_compute(v) for v in tree)
        return tree

    def backward(self, loss):
        """``loss.backward()`` through the scaler."""
        self.scaler.scale(loss).backward()

    def step(self, optimizer):
        """``optimizer.step()`` through the scaler."""
        return self.scaler.step(optimizer)

    def update(self):
        self.scaler.update()

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------

    def prepare_dataloader(
        self, dataset: typing.Iterable, start_idx: int = None, **kwargs
    ):
        """A DataLoader with resumable sampling, staging to the device: with
        several processes each takes its interleaved share of the indices
        (from a global ``start_idx``), and the batch size and workers are
        divided by the process count."""
        if self.num_processes > 1:
            sampler = ResumableDistributedSampler(
                dataset,
                start_idx,
                num_replicas=self.num_processes,
                rank=self.local_rank,
            )
            if "num_workers" in kwargs:
                kwargs["num_workers"] = max(
                    kwargs["num_workers"] // self.num_processes, 1
                )
            if "batch_size" in kwargs:
                kwargs["batch_size"] = max(
                    kwargs["batch_size"] // self.num_processes, 1
                )
        else:
            sampler = ResumableSequentialSampler(dataset, start_idx)
        kwargs.setdefault("device", self.device)
        return DataLoader(dataset, sampler=sampler, **kwargs)

    @staticmethod
    def unwrap(model):
        """The module inside a ``DistributedDataParallel`` or ``DataParallel``
        wrapper; any other model as it is."""
        if isinstance(model, (DistributedDataParallel, DataParallel)):
            return model.module
        return model
