"""Accelerator: models, batches and loaders for one card or several
processes.

Counterpart of ``audiotools_tpu/ml/accelerator.py`` on
``torch.distributed``. One process per card: with more than one process in
the default group, ``prepare_model`` wraps the model in
``DistributedDataParallel`` (the gradient all-reduce runs in its backward)
and ``prepare_dataloader`` gives each process its share of the indices.

On a ``DeviceMesh`` (``parallel.make_mesh``, e.g. ``{"dp": 2, "tp": 2}``)
``prepare_model`` places the parameters on the mesh instead, as the JAX
package's does (``parallel.tensor.place``): partition rules shard the
weights they name, the rest is replicated, and the gradients are averaged
over the data axis; ``prepare_dataloader`` splits the indices by the data
axis, so the ranks of one tensor group see the same items.

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
from ..parallel import tensor as _tp


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
    mesh : DeviceMesh, optional
        A mesh over the default process group (``parallel.make_mesh``); by
        default none: one card, or data parallelism over every process.
    data_axis : str, optional
        The mesh dimension batches are split over, by default "dp".
    device : optional
        The device to compute on; by default the mesh's (the process's
        current card, or the host for a ``"cpu"`` mesh), else the card
        (``util.default_device``, which raises without one), the process's
        own card when there are several processes. ``"cpu"`` computes on
        the host.
    """

    def __init__(self, amp: bool = False, mesh=None, data_axis: str = "dp", device=None):
        self.amp = amp
        self.mesh, self.data_axis = mesh, data_axis
        self.world_size, self.local_rank = _process_group()
        self.num_processes = self.world_size
        if mesh is not None:
            _tp._dim_index(mesh, data_axis)
            if device is None:
                device = _tp._mesh_device(mesh)
        if device is None:
            device = util.default_device()
            if self.num_processes > 1:
                device = torch.device("cuda", self.local_rank % torch.cuda.device_count())
        self.device = torch.device(device)
        self.scaler = _PassThroughScaler()

    def _data_split(self):
        """(this rank's coordinate on the data axis, the axis's size): the
        process's rank and count without a mesh."""
        if self.mesh is None:
            return self.local_rank, self.num_processes
        i = _tp._dim_index(self.mesh, self.data_axis)
        return self.mesh.get_local_rank(i), self.mesh.size(i)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        pass

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def prepare_model(self, model, rules: dict = None, **kwargs):
        """Move ``model`` to the device; with more than one process, wrap it
        in ``DistributedDataParallel`` over the data axis (``kwargs`` go to
        it).

        On a mesh with ``rules``, or with a dimension besides the data axis,
        place it on the mesh instead (``parallel.tensor.place``): ``rules``
        maps substrings of parameter names to ``PartitionSpec``-like tuples
        over the torch layout (the first match wins), e.g. ``{"in_proj.weight":
        ("tp", None)}``; a matched parameter is sharded so and every other
        one replicated. A layer computes only its output channels sharded
        over a dimension other than the data axis, and other rules raise."""
        model = model.to(self.device)
        names = self.mesh.mesh_dim_names if self.mesh is not None else ()
        if rules is not None or set(names) - {self.data_axis}:
            if self.mesh is None:
                raise ValueError("partition rules need a mesh: Accelerator(mesh=make_mesh(...))")

            def spec_for(name, param, layer):
                return next((spec for pattern, spec in (rules or {}).items()
                             if pattern in name), ())

            return _tp.place(model, self.mesh, spec_for, self.data_axis)
        if self._data_split()[1] > 1:
            device_ids = [self.device.index] if self.device.type == "cuda" else None
            group = self.mesh.get_group(self.data_axis) if self.mesh is not None else None
            model = DistributedDataParallel(model, device_ids=device_ids, process_group=group,
                                            **kwargs)
        return model

    def prepare_batch(self, batch, device=None):
        """Move a collated batch to the device (``util.prepare_batch``)."""
        return util.prepare_batch(batch, device or self.device)

    def shard(self, tree):
        """The identity: each process holds its own share of the batch (on a
        mesh, its data rank's share, which ``prepare_dataloader`` gives)."""
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
        several processes each data rank takes its interleaved share of the
        indices (from a global ``start_idx``) and the batch size is divided
        by the data axis's size; the workers are divided by the process
        count. On a mesh the ranks of one tensor group (one coordinate on
        the data axis) take the same share."""
        data_rank, data_size = self._data_split()
        if data_size > 1:
            sampler = ResumableDistributedSampler(
                dataset,
                start_idx,
                num_replicas=data_size,
                rank=data_rank,
            )
            if "num_workers" in kwargs:
                kwargs["num_workers"] = max(
                    kwargs["num_workers"] // self.num_processes, 1
                )
            if "batch_size" in kwargs:
                kwargs["batch_size"] = max(
                    kwargs["batch_size"] // data_size, 1
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
