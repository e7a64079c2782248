"""Tensor (model) parallelism over a mesh dimension, one process per device.

The JAX package shards conv, transposed-conv and dense kernels on their
output channels over a tensor axis and lets GSPMD insert the collectives.
PyTorch's DTensor convolution rule replicates the weight, so the port's
layers compute on their weight's local shard themselves, around two
collectives over the tensor axis's process group (Megatron's
column-parallel layer):

* :func:`copy_to` - the identity forward; the backward sums the input's
  gradient over the group, since each rank's local output channels give
  only their part of it;
* :func:`gather_from` - ``all_gather`` of each rank's output channels
  along a dim; the backward keeps the rank's own slice of the incoming
  gradient. That is exact because everything after the gather is
  replicated: every rank of the group holds the same gradient.

A layer adds its replicated bias (and a weight-normalized conv its
per-channel scale) after the gather, so those gradients are whole on every
rank.

:func:`place` turns a model's parameters into ``DTensor``s on the mesh
(``Shard`` of a weight's output dim on the tensor axis where the rule
says, ``Replicate`` everywhere else), from the parameters the ranks
already hold, which must be equal. A layer declares which of its
parameters it can compute sharded, and along which dim, in a ``_tp_dims``
class attribute; placing any other parameter sharded raises. Batches are
sharded over a data axis: ``place`` installs one post-accumulate-grad hook
a parameter that averages its local gradient over that axis, so the
training steps stay mesh-agnostic, and :func:`data_mean` gives them the
global batch's metrics. Over a group of one rank every collective is the
identity and launches nothing.
"""
import weakref
from collections import namedtuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = [
    "local",
    "shard_group",
    "copy_to",
    "gather_from",
    "data_mean",
    "local_slice",
    "place",
    "placement",
]

Placement = namedtuple("Placement", ["mesh", "data_axis", "handles"])
_PLACED = weakref.WeakKeyDictionary()  # model -> Placement


def local(t):
    """The local tensor of a ``DTensor`` (differentiable); any other value
    as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _dim_index(mesh, axis_name: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"the mesh has no dimension {axis_name!r} (it has {names})")
    return names.index(axis_name)


def shard_group(weight, dim: int):
    """The process group that ``weight``'s ``dim`` is sharded over, or None
    when this rank holds the whole tensor (a plain tensor, a replicated
    ``DTensor``, or one sharded over a mesh dimension of size 1). Any other
    sharding raises: the layers compute only output-channel shards."""
    if not isinstance(weight, DTensor):
        return None
    group, sharded = None, False
    for i, p in enumerate(weight.placements):
        if p.is_replicate():
            continue
        if not p.is_shard(dim % weight.ndim) or sharded:
            raise ValueError(f"a layer computes with its weight sharded on dim {dim} over one "
                             f"mesh dimension, got placements {tuple(weight.placements)}")
        sharded = True
        if weight.device_mesh.size(i) > 1:
            group = weight.device_mesh.get_group(i)
    return group


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)  # autograd may share it
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim, group):
        ctx.dim, ctx.group = dim, group
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[ctx.dim] // dist.get_world_size(ctx.group)
        return grad.narrow(ctx.dim, dist.get_rank(ctx.group) * n, n), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group``'s ranks."""
    return _CopyTo.apply(x, group)


def gather_from(y: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Each rank's slice of ``dim`` joined in rank order over ``group``; the
    gradient of the rank's own slice back."""
    return _GatherFrom.apply(y, dim % y.ndim, group)


def _group(mesh, axis_name: str):
    """The process group of ``mesh[axis_name]``, or None for one rank or a
    mesh without that dimension."""
    if axis_name not in (mesh.mesh_dim_names or ()):
        return None
    i = _dim_index(mesh, axis_name)
    return mesh.get_group(i) if mesh.size(i) > 1 else None


def _average_gradients(model: nn.Module, mesh, data_axis: str = "dp"):
    """Hooks that average each parameter's local gradient over
    ``mesh[data_axis]`` as soon as it is accumulated: the gradient of the
    mean loss over the data shards. The hooks' handles; none for a data
    axis of one rank, or a mesh without one."""
    group = _group(mesh, data_axis)
    if group is None:
        return []
    n = dist.get_world_size(group)

    def hook(param):
        grad = local(param.grad)  # the gradient's own storage: grad mode is off here
        dist.all_reduce(grad, group=group)
        grad.div_(n)

    return [p.register_post_accumulate_grad_hook(hook)
            for p in model.parameters() if p.requires_grad]


def data_mean(model: nn.Module, metrics: dict) -> dict:
    """The global batch's metrics of a model placed by :func:`place`: each
    scalar averaged over the data axis (the data shards are equal in size).
    ``metrics`` as they are for any other model, or one data rank."""
    placed = _PLACED.get(model)
    group = _group(placed.mesh, placed.data_axis) if placed is not None else None
    if group is None:
        return metrics
    keys = list(metrics)
    values = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(values, group=group)
    values /= dist.get_world_size(group)
    return dict(zip(keys, values.unbind()))


def _placements_for(mesh, spec, ndim: int):
    """``DTensor`` placements from a ``PartitionSpec``-like ``spec``: one
    entry a tensor dim (a mesh-axis name or None; missing trailing entries
    are None)."""
    spec = tuple(spec or ())
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    shard = {}
    for d, axis in enumerate(spec):
        if axis is not None:
            shard[_dim_index(mesh, axis)] = d
    return tuple(Shard(shard[i]) if i in shard else Replicate()
                 for i in range(mesh.ndim))


def local_slice(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's slice of the global tensor ``full`` under ``placements``,
    as ``DTensor`` cuts it (``torch.chunk`` a sharded mesh dimension, in
    mesh order)."""
    out = full
    for i, p in enumerate(placements):
        if p.is_shard():
            out = out.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return out


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _check(name, layer, leaf, full, mesh, placements, data_axis):
    """Refuse a placement the layer cannot compute."""
    dims = getattr(layer, "_tp_dims", {})
    for i, p in enumerate(placements):
        if not p.is_shard():
            continue
        if mesh.mesh_dim_names[i] == data_axis:
            raise ValueError(f"{name}: weights are not sharded over the data axis "
                             f"{data_axis!r} (its ranks hold different batches)")
        if dims.get(leaf) != p.dim:
            can = ", ".join(f"{k} on dim {d}" for k, d in dims.items()) or "nothing"
            raise ValueError(f"{name}: sharded on dim {p.dim}, but {type(layer).__name__} "
                             f"computes sharded output dims of {can} only")
        if full.shape[p.dim] % mesh.size(i):
            raise ValueError(f"{name}: dim {p.dim} of {tuple(full.shape)} does not divide "
                             f"over {mesh.size(i)} ranks")
    if sum(p.is_shard() for p in placements) > 1:
        raise ValueError(f"{name}: a weight is sharded over one mesh dimension at most")


def place(model: nn.Module, mesh, spec_for, data_axis: str = "dp") -> nn.Module:
    """Every parameter of ``model`` as a ``DTensor`` on ``mesh`` with the
    placements of ``spec_for(name, param, layer)`` (a ``PartitionSpec``-like
    tuple over the torch layout), the data-axis gradient hooks installed,
    on the mesh's device; returns ``model``. The global values are the ones
    the ranks hold (a ``DTensor`` parameter is read whole first), so a
    model can be placed again on another mesh. A mesh without ``data_axis``
    averages no gradient."""
    old = _PLACED.pop(model, None)
    for handle in old.handles if old else ():
        handle.remove()
    device, done = _mesh_device(mesh), {}
    for layer_name, layer in model.named_modules():
        for leaf, param in list(layer._parameters.items()):
            if param is None:
                continue
            if id(param) not in done:
                name = f"{layer_name}.{leaf}" if layer_name else leaf
                full = param.full_tensor() if isinstance(param, DTensor) else param
                full = full.detach().to(device)
                placements = _placements_for(mesh, spec_for(name, param, layer), param.ndim)
                _check(name, layer, leaf, full, mesh, placements, data_axis)
                shard = local_slice(full, mesh, placements).contiguous()
                done[id(param)] = nn.Parameter(
                    DTensor.from_local(shard, mesh, placements, run_check=False),
                    requires_grad=param.requires_grad)
            layer._parameters[leaf] = done[id(param)]
        for leaf, buf in list(layer._buffers.items()):
            if buf is not None:
                layer._buffers[leaf] = buf.to(device)
    _PLACED[model] = Placement(mesh, data_axis, _average_gradients(model, mesh, data_axis))
    return model


def placement(model: nn.Module):
    """``(mesh, data_axis, hook handles)`` of a model placed by :func:`place`,
    else None."""
    return _PLACED.get(model)
