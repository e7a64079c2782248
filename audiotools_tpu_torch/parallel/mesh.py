"""Device meshes over the initialized default process group.

Counterpart of ``audiotools_tpu/parallel/mesh.py``. The port runs one
process per device (``torch.distributed``): a mesh names dimensions of the
world's ranks, and each rank holds one device. The caller creates the
default process group (``gloo`` on the CPU, ``nccl`` across cards) with its
address, world size and rank; :func:`make_mesh` never creates one.
"""
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh"]


def make_mesh(shape: dict = None, device: str = "cuda") -> DeviceMesh:
    """Build a ``DeviceMesh`` with named dimensions from an ``{axis: size}``
    spec over the world's ranks.

    ``make_mesh({"dp": 4, "sp": 2})`` -> a 4 x 2 mesh. Defaults to a 1-D
    ``{"dp": world_size}`` data mesh. Sizes must multiply to at most the
    world size (the mesh then holds the first ranks); -1 means "fill with the
    remaining ranks". ``device``: ``"cuda"`` (each rank's current card) or
    ``"cpu"``.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized default process group, one process per "
            "device: torch.distributed.init_process_group(backend, "
            "init_method='tcp://localhost:<port>', rank=rank, world_size=world_size) "
            "with backend 'nccl' across cards or 'gloo' on the CPU")
    world = dist.get_world_size()
    if shape is None:
        shape = {"dp": world}
    axes, sizes = list(shape), list(shape.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    total = int(np.prod(sizes))
    if not 0 < total <= world:
        raise ValueError(f"mesh {dict(zip(axes, sizes))} needs {total} ranks; the world "
                         f"has {world}")
    ranks = torch.arange(total).reshape(sizes)
    return DeviceMesh(device, ranks, mesh_dim_names=tuple(axes))
