"""AudioSignal-level entry to the sequence-parallel ops.

Counterpart of ``audiotools_tpu/parallel/signal_api.py``. ``timeshard``
holds the halo-exchange ops over DTensors; this module places a signal's
samples so the ``mesh=`` arguments of ``AudioSignal`` take them. Every
process of the group runs the same code, one process per device:

    import torch.distributed as dist
    from audiotools_tpu_torch.parallel import make_mesh, shard_signal

    dist.init_process_group("nccl", init_method="tcp://localhost:29500",
                            rank=rank, world_size=world_size)
    torch.cuda.set_device(rank)
    mesh = make_mesh({"sp": world_size})
    sig = shard_signal(sig, mesh)          # time axis over the ranks
    lufs = sig.loudness(mesh=mesh)         # BS.1770, both gates summed over the mesh
    sig.stft(mesh=mesh); sig.istft(mesh=mesh)
    sig.resample(16000, mesh=mesh)
"""
from torch.distributed.tensor import DTensor

from .timeshard import _axis, _placements


def shard_signal(signal, mesh, axis_name: str = "sp"):
    """Place ``signal.audio_data`` time-sharded over ``mesh[axis_name]``.

    The samples become a DTensor sharded along time (batch and channels
    replicated), the layout every ``sharded_*`` op and every ``mesh=``
    method argument expects: each rank keeps its own slice of the signal it
    holds, on the mesh's device, and nothing moves between ranks. The cached
    loudness and STFT stay (the samples are unchanged). Returns the same
    signal for chaining.

    The time length must divide evenly over the axis (the contract of every
    timeshard op).
    """
    ax = _axis(mesh, axis_name)
    data = signal.audio_data
    T = data.shape[-1]
    if T % ax.size:
        raise ValueError(
            f"signal length {T} must divide over {ax.size} '{axis_name}' "
            f"shards; zero_pad to a multiple first")
    T_shard = T // ax.size
    local = data[..., ax.index * T_shard:(ax.index + 1) * T_shard].to(mesh.device_type)
    # bypass the audio_data setter: the samples are unchanged, so the cached
    # loudness stays valid
    signal._audio_data = DTensor.from_local(local.contiguous(), mesh,
                                            _placements(mesh, axis_name, data.ndim - 1),
                                            run_check=False)
    return signal
