"""Sequence parallelism: signals sharded along time over a device mesh, one
process per device (``torch.distributed``), with halo exchanges between
neighbouring shards. Counterpart of ``audiotools_tpu/parallel``."""
from .mesh import make_mesh
from .signal_api import shard_signal
from .timeshard import (
    sharded_fir_conv,
    sharded_frames,
    sharded_istft,
    sharded_loudness,
    sharded_resample,
    sharded_stft,
)
