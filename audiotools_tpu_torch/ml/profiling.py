"""Profiling: the ``timer`` decorator, device traces and named regions.

Counterpart of ``audiotools_tpu/ml/profiling.py``. ``trace`` records the
enclosed block with ``torch.profiler`` (host operations, and the card's
kernels and copies where there is a card) and writes a Chrome trace under
``log_dir`` that TensorBoard's profiler plugin and Perfetto read;
``annotate`` names a region of it.

The trace also shows the program's own ranges, each named ``audiotools.``
and the phase (``_hostprof.span``), with the device work each launched
beneath it: ``transform.<class>`` for each transform (a ``Compose``'s
children inside it), ``loudness`` for each BS.1770 meter call on the
device, ``dac.encoder``, ``dac.quantizer`` and ``dac.decoder``, the
adversarial step's ``generator``, ``discriminator``, ``backward`` and
``optimizer``, ``compress`` and ``decompress``, and the data path's
``decode``, ``salient_meter``, ``resample``, ``instantiate``, ``collate``
and ``device_put``.
"""
import contextlib
from pathlib import Path

import torch

from .decorators import timer  # re-export: same decorator surface

__all__ = ["timer", "trace", "annotate"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block into ``log_dir`` (a
    ``<host>_<pid>.<time>.pt.trace.json`` file); yields the profiler.

    >>> with profiling.trace("runs/exp/profile"):
    ...     step(batch)
    View with: tensorboard --logdir runs/exp/profile  (or Perfetto)
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def annotate(name: str):
    """Named trace region (context manager or decorator)."""
    return torch.profiler.record_function(name)
