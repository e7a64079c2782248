"""Core utilities: seeding, source manifests, tensors and batch collation.

Counterpart of ``audiotools_tpu/core/util.py`` for the augmentation path.
Randomness stays host-side numpy (``RandomState``) with the JAX package's
draw order, so both packages draw identical parameters for a batch.
"""
import csv
import numbers
import os
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch

AUDIO_EXTENSIONS = [".wav"]


def flatten(d: dict, parent: tuple = ()) -> dict:
    """Flatten a nested dict into ``{tuple_path: value}``."""
    out = {}
    for k, v in d.items():
        path = parent + (k,)
        if isinstance(v, dict) and v:
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def unflatten(d: dict) -> dict:
    """Invert :func:`flatten`."""
    out = {}
    for path, v in d.items():
        cur = out
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = v
    return out


@dataclass
class Info:
    sample_rate: float
    num_frames: int

    @property
    def duration(self) -> float:
        return self.num_frames / self.sample_rate


def info(audio_path) -> Info:
    """Audio file metadata without decoding."""
    from ..io import audio_info

    i = audio_info(str(audio_path))
    return Info(sample_rate=i.sample_rate, num_frames=i.num_frames)


def default_device() -> torch.device:
    """The card, where the port computes unless it is told ``device="cpu"``.
    Raises when there is no card: nothing carries on on the host unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to compute on the host")
    return torch.device("cuda")


def ensure_tensor(x, ndim: int = None, batch_size: int = None, device=None):
    """Coerce ``x`` to a tensor (float64 becomes float32) with at least
    ``ndim`` dimensions (trailing axes added) and a leading ``batch_size``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if x.dtype == torch.float64:
        x = x.float()
    if device is not None:
        x = x.to(device)
    if ndim is not None:
        if x.ndim > ndim:
            raise ValueError(f"expected at most {ndim} dims, got {x.ndim}")
        while x.ndim < ndim:
            x = x[..., None]
    if batch_size is not None and x.shape[0] != batch_size:
        x = x.expand(batch_size, *x.shape[1:])
    return x


def random_state(seed):
    """``None`` -> numpy's global state; an int -> a fresh
    ``RandomState``; an existing state passes through."""
    if isinstance(seed, np.random.RandomState):
        return seed
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, (numbers.Integral, np.integer)):
        return np.random.RandomState(seed)
    raise ValueError(f"{seed!r} cannot seed a numpy.random.RandomState")


def sample_from_dist(dist_tuple: tuple, state: np.random.RandomState = None):
    """Sample from a distribution tuple such as ``("uniform", 0, 1)``;
    ``("const", v)`` returns ``v`` without drawing."""
    if dist_tuple[0] == "const":
        return dist_tuple[1]
    state = random_state(state)
    return getattr(state, dist_tuple[0])(*dist_tuple[1:])


def dist_lower_bound(dist_tuple, default: float = None):
    """The least value a distribution tuple can give, where it can be read
    off the tuple (``"const"``, ``"uniform"``, ``"choice"`` or a number),
    else ``default``. ``LowPass`` and ``HighPass`` size their sinc support
    by it."""
    if isinstance(dist_tuple, (int, float)):
        return float(dist_tuple)
    if isinstance(dist_tuple, (tuple, list)) and dist_tuple:
        kind = dist_tuple[0]
        if kind in ("const", "uniform"):
            return float(dist_tuple[1])
        if kind == "choice":
            return float(min(dist_tuple[1]))
    return default


def find_audio(folder, ext: List[str] = AUDIO_EXTENSIONS):
    """Audio files under ``folder`` (recursively), or ``[folder]`` when it
    names an audio file itself."""
    if str(folder).endswith(tuple(ext)):
        return [Path(folder)]
    found = []
    for suffix in ext:
        found.extend(Path(folder).glob(f"**/*{suffix}"))
    return found


def read_sources(sources: List[str], remove_empty: bool = True,
                 relative_path: str = None, ext: List[str] = AUDIO_EXTENSIONS):
    """Folders and CSV manifests -> one sorted list of ``{"path": ...}``
    rows per source. Relative CSV paths are anchored at ``relative_path``,
    or else at the ``PATH_TO_DATA`` environment variable."""
    csv_anchor = Path(relative_path if relative_path is not None
                      else os.getenv("PATH_TO_DATA", ""))
    folder_anchor = Path(relative_path or "")
    files = []
    for source in map(str, sources):
        if source.endswith(".csv"):
            entries = []
            with open(source, "r") as f:
                for row in csv.DictReader(f):
                    if row["path"]:
                        row["path"] = str(csv_anchor / row["path"])
                        entries.append(row)
                    elif not remove_empty:
                        entries.append(row)
        else:
            entries = [{"path": str(folder_anchor / p)} for p in find_audio(source, ext)]
        files.append(sorted(entries, key=lambda row: row["path"]))
    return files


def choose_from_list_of_lists(state: np.random.RandomState, list_of_lists, p=None):
    """Draw a source (weighted by ``p``), then an item in it."""
    source_idx = state.choice(list(range(len(list_of_lists))), p=p)
    item_idx = state.randint(len(list_of_lists[source_idx]))
    return list_of_lists[source_idx][item_idx], source_idx, item_idx


def _default_collate(values):
    """Stack one column of per-item values."""
    v0 = values[0]
    if isinstance(v0, torch.Tensor):
        return torch.stack(values)
    if isinstance(v0, np.ndarray):
        return np.stack(values)
    if isinstance(v0, (bool, np.bool_)):
        return np.asarray(values, dtype=bool)
    if isinstance(v0, (int, np.integer)):
        return np.asarray(values, dtype=np.int32)
    if isinstance(v0, (float, np.floating)):
        return np.asarray(values, dtype=np.float32)
    return values


def collate(list_of_dicts: list):
    """Collate item dicts key by key: AudioSignals into one batched signal
    (zero-padded to the longest), other values stacked."""
    from .signal import AudioSignal

    flat_items = [flatten(d) for d in list_of_dicts]
    merged = {}
    for key in flat_items[0]:
        column = [d[key] for d in flat_items]
        if all(isinstance(s, AudioSignal) for s in column):
            merged[key] = AudioSignal.batch(column, pad_signals=True)
        else:
            merged[key] = _default_collate(column)
    return unflatten(merged)


def _to_device(v, device, pin: bool):
    if isinstance(v, np.ndarray) and v.dtype.kind in "fiu":
        v = torch.from_numpy(np.ascontiguousarray(v))
    if isinstance(v, torch.Tensor):
        if pin and v.device.type == "cpu":
            v = v.pin_memory()
        return v.to(device, non_blocking=pin)
    return v


def prepare_batch(batch, device):
    """Move a (nested) collated batch onto ``device``.

    Numeric numpy arrays become tensors; tensors and the audio of every
    ``AudioSignal`` are copied there, from pinned host memory and without
    blocking when ``device`` is a CUDA device. Boolean arrays (transform
    masks) stay numpy: they are control data, read on the host. Strings
    and other values pass through.
    """
    from .signal import AudioSignal

    device = torch.device(device)
    pin = device.type == "cuda"

    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(walk(x) for x in v)
        if isinstance(v, AudioSignal):
            out = v.clone()
            out._audio_data = _to_device(v.audio_data, device, pin)
            if v._loudness is not None:
                out._loudness = _to_device(v._loudness, device, pin)
            return out
        return _to_device(v, device, pin)

    return walk(batch)


def from_numpy_tree(tree, device):
    """The port's batch from a collated batch whose array leaves are numpy.

    Any object with ``audio_data`` and ``sample_rate`` becomes an
    :class:`AudioSignal` (with its cached loudness, when it has one), so a
    batch collated by the JAX package, after ``np.asarray`` of every leaf,
    feeds the port's chain unchanged. A leaf that converts to a boolean
    array (including a prob-1.0 mask sentinel) becomes a host numpy bool
    array; numeric leaves become tensors on ``device`` (see
    :func:`prepare_batch`).
    """
    from .signal import AudioSignal

    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(walk(x) for x in v)
        if hasattr(v, "audio_data") and hasattr(v, "sample_rate"):
            sig = AudioSignal(np.array(v.audio_data), v.sample_rate, device="cpu")
            loud = getattr(v, "_loudness", None)
            if loud is not None:
                sig._loudness = torch.as_tensor(np.asarray(loud))
            sig.metadata = dict(getattr(v, "metadata", {}) or {})
            sig.path_to_file = getattr(v, "path_to_file", None)
            return sig
        if isinstance(v, (str, bytes)) or v is None:
            return v
        arr = np.asarray(v)
        if arr.dtype == bool:
            return arr
        return arr if arr.dtype.kind not in "fiu" else torch.from_numpy(arr.copy())

    return prepare_batch(walk(tree), device)
