"""Core utilities: seeding, source manifests, tensors, batch collation and
staging, figure styling, and the chord fixture.

Counterpart of ``audiotools_tpu/core/util.py`` without the TPU's mask
sentinel. Randomness stays host-side numpy
(``RandomState``) with the JAX package's draw order, so both packages draw
identical parameters for a batch.
"""
import csv
import math
import numbers
import os
import random
from contextlib import contextmanager, suppress
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch

from .._hostprof import span

AUDIO_EXTENSIONS = [".wav", ".flac", ".mp3", ".ogg"]


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


def as_device_tensor(x, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor: a tensor stays on its device, an array
    or list goes to the card (:func:`default_device`)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=default_device())


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


def hz_to_bin(hz, n_fft: int, sample_rate: int):
    """The closest of ``2 + n_fft // 2`` bins spaced evenly from 0 to Nyquist
    (the original library's grid) for each frequency in Hz, clipped at
    Nyquist; a tensor of ``hz``'s shape on its device."""
    from ._dsp import _grid

    hz = torch.as_tensor(hz, dtype=torch.float32)
    shape = hz.shape
    hz = torch.clamp(hz.reshape(-1), max=sample_rate / 2)
    freqs = torch.from_numpy(_grid(sample_rate / 2, 2 + n_fft // 2)[0]).to(hz.device)
    return torch.abs(hz[None, :] - freqs[:, None]).argmin(dim=0).reshape(shape)


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


def seed(random_seed):
    """Seed Python's ``random``, numpy's global state and torch (its CPU
    and CUDA generators)."""
    np.random.seed(random_seed)
    random.seed(random_seed)
    torch.manual_seed(random_seed)


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


@contextmanager
def chdir(newdir):
    """Work in ``newdir`` inside the block, and return on the way out."""
    curdir = os.getcwd()
    try:
        os.chdir(newdir)
        yield
    finally:
        os.chdir(curdir)


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


def collate(list_of_dicts: list, n_splits: int = None):
    """Collate item dicts key by key: AudioSignals into one batched signal
    (zero-padded to the longest), other values stacked. With ``n_splits``,
    a list of that many sub-batches (the last may be shorter)."""
    from .signal import AudioSignal

    def collate_chunk(items):
        flat_items = [flatten(d) for d in items]
        merged = {}
        for key in flat_items[0]:
            column = [d[key] for d in flat_items]
            if all(isinstance(s, AudioSignal) for s in column):
                merged[key] = AudioSignal.batch(column, pad_signals=True)
            else:
                merged[key] = _default_collate(column)
        return unflatten(merged)

    with span("collate"):
        if n_splits is None:
            return collate_chunk(list_of_dicts)
        per_split = int(math.ceil(len(list_of_dicts) / n_splits))
        return [collate_chunk(list_of_dicts[i:i + per_split])
                for i in range(0, len(list_of_dicts), per_split)]


def _map_signals(batch, fn):
    """``batch`` (dicts, lists and tuples, nested) with ``fn`` applied to
    every AudioSignal in it."""
    from .signal import AudioSignal

    def walk(v):
        if isinstance(v, AudioSignal):
            return fn(v)
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(walk(x) for x in v)
        return v

    return walk(batch)


def dequantize_batch(batch):
    """Undo the loader's int16 wire (``DataLoader(wire_dtype="int16")``) for
    every AudioSignal in a nested batch, ``transform_args`` included (the
    noise and impulse responses drawn by the transforms are signals too).
    Returns a new structure of cloned signals; float audio passes as it is."""
    return _map_signals(batch, lambda s: s.clone().dequantize_wire())


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


# -----------------------------------------------------------------------------
# plotting (as the JAX package's util.format_figure)
# -----------------------------------------------------------------------------

BASE_SIZE = 864
DEFAULT_FIG_SIZE = (9, 3)


def _inset_tick_labels(host_ax, ax, axis: str, color: str, fontsize: float):
    """Redraw one axis' tick labels as translucent in-plot annotations.

    Tick values come from ``ax`` but the text artists land on ``host_ax``
    (the figure's first axes) so stacked subplots label once. The first
    two ticks and the last are dropped: edge labels would collide with the
    figure border once the real axes are hidden.
    """
    if axis == "y":
        anchor = ax.get_xlim()[0]  # pin labels to the left edge
        keep = ax.get_yticks()[2:-1]
    else:
        anchor = ax.get_ylim()[0]  # pin labels to the bottom edge
        keep = ax.get_xticks()[2:-1]

    for value in keep:
        if axis == "y":
            xy = (anchor, value)
            text = f"{value / 1000:2.1f}k"  # Hz -> kHz
            offset, ha, va = (5, -5), "left", "top"
        else:
            xy = (value, anchor)
            text = f"{value:2.1f}s"
            offset, ha, va = (5, 5), "center", "bottom"
        host_ax.annotate(text, xy=xy, xycoords="data", xytext=offset, textcoords="offset points",
                         ha=ha, va=va, color=color, fontsize=fontsize, alpha=0.75)


def format_figure(fig_size: tuple = None, title: str = None, fig=None,
                  format_axes: bool = True, format: bool = True, font_color: str = "white"):
    """Borderless audio-plot styling: hide the matplotlib chrome, redraw
    tick labels *inside* the data area, and optionally inset a boxed title
    in the top-right corner. Used by specshow/waveplot/wavespec in
    ``core/display.py``; ``format=False`` skips styling entirely.
    matplotlib is imported here, not with the module."""
    import matplotlib.pyplot as plt

    if not format:
        return
    if fig is None:
        fig = plt.gcf()
    fig.set_size_inches(*(fig_size or DEFAULT_FIG_SIZE))
    if not fig.axes:
        return
    host_ax = fig.axes[0]

    # Scale fonts with rendered width so labels stay readable at any dpi.
    width_px = fig.get_size_inches()[0] * fig.dpi
    scale = width_px / BASE_SIZE

    if format_axes:
        for ax in fig.axes:
            _inset_tick_labels(host_ax, ax, "y", font_color, 12 * scale)
            _inset_tick_labels(host_ax, ax, "x", font_color, 12 * scale)
            # Data fills the whole canvas: no margins, spines, or ticks.
            ax.margins(0, 0)
            ax.set_axis_off()
            ax.xaxis.set_major_locator(plt.NullLocator())
            ax.yaxis.set_major_locator(plt.NullLocator())
        plt.subplots_adjust(top=1, bottom=0, right=1, left=0, hspace=0, wspace=0)

    if title is not None:
        label = host_ax.annotate(title, xy=(1, 1), xycoords="axes fraction", xytext=(-5, -5),
                                 textcoords="offset points", ha="right", va="top", color="white",
                                 fontsize=20 * scale)
        label.set_bbox(dict(facecolor="black", edgecolor="black", alpha=0.5))


_NOTE_OFFSETS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


def note_to_midi(note: str) -> int:
    """MIDI number of a note name such as ``"C4"``, ``"F#2"`` or ``"Bb3"``."""
    name, rest = note[0].upper(), note[1:]
    accidental = 0
    while rest and rest[0] in "#b!":
        accidental += 1 if rest[0] == "#" else -1
        rest = rest[1:]
    return 12 * (int(rest) + 1) + _NOTE_OFFSETS[name] + accidental


def midi_to_hz(midi: float) -> float:
    return 440.0 * (2.0 ** ((midi - 69) / 12.0))


def generate_chord_dataset(max_voices: int = 8, sample_rate: int = 44100, num_items: int = 5,
                           duration: float = 1.0, min_note: str = "C2", max_note: str = "C6",
                           output_dir: Path = "chords"):
    """A toy multitrack dataset of sine chords: ``num_items`` tracks of 1 to
    ``max_voices`` voices, each a sine at a random note of a random length
    in ``[0.85 duration, duration]``, written as ``track_i/voice_v.wav``,
    and one CSV per voice (``voice_v.csv``, with loudness) whose row ``i``
    is track ``i``'s file or empty. Draws come from Python's ``random`` in
    the JAX package's order, so a seeded run (:func:`seed`) writes the same
    files."""
    from .signal import AudioSignal
    from ..data.preprocess import create_csv

    midi_range = (note_to_midi(min_note), note_to_midi(max_note))
    output_dir = Path(output_dir)
    output_dir.mkdir(exist_ok=True)

    def random_voice():
        return AudioSignal.wave(frequency=midi_to_hz(random.randint(*midi_range)),
                                duration=random.uniform(0.85 * duration, duration),
                                sample_rate=sample_rate, shape="sine", device="cpu")

    tracks = []
    for idx in range(num_items):
        voices = {f"voice_{v}": random_voice() for v in range(random.randint(1, max_voices))}
        track_dir = output_dir / f"track_{idx}"
        track_dir.mkdir(exist_ok=True)
        for name, sig in voices.items():
            sig.write(track_dir / f"{name}.wav")
        tracks.append(voices)

    for name in {name for track in tracks for name in track}:
        column = [str(track[name].path_to_file) if name in track else "" for track in tracks]
        create_csv(column, output_dir / f"{name}.csv", loudness=True)
    return output_dir


@contextmanager
def _close_temp_files(tmpfiles: list):
    """Close and unlink temp files when the block exits, whether by
    success or error."""
    try:
        yield
    finally:
        for handle in tmpfiles:
            with suppress(Exception):
                handle.close()
                os.unlink(handle.name)
