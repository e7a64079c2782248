"""Datasets over audio sources, aligned multitrack loading and resumable
samplers.

Counterpart of ``audiotools_tpu/data/datasets.py``: item ``idx`` seeds
``numpy.random.RandomState(idx)``, which draws the excerpt offsets and the
transform parameters on the host in the JAX package's order, so both
packages produce the same batch. The distributed sampler reads its rank
and world size from ``torch.distributed`` when it is initialised.
"""
from pathlib import Path
from typing import Callable, Dict, List, Union

import numpy as np

from ..core import AudioSignal
from ..core import util


class AudioLoader:
    """Draws excerpts from folders or CSV manifests.

    Parameters
    ----------
    sources : list of str
        Folders or CSVs listing audio files.
    weights : list of float, optional
        Sampling weight per source.
    relative_path : str, optional
        Root for relative paths in the sources.
    transform : callable, optional
        Transform instantiated with each draw (under ``"transform_args"``).
    relative_path : str, optional
        Root for relative paths in the sources.
    ext : list of str
        Extensions to find audio by.
    shuffle, shuffle_state :
        Shuffle (seeded) the flat file index used by ``global_idx``.
    """

    def __init__(self, sources: List[str] = None, weights: List[float] = None,
                 transform: Callable = None, relative_path: str = None,
                 ext: List[str] = util.AUDIO_EXTENSIONS, shuffle: bool = True,
                 shuffle_state: int = 0):
        self.sources = sources
        self.weights = weights
        self.transform = transform
        self.audio_lists = util.read_sources(sources, relative_path=relative_path, ext=ext)
        self.audio_indices = [
            (src_idx, item_idx)
            for src_idx, entries in enumerate(self.audio_lists)
            for item_idx in range(len(entries))
        ]
        if shuffle:
            util.random_state(shuffle_state).shuffle(self.audio_indices)

    def _select(self, state, source_idx, item_idx, global_idx):
        """The entry at explicit ``(source_idx, item_idx)`` (silence,
        ``{"path": "none"}``, where there is none), else ``global_idx`` into
        the shuffled flat index, else a weighted draw."""
        if source_idx is not None and item_idx is not None:
            try:
                entry = self.audio_lists[source_idx][item_idx]
            except IndexError:
                entry = {"path": "none"}
            return entry, source_idx, item_idx
        if global_idx is not None:
            source_idx, item_idx = self.audio_indices[global_idx % len(self.audio_indices)]
            return self.audio_lists[source_idx][item_idx], source_idx, item_idx
        return util.choose_from_list_of_lists(state, self.audio_lists, p=self.weights)

    def __call__(self, state, sample_rate: int, duration: float,
                 loudness_cutoff: float = -40, num_channels: int = 1,
                 offset: float = None, source_idx: int = None, item_idx: int = None,
                 global_idx: int = None):
        """Draw one excerpt, decoded and metered on the host: a salient
        excerpt at a random offset, or the one at ``offset``, or silence for
        the path ``"none"``, as ``{"signal", "source_idx", "item_idx",
        "source", "path"}`` (and ``"transform_args"`` with a transform)."""
        entry, source_idx, item_idx = self._select(state, source_idx, item_idx, global_idx)
        path = entry["path"]
        if path == "none":
            signal = AudioSignal.zeros(duration, sample_rate, num_channels, device="cpu")
        elif offset is None:
            signal = AudioSignal.salient_excerpt(
                path, duration=duration, state=state, loudness_cutoff=loudness_cutoff,
                device="cpu",
            )
        else:
            signal = AudioSignal(path, offset=offset, duration=duration, device="cpu")
        if num_channels == 1:
            signal = signal.to_mono()
        signal = signal.resample(sample_rate)
        if signal.duration < duration:
            signal = signal.zero_pad_to(int(duration * sample_rate))
        signal.metadata.update(entry)

        item = {
            "signal": signal,
            "source_idx": source_idx,
            "item_idx": item_idx,
            "source": str(self.sources[source_idx]),
            "path": str(path),
        }
        if self.transform is not None:
            item["transform_args"] = self.transform.instantiate(state, signal=signal)
        return item


def default_matcher(x, y):
    """Two paths name the same recording when they share a folder."""
    return Path(x).parent == Path(y).parent


def align_lists(lists, matcher: Callable = default_matcher):
    """Pad multitrack file lists in place so that index ``i`` names the
    same recording in every list. The longest list is the anchor: where
    another list's entry at a position does not ``matcher`` the anchor's,
    a silent entry ``{"path": "none"}`` is inserted there (or appended
    once the list has run out)."""
    anchor = max(lists, key=len)
    for pos, anchor_entry in enumerate(anchor):
        for tracks in lists:
            if pos >= len(tracks):
                tracks.append({"path": "none"})
            elif not matcher(tracks[pos]["path"], anchor_entry["path"]):
                tracks.insert(pos, {"path": "none"})
    return lists


class AudioDataset:
    """Map-style dataset over one or more AudioLoaders; ``dataset[idx]``
    is reproducible from ``idx`` alone.

    Parameters
    ----------
    loaders : AudioLoader, list or dict of AudioLoaders
    sample_rate : int
    n_examples : int
    duration : float
        Seconds per excerpt.
    loudness_cutoff : float
        Minimum excerpt loudness in LUFS.
    offset : float, optional
        Kept for the original library's signature: as there and in the JAX
        package, excerpts start where the first loader draws them.
    num_channels : int
    transform : callable, optional
        Transform instantiated for each item (parameters under
        ``"transform_args"``).
    aligned : bool
        Multitrack loading: the loaders' file lists are padded with silence
        (:func:`align_lists`) so that equal indices name one recording, and
        every loader reads the file and offset the first one drew.
    shuffle_loaders : bool
        Draw the loaders in a seeded random order (the first drawn leads).
    matcher : callable
        Whether two paths name the same recording (:func:`default_matcher`).
    without_replacement : bool
        Item ``idx`` reads file ``idx`` of each loader's shuffled index;
        otherwise each draws a file at random.
    """

    def __init__(self, loaders: Union[AudioLoader, List[AudioLoader], Dict[str, AudioLoader]],
                 sample_rate: int, n_examples: int = 1000, duration: float = 0.5,
                 offset: float = None, loudness_cutoff: float = -40,
                 num_channels: int = 1, transform: Callable = None, aligned: bool = False,
                 shuffle_loaders: bool = False, matcher: Callable = default_matcher,
                 without_replacement: bool = True):
        if isinstance(loaders, AudioLoader):
            loaders = {0: loaders}
        elif isinstance(loaders, list):
            loaders = dict(enumerate(loaders))
        self.loaders = loaders
        self.sample_rate = sample_rate
        self.length = n_examples
        self.duration = duration
        self.offset = offset
        self.loudness_cutoff = loudness_cutoff
        self.num_channels = num_channels
        self.transform = transform
        self.aligned = aligned
        self.shuffle_loaders = shuffle_loaders
        self.without_replacement = without_replacement
        if aligned:
            all_loaders = list(loaders.values())
            for src in range(len(all_loaders[0].audio_lists)):
                align_lists([loader.audio_lists[src] for loader in all_loaders], matcher)

    def __getitem__(self, idx):
        state = util.random_state(idx)
        draw_order = list(self.loaders.keys())
        if self.shuffle_loaders:
            state.shuffle(draw_order)
        shared = dict(state=state, sample_rate=self.sample_rate, duration=self.duration,
                      loudness_cutoff=self.loudness_cutoff, num_channels=self.num_channels,
                      global_idx=idx if self.without_replacement else None)
        drawn, lead = {}, None
        for name in draw_order:
            kwargs = dict(shared)
            if self.aligned and lead is not None:
                # follow the first draw: its file coordinates and start offset
                kwargs.update(offset=lead["signal"].metadata["offset"],
                              source_idx=lead["source_idx"], item_idx=lead["item_idx"])
            drawn[name] = self.loaders[name](**kwargs)
            if lead is None:
                lead = drawn[name]
        item = {name: drawn[name] for name in self.loaders}  # in declaration order
        item["idx"] = idx
        if self.transform is not None:
            first = next(iter(self.loaders))
            item["transform_args"] = self.transform.instantiate(
                state=state, signal=item[first]["signal"]
            )
        if len(self.loaders) == 1:
            item.update(item.pop(next(iter(self.loaders))))
        return item

    def __len__(self):
        return self.length

    collate = staticmethod(util.collate)


class ConcatDataset(AudioDataset):
    """Datasets interleaved: item ``i`` is item ``i // n`` of dataset ``i %
    n``, for ``n`` datasets."""

    def __init__(self, datasets: list):
        self.datasets = datasets

    def __len__(self):
        return sum(len(child) for child in self.datasets)

    def __getitem__(self, idx):
        return self.datasets[idx % len(self.datasets)][idx // len(self.datasets)]


class ResumableSequentialSampler:
    """Indices ``0 .. len(dataset) - 1`` in order, the first epoch from
    ``start_idx`` (to resume a run), every later one from 0."""

    def __init__(self, dataset, start_idx: int = None, **kwargs):
        self.dataset = dataset
        self.start_idx = start_idx if start_idx is not None else 0

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        for i in range(len(self.dataset)):
            if i >= self.start_idx:
                yield i
        self.start_idx = 0


def _process_group():
    """(world size, rank) of ``torch.distributed``'s default group, or (1, 0)
    when it is not initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ResumableDistributedSampler:
    """Each replica's interleaved share of the indices, resumable from a
    global ``start_idx``; with ``shuffle``, a permutation seeded by ``seed +
    epoch`` (``set_epoch``), as torch's ``DistributedSampler`` draws it.
    ``num_replicas`` and ``rank`` default to ``torch.distributed``'s world
    size and rank when it is initialised, else 1 and 0."""

    def __init__(self, dataset, start_idx: int = None, num_replicas: int = None,
                 rank: int = None, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, **kwargs):
        world, own_rank = _process_group()
        self.dataset = dataset
        self.num_replicas = num_replicas if num_replicas is not None else world
        self.rank = rank if rank is not None else own_rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.start_idx = start_idx // self.num_replicas if start_idx is not None else 0
        if drop_last:
            self.num_samples = len(dataset) // self.num_replicas
        else:
            self.num_samples = -(-len(dataset) // self.num_replicas)
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.seed + self.epoch).permutation(n).tolist()
        else:
            indices = list(range(n))
        if self.drop_last:
            indices = indices[:self.total_size]
        else:
            indices += indices[:self.total_size - len(indices)]
        for i, idx in enumerate(indices[self.rank:self.total_size:self.num_replicas]):
            if i >= self.start_idx:
                yield idx
        self.start_idx = 0
