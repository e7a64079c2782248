"""Datasets over audio sources.

Counterpart of ``audiotools_tpu/data/datasets.py`` for the augmentation
path: item ``idx`` seeds ``numpy.random.RandomState(idx)``, which draws
the excerpt offsets and the transform parameters on the host in the JAX
package's order, so both packages produce the same batch.
"""
from typing import Callable, Dict, List, Union

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
    ext : list of str
        Extensions to find audio by.
    shuffle, shuffle_state :
        Shuffle (seeded) the flat file index used by ``global_idx``.
    """

    def __init__(self, sources: List[str] = None, weights: List[float] = None,
                 relative_path: str = None, ext: List[str] = util.AUDIO_EXTENSIONS,
                 shuffle: bool = True, shuffle_state: int = 0):
        self.sources = sources
        self.weights = weights
        self.audio_lists = util.read_sources(sources, relative_path=relative_path, ext=ext)
        self.audio_indices = [
            (src_idx, item_idx)
            for src_idx, entries in enumerate(self.audio_lists)
            for item_idx in range(len(entries))
        ]
        if shuffle:
            util.random_state(shuffle_state).shuffle(self.audio_indices)

    def _select(self, state, global_idx):
        """``global_idx`` into the shuffled flat index, or a weighted draw."""
        if global_idx is not None:
            source_idx, item_idx = self.audio_indices[global_idx % len(self.audio_indices)]
            return self.audio_lists[source_idx][item_idx], source_idx, item_idx
        return util.choose_from_list_of_lists(state, self.audio_lists, p=self.weights)

    def __call__(self, state, sample_rate: int, duration: float,
                 loudness_cutoff: float = -40, num_channels: int = 1,
                 offset: float = None, global_idx: int = None):
        """Draw one excerpt: a salient excerpt at a random offset, or the one
        at ``offset``, as ``{"signal", "source_idx", "item_idx", "source",
        "path"}``."""
        entry, source_idx, item_idx = self._select(state, global_idx)
        path = entry["path"]
        if offset is None:
            signal = AudioSignal.salient_excerpt(
                path, duration=duration, state=state, loudness_cutoff=loudness_cutoff
            )
        else:
            signal = AudioSignal(path, offset=offset, duration=duration)
        if num_channels == 1:
            signal = signal.to_mono()
        signal = signal.resample(sample_rate)
        if signal.duration < duration:
            signal = signal.zero_pad_to(int(duration * sample_rate))
        signal.metadata.update(entry)

        return {
            "signal": signal,
            "source_idx": source_idx,
            "item_idx": item_idx,
            "source": str(self.sources[source_idx]),
            "path": str(path),
        }


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
    num_channels : int
    transform : callable, optional
        Transform instantiated for each item (parameters under
        ``"transform_args"``).

    Item ``idx`` reads file ``idx`` of each loader's shuffled index.
    """

    def __init__(self, loaders: Union[AudioLoader, List[AudioLoader], Dict[str, AudioLoader]],
                 sample_rate: int, n_examples: int = 1000, duration: float = 0.5,
                 loudness_cutoff: float = -40,
                 num_channels: int = 1, transform: Callable = None):
        if isinstance(loaders, AudioLoader):
            loaders = {0: loaders}
        elif isinstance(loaders, list):
            loaders = dict(enumerate(loaders))
        self.loaders = loaders
        self.sample_rate = sample_rate
        self.length = n_examples
        self.duration = duration
        self.loudness_cutoff = loudness_cutoff
        self.num_channels = num_channels
        self.transform = transform

    def __getitem__(self, idx):
        state = util.random_state(idx)
        item = {
            name: loader(
                state=state, sample_rate=self.sample_rate, duration=self.duration,
                loudness_cutoff=self.loudness_cutoff, num_channels=self.num_channels,
                global_idx=idx,
            )
            for name, loader in self.loaders.items()
        }
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
