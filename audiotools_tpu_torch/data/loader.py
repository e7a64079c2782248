"""Prefetching data loader with device staging.

Counterpart of ``audiotools_tpu/data/loader.py``. Worker threads run
``dataset[idx]`` (host decode and parameter draws: numpy work that
releases the interpreter lock), the batch is collated, and with
``device`` set it is staged there by a background thread: numeric arrays
and signal audio are copied from pinned memory without blocking, on a
side stream on CUDA, so the copy of batch N+1 overlaps the consumer's
work on batch N. The background thread stops when the consumer stops
iterating, including after an early ``break``.
"""
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from ..core import util

_DONE = object()
_POLL_SECONDS = 0.1


def _tensors(tree):
    """Every tensor in a collated batch (signal audio included)."""
    from ..core.signal import AudioSignal

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, AudioSignal):
        yield tree.audio_data
        if tree._loudness is not None:
            yield tree._loudness
    elif isinstance(tree, torch.Tensor):
        yield tree


class DataLoader:
    """Batched, prefetching loader over a map-style dataset.

    Parameters
    ----------
    dataset : AudioDataset
        Defines ``__getitem__`` and ``__len__``; items are dicts, collated
        by ``util.collate``.
    batch_size : int
    num_workers : int
        Threads building items concurrently (0: in the consumer's thread).
    prefetch_batches : int
        Batches kept ready ahead of the consumer.
    device : optional
        Stage every batch onto this device (``util.prepare_batch``).
    """

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 0,
                 prefetch_batches: int = 2, device=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch_batches = prefetch_batches
        self.device = torch.device(device) if device is not None else None

    def _index_batches(self):
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            yield list(range(start, min(start + self.batch_size, n)))

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _stage(self, batch, stream):
        """Copy ``batch`` to the device; returns it with the CUDA event that
        marks the end of its copy (``None`` when there is nothing to wait on)."""
        if self.device is None:
            return batch, None
        if stream is None:
            return util.prepare_batch(batch, self.device), None
        with torch.cuda.stream(stream):
            staged = util.prepare_batch(batch, self.device)
            event = torch.cuda.Event()
            event.record(stream)
        return staged, event

    def _ready(self, staged, event):
        """Make the consumer's stream wait for the copy, and keep the copied
        memory alive for the work the consumer queues on it."""
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in _tensors(staged):
                if t.device.type == "cuda":
                    t.record_stream(current)
        return staged

    def __iter__(self):
        if self.num_workers <= 0:
            for idx_batch in self._index_batches():
                batch = util.collate([self.dataset[i] for i in idx_batch])
                yield self._ready(*self._stage(batch, None))
            return

        out_q = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        on_cuda = self.device is not None and self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if on_cuda else None

        def put(item):
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=_POLL_SECONDS)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idx_batch in self._index_batches():
                        items = list(pool.map(self.dataset.__getitem__, idx_batch))
                        if not put(self._stage(util.collate(items), stream)):
                            return
            except Exception as e:  # handed to the consumer, which raises it
                put((e, None))
                return
            put((_DONE, None))

        producer = threading.Thread(target=produce, name="DataLoader-producer", daemon=True)
        producer.start()
        try:
            while True:
                item, event = out_q.get()
                if item is _DONE:
                    break
                if isinstance(item, Exception):
                    raise item
                yield self._ready(item, event)
        finally:
            stop.set()
            producer.join(timeout=60)
