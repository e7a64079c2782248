"""Prefetching data loader with device staging.

Counterpart of ``audiotools_tpu/data/loader.py``. Worker threads run
``dataset[idx]`` (host decode and parameter draws: numpy work that
releases the interpreter lock), the batch is collated, and it is staged
onto the device (the card unless ``device="cpu"``) by a background
thread: numeric arrays and signal audio are copied from pinned memory
without blocking, on a side stream on CUDA, so the copy of batch N+1
overlaps the consumer's work on batch N. The background thread stops
when the consumer stops iterating, including after an early ``break``.

With ``wire_dtype="int16"``, the audio of every AudioSignal in a batch
(those in lists, tuples and ``transform_args`` too) crosses to the card as
int16 (``AudioSignal.quantize_wire``: half the bytes, error at most
2**-16); the consumer restores it there with ``dequantize_wire`` or
``util.dequantize_batch``.
"""
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from .._hostprof import span
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


def _wire_quantize(batch, wire_dtype):
    """Quantize, in place, the audio of every AudioSignal in a freshly
    collated batch (nested dicts, lists and tuples)."""
    return util._map_signals(batch, lambda s: s.quantize_wire(wire_dtype))


class DataLoader:
    """Batched, prefetching loader over a map-style dataset.

    Parameters
    ----------
    dataset : AudioDataset
        Defines ``__getitem__`` and ``__len__``; items are dicts.
    batch_size : int
    num_workers : int
        Threads building items concurrently (0: in the consumer's thread).
    sampler : iterable, optional
        The indices to load, in order (e.g. ``ResumableSequentialSampler``);
        by default ``range(len(dataset))``.
    collate_fn : callable, optional
        Items to a batch; by default ``dataset.collate`` where the dataset
        has one, else ``util.collate``.
    drop_last : bool
        Drop a last batch shorter than ``batch_size``.
    prefetch_batches : int
        Batches kept ready ahead of the consumer.
    to_device : bool
        Stage every batch onto ``device`` (the default). ``False``, the JAX
        package's default, is ``device="cpu"`` with no wire quantization:
        the batches stay on the host as collated. It refuses a card
        ``device``.
    device : optional
        Stage every batch onto this device (``util.prepare_batch``); by
        default the card (raising when there is none). ``"cpu"`` keeps the
        batches on the host.
    wire_dtype : str, optional
        ``"int16"`` stages the audio as int16 (module docstring).
    """

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 0, sampler=None,
                 collate_fn=None, drop_last: bool = False, prefetch_batches: int = 2,
                 to_device: bool = True, device=None, wire_dtype: str = None):
        if wire_dtype not in (None, "int16"):
            raise ValueError(f"unsupported wire_dtype {wire_dtype!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.sampler = sampler
        self.collate_fn = collate_fn or getattr(dataset, "collate", util.collate)
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self.to_device = to_device
        if not to_device:
            if device is not None and torch.device(device).type != "cpu":
                raise ValueError(f"to_device=False keeps the batches on the host, not on {device}")
            device, wire_dtype = "cpu", None
        self.device = torch.device(device) if device is not None else util.default_device()
        self.wire_dtype = wire_dtype

    def _index_batches(self):
        indices = self.sampler if self.sampler is not None else range(len(self.dataset))
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, items):
        batch = self.collate_fn(items)
        return _wire_quantize(batch, self.wire_dtype) if self.wire_dtype else batch

    def _stage(self, batch, stream):
        """Copy ``batch`` to the device; returns it with the CUDA event that
        marks the end of its copy (``None`` when there is nothing to wait on)."""
        if stream is None:
            with span("device_put"):
                return util.prepare_batch(batch, self.device), None
        with torch.cuda.stream(stream), span("device_put"):
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
                batch = self._collate([self.dataset[i] for i in idx_batch])
                yield self._ready(*self._stage(batch, None))
            return

        out_q = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        on_cuda = self.device.type == "cuda"
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
                        if not put(self._stage(self._collate(items), stream)):
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
