"""The host batch pipeline (diamond_tpu/data/prefetch.py), used without the device
episode store (``tpu.device_dataset`` off): producer threads draw segment ids from the
sampler, collate the segments on the host and pack the batch's arrays into one buffer
of pinned memory; one non-blocking copy takes it to the card on a side stream, with an
event the consumer's stream waits on before it uses the batch. Batches come out in the
sampler's order whatever the number of workers. Under data parallelism every rank draws
and collates the global batch (the samplers are seeded alike) and packs only its own
rows, with the global padding mask beside them (``BatchPrefetcher(dp=...)``, the
counterpart of the JAX prefetcher's ``sharding``).

On the CPU (the tests) the batch is the collate's arrays as tensors, no stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..parallel.mesh import DataParallel
from .batch_sampler import BatchSampler
from .dataset import Dataset
from .segment import DENSE_FIELDS, Batch, DeviceBatch, collate_segments_to_batch

_ALIGN = 16


def sample_batch(dataset: Dataset, sampler: BatchSampler) -> Batch:
    return collate_segments_to_batch([dataset[sid] for sid in sampler.sample()])


def pack(batch: Batch, dp: Optional[DataParallel] = None
         ) -> Tuple[np.ndarray, List[Tuple[str, np.dtype, tuple, int]]]:
    """The batch's dense arrays in one byte buffer, each at an offset aligned to 16
    bytes, and the layout (name, dtype, shape, offset) to read them back. With a
    data-parallel ``dp`` that issues collectives: only its rank's rows, and the whole
    padding mask as ``mask_global``."""
    arrays = [(name, np.ascontiguousarray(getattr(batch, name))) for name in DENSE_FIELDS]
    if dp is not None and dp.active:
        rows = dp.rows(len(batch.obs))
        arrays = [(name, np.ascontiguousarray(a[rows])) for name, a in arrays] + \
            [("mask_global", np.ascontiguousarray(batch.mask_padding))]
    layout, off = [], 0
    for name, a in arrays:
        layout.append((name, a.dtype, a.shape, off))
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    buf = np.zeros(off, np.uint8)
    for (name, dtype, shape, o), (_, a) in zip(layout, arrays):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    return buf, layout


_TORCH = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32,
          np.dtype(np.float32): torch.float32, np.dtype(np.bool_): torch.bool}


def unpack(buf: torch.Tensor, layout) -> DeviceBatch:
    """Views of a packed buffer (on any device) as a DeviceBatch."""
    out = {}
    for name, dtype, shape, off in layout:
        n = int(np.prod(shape)) * dtype.itemsize
        out[name] = buf[off:off + n].view(_TORCH[dtype]).view(shape)
    return DeviceBatch(**out)


class BatchPrefetcher:
    """An endless iterator of batches on ``device``, ``prefetch`` ahead.
    ``workers``: producer threads (0: each batch made on the consumer's thread when
    asked for, no lookahead). ``dp``: this rank's rows of each global batch."""

    def __init__(self, dataset: Dataset, sampler: BatchSampler, prefetch: int = 4,
                 workers: int = 2, device: Union[str, torch.device] = "cuda",
                 dp: Optional[DataParallel] = None) -> None:
        self.dataset = dataset
        self.sampler = sampler
        self.dp = dp
        self.device = torch.device(device)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._workers = workers
        self._threads: list = []
        self._lock = threading.Lock()  # the sampler's generator and the sequence number
        self._next_seq = 0
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _make(self) -> Tuple[int, object]:
        with self._lock:
            seq, self._next_seq = self._next_seq, self._next_seq + 1
            ids = self.sampler.sample()
        buf, layout = pack(collate_segments_to_batch([self.dataset[sid] for sid in ids]),
                           self.dp)
        host = torch.from_numpy(buf)
        if self._stream is None:
            return seq, (unpack(host.to(self.device), layout), None)
        host = host.pin_memory()
        with torch.cuda.stream(self._stream):
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return seq, (unpack(dev, layout), (dev, event))

    def _ready(self, item) -> DeviceBatch:
        """The consumer's stream waits for the batch's copy; the buffer is marked as used
        there, so the allocator does not hand it out while the consumer reads it."""
        batch, sync = item
        if sync is not None:
            dev, event = sync
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            dev.record_stream(cur)
        return batch

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._make()
            except Exception as e:  # raised in the consumer
                self._queue.put((-1, e))
                return
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.25)
                    break
                except queue.Full:
                    continue

    def start(self) -> "BatchPrefetcher":
        if self._workers > 0 and not any(t.is_alive() for t in self._threads):
            self._stop.clear()
            self._threads = [threading.Thread(target=self._worker, daemon=True,
                                              name="diamond-prefetch")
                             for _ in range(self._workers)]
            for t in self._threads:
                t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join()

    def __iter__(self) -> Iterator[DeviceBatch]:
        if self._workers == 0:
            while True:
                yield self._ready(self._make()[1])
        self.start()
        held, want = {}, 0
        while True:
            while want not in held:
                seq, item = self._queue.get()
                if isinstance(item, Exception):
                    raise item
                held[seq] = item
            yield self._ready(held.pop(want))
            want += 1
