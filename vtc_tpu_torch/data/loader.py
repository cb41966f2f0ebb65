"""Host-side data loader: map-style dataset -> shuffled, collated numpy
batches with background prefetch, and the copy of those batches to the card.

The port's own copy of ``vtc_tpu/data/loader.py:22-177``. A thread pool
gives the workers' overlap (decode work releases the GIL), and a worker's
error surfaces to the consumer. The shuffle is the JAX loader's:
``np.random.default_rng(seed + epoch)`` with an epoch counter that each
``__iter__`` advances, so both packages see the same batches.
``prefetch_to_device`` puts batches on the card ahead of the step, from
pinned host memory on a side CUDA stream.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.mesh import data_rank, data_world, shard_rows


def default_collate(items):
    """Stack a list of per-sample tuples into a batch tuple.

    Handles nested tuples (audio-with-comments) and dict metas; string /
    object fields collate to lists.
    """
    elem = items[0]
    if isinstance(elem, (tuple, list)):
        return tuple(default_collate([it[i] for it in items]) for i in range(len(elem)))
    if isinstance(elem, dict):
        return {k: default_collate([it[k] for it in items]) for k in elem}
    if isinstance(elem, np.ndarray):
        return np.stack(items)
    if isinstance(elem, (int, np.integer)):
        return np.asarray(items, dtype=np.int64)
    if isinstance(elem, (float, np.floating)):
        return np.asarray(items, dtype=np.float32)
    return list(items)


class DataLoader:
    """Batches of ``dataset`` in the JAX loader's order.

    Under a process group two ways of sharding the input over the data
    axis (``parallel.mesh``; the model places of a data rank load the same
    rows):

    * ``shard_by_process`` (``--multihost``): each process reads its slice
      ``p·n/P … (p+1)·n/P`` of the (identically shuffled) index stream in
      batches of ``batch_size``, as ``vtc_tpu/data/loader.py:66-95`` does,
      ``len`` included; the global batch is ``P·batch_size``;
    * ``shard_batches`` (``--n_devices``): every process walks the same
      global batches of ``batch_size`` and loads only its rows
      ``r·B/W … (r+1)·B/W`` of each (``parallel.mesh.shard_rows``).

    Without a group both are the single process's loader."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        collate_fn=default_collate,
        prefetch: int = 2,
        shard_by_process: bool = False,
        shard_batches: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(int(num_workers), 0)
        self.seed = seed
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self._epoch = 0
        self.process_index, self.process_count = (data_rank(), data_world()) \
            if shard_by_process else (0, 1)
        self.shard_batches = shard_batches

    def __len__(self) -> int:
        n = len(self.dataset) // self.process_count
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        if self.process_count > 1:
            per_host = n // self.process_count
            idx = idx[self.process_index * per_host : (self.process_index + 1) * per_host]
        batches = [
            idx[i : i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.shard_batches and data_world() > 1:
            batches = [b[shard_rows(len(b))] for b in batches]
        return batches

    def __iter__(self) -> Iterator:
        self._epoch += 1
        batches = self._batch_indices()

        if self.num_workers == 0:
            for b in batches:
                yield self.collate_fn([self.dataset[int(i)] for i in b])
            return

        yield from self._threaded_iter(batches)

    def _threaded_iter(self, batches):
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """put that keeps polling the stop event: a producer blocked
            forever in out_q.put when the consumer abandons the iterator
            mid-epoch would leak the thread pool and its buffered batches."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                def load_batch(b):
                    items = list(pool.map(self.dataset.__getitem__, [int(i) for i in b]))
                    return self.collate_fn(items)

                try:
                    for b in batches:
                        if stop.is_set():
                            return
                        if not put_or_stop(load_batch(b)):
                            return
                except Exception as e:  # surface worker errors to the consumer
                    put_or_stop(e)
                finally:
                    put_or_stop(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def _to_device(tree, device, non_blocking=False):
    """numpy arrays and tensors of a nested tuple/list/dict onto ``device``;
    other leaves (lists of strings) pass through."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, non_blocking) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not (tree and isinstance(tree[0], str)):
        return type(tree)(_to_device(v, device, non_blocking) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    if isinstance(tree, torch.Tensor):
        if non_blocking:
            tree = tree.pin_memory()
        return tree.to(device, non_blocking=non_blocking)
    return tree


def _tensors(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def prefetch_to_device(iterator, device=None, size: int = 2):
    """Overlap host batching with the step: put up to ``size`` batches on
    ``device`` (default: the card; raises without one) ahead of their use.

    On the card each batch is copied from pinned host memory with
    ``non_blocking`` on a side stream; the consumer's stream waits on the
    copy's event before the batch is yielded, and ``record_stream`` keeps
    the caching allocator from handing a batch's memory to the side stream
    while the consumer's stream may still read it. On the CPU the arrays
    become tensors without a copy."""
    device = resolve_device(device)
    if device.type != "cuda":
        for item in iterator:
            yield _to_device(item, device)
        return
    side = torch.cuda.Stream(device)
    buf = deque()

    def pop():
        item, ready = buf.popleft()
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ready)
        for t in _tensors(item):
            t.record_stream(stream)
        return item

    for item in iterator:
        with torch.cuda.stream(side):
            item = _to_device(item, device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        buf.append((item, ready))
        if len(buf) > size:
            yield pop()
    while buf:
        yield pop()
