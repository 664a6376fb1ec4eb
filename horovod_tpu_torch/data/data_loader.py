"""Data loaders: per-rank sharding, background prefetch, and the feed
that stages batches onto the card ahead of the step (counterpart of
horovod_tpu/data/data_loader.py; reference horovod/data/
data_loader_base.py).

`ShardedDataset` shards by (rank, size) with the JAX package's order:
the epoch's permutation is `np.random.default_rng(seed + epoch).shuffle`,
so every rank reads the same indices as there, bit for bit.

`DeviceFeed` is the port of the JAX package's device-resident feed: a
producer thread copies each host batch into pinned memory and then to
the card with `non_blocking=True` on a side CUDA stream, while the step
before it runs, and parks it in a bounded queue; the consumer's only
blocking point, the queue's get, is perfscope's ``input_wait``.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree


class BaseDataLoader:
    """Iterable loader contract (reference: data_loader_base.py:20).

    Subclasses may define __len__; the base does not, since a raising
    __len__ would break list(loader), which probes len()."""

    def _iterate(self) -> Iterator[Any]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Any]:
        return self._iterate()


class AsyncDataLoaderMixin:
    """Background-thread prefetch (reference: data_loader_base.py:48).

    Mix in BEFORE the loader class:
        class MyAsyncLoader(AsyncDataLoaderMixin, MyLoader): ...
    `async_loader_queue_size=0` disables prefetch (synchronous passthrough).
    """

    def __init__(self, *args, async_loader_queue_size: int = 4, **kwargs):
        self.async_loader_queue_size = async_loader_queue_size
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._closing = False
        super().__init__(*args, **kwargs)

    def close_async_loader(self) -> None:
        """Reference: close_async_loader (:73): drain and join."""
        self._closing = True
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _async_worker(self) -> None:
        """Producer thread (reference: _async_worker :95)."""
        try:
            for batch in super()._iterate():
                if self._closing:
                    break
                self._queue.put(batch)
        finally:
            self._queue.put(None)  # end-of-epoch sentinel

    def _iterate(self) -> Iterator[Any]:
        if self.async_loader_queue_size <= 0:
            yield from super()._iterate()
            return
        self._queue = queue.Queue(self.async_loader_queue_size)
        self._closing = False
        self._thread = threading.Thread(target=self._async_worker,
                                        daemon=True)
        self._thread.start()
        while True:
            batch = self._queue.get()
            if batch is None:
                break
            yield batch
        self._thread.join(timeout=10)
        self._thread = None


class ShardedDataset(BaseDataLoader):
    """Shard an indexable dataset by rank (the semantics of torch's
    DistributedSampler and Horovod's elastic sampler), with set_epoch to
    reshuffle and record skipping for a mid-epoch resume."""

    def __init__(self, data, rank: int, size: int, batch_size: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True):
        self.data = data
        self.rank = rank
        self.size = size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.processed_indices: int = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.processed_indices = 0

    def record_batch(self) -> None:
        """Mark one batch consumed (for an elastic resume)."""
        self.processed_indices += self.batch_size

    def skip_to(self, processed: int) -> None:
        """Position the stream at an absolute per-rank record offset: a
        mid-epoch resume continues from the first unconsumed record of
        the same shuffled order."""
        self.processed_indices = max(0, int(processed))

    def _indices(self) -> np.ndarray:
        n = len(self.data)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # Pad to a multiple of size*batch so every rank sees equal batches.
        per = self.size * self.batch_size
        if self.drop_last:
            idx = idx[: (n // per) * per]
        else:
            pad = (-n) % per
            idx = np.concatenate([idx, idx[:pad]])
        mine = idx[self.rank::self.size]
        return mine[self.processed_indices:]

    def __len__(self) -> int:
        return len(self._indices()) // self.batch_size

    def _iterate(self):
        mine = self._indices()
        for i in range(0, len(mine) - self.batch_size + 1, self.batch_size):
            batch_idx = mine[i:i + self.batch_size]
            yield [self.data[int(j)] for j in batch_idx]


def _is_array(leaf) -> bool:
    return hasattr(leaf, "shape") and hasattr(leaf, "dtype")


class DeviceFeed:
    """Double-buffered input feed onto `device` (default hvd.device()).

    A producer thread pulls host batches from `source` (any pytree of
    tensors or numpy arrays; other leaves pass through) and stages them;
    at most `depth` staged batches wait in the queue. On a card the
    producer, which first makes `device` its current device (a new
    thread starts on cuda:0), copies each array leaf into pinned memory
    and then to the card with `non_blocking=True` on its own CUDA
    stream, and records an event after the copies. The consumer makes
    its current stream wait on that event and calls `record_stream` on
    each staged tensor, so the caching allocator does not hand the block
    to another tensor while the side stream may still write it. The
    producer keeps each batch's pinned buffers until its event has
    completed. On the host (`device="cpu"`) staging is `torch.as_tensor`.

    The consumer's wait in the queue's get is perfscope's
    ``input_wait`` (`scope`, default the process-wide scope): a starved
    feed parks its starvation there, a prefetched one ~0. ``depth=0``
    pulls and stages inline, all of it inside ``input_wait``. A
    source's exception is raised to the consumer, after the batches
    staged before it. Each produced batch passes the
    ``data.feed.produce`` fault-injection site (testing/faults.py: a
    latency rule there is a slow preprocessing tier).
    """

    _SENTINEL = object()

    def __init__(self, source: Iterable[Any], device=None,
                 depth: int = 2, scope=None):
        if device is None:
            from horovod_tpu_torch.core import topology
            device = topology.device()
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.source = iter(source)
        self.device = device
        self.depth = int(depth)
        self._scope = scope
        self._side: Optional[torch.cuda.Stream] = None
        # (copy event, pinned host tensors) of batches whose copy may
        # still run; touched only by the thread that stages.
        self._host_refs: collections.deque = collections.deque()
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        if self.depth > 0:
            self._q = queue.Queue(maxsize=self.depth)
            self._thread = threading.Thread(target=self._produce,
                                            name="hvd-device-feed",
                                            daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ staging
    def _release_host(self, wait: bool = False) -> None:
        while self._host_refs:
            ev, _ = self._host_refs[0]
            if wait:
                ev.synchronize()
            elif not ev.query():
                return
            self._host_refs.popleft()

    def _stage(self, batch):
        """Host batch -> (staged batch, copy event or None)."""
        if self.device.type != "cuda":
            return pytree.tree_map(
                lambda x: torch.as_tensor(x, device=self.device)
                if _is_array(x) else x, batch), None
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        pinned = []

        def put(leaf):
            if not _is_array(leaf):
                return leaf
            t = torch.as_tensor(leaf)
            if t.device.type == "cpu":
                if not t.is_pinned():
                    t = t.pin_memory()
                pinned.append(t)
            return t.to(self.device, non_blocking=True)

        with torch.cuda.stream(self._side):
            out = pytree.tree_map(put, batch)
            ev = torch.cuda.Event()
            ev.record(self._side)
        self._release_host()
        self._host_refs.append((ev, pinned))
        return out, ev

    def _produce(self) -> None:
        from horovod_tpu_torch.testing import faults
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            for batch in self.source:
                if self._stop.is_set():
                    return
                faults.inject("data.feed.produce")
                if not self._bounded_put(self._stage(batch)):
                    return
        except BaseException as e:  # raised on the consumer's side
            self._error = e
        finally:
            self._bounded_put(self._SENTINEL)
            self._release_host(wait=True)

    def _bounded_put(self, item) -> bool:
        """Put that stays responsive to close(): a plain put() would
        leave the producer blocked forever once the consumer is gone."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    # ----------------------------------------------------------- consume
    def _perfscope(self):
        if self._scope is not None:
            return self._scope
        from horovod_tpu_torch.profiler import perfscope
        return perfscope.get()

    def __iter__(self) -> Iterator[Any]:
        return self

    def _ready(self, staged, ev):
        """Order the consumer's stream after the batch's copy."""
        if ev is None:
            return staged
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ev)
        for t in pytree.tree_leaves(staged):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(cur)
        return staged

    def __next__(self):
        if self.depth <= 0:
            from horovod_tpu_torch.testing import faults
            with self._perfscope().phase("input_wait"):
                batch = next(self.source)
                faults.inject("data.feed.produce")
                item = self._stage(batch)
            return self._ready(*item)
        with self._perfscope().phase("input_wait"):
            # Poll, not a bare get(): close() drains the queue and the
            # stopped producer's sentinel is refused, so a consumer
            # blocked here, or arriving after close(), would hang.
            while True:
                try:
                    item = self._q.get(timeout=0.2)
                    break
                except queue.Empty:
                    if self._stop.is_set():
                        raise StopIteration  # the feed was closed
        if item is self._SENTINEL:
            self._q.put(item)  # keep raising for later calls
            if self._error is not None:
                raise self._error
            raise StopIteration
        return self._ready(*item)

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self, timeout: float = 2.0) -> bool:
        """Stop the producer and drop staged batches. Returns True when
        the producer thread exited.

        A producer blocked inside the source (a socket's recv, say)
        cannot be interrupted from here: the stop flag is read between
        batches and in the bounded put. Its (daemon) thread then exits
        at the source's next yield or raise; close() returns False and
        keeps the thread reference, and the queue is left empty, so the
        stopped producer can never park another batch."""
        self._stop.set()
        if self._q is not None:
            self._drain()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                return False
            self._thread = None
        if self._q is not None:
            self._drain()  # a put that raced the first drain
        return True
