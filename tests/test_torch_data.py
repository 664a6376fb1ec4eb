"""The port's data loaders (horovod_tpu_torch/data/data_loader.py)
against the JAX package's.

`ShardedDataset` must give the JAX package's batches bit for bit over a
grid of (n, rank, size, batch, shuffle, seed, epoch, drop_last,
skip_to): both shuffle with np.random.default_rng(seed + epoch). The
async mixin prefetches every batch. `DeviceFeed` on device="cpu":
order, a source's error, close() under a full queue, under a consumer
blocked in next() and under a producer blocked in the source. Its
perfscope accounting is held against the JAX package's DeviceFeed
under one fake clock: a starved feed (the synchronous path, whose
source takes 0.5 s of the clock a batch) parks exactly that in
``input_wait``, within 1e-12 of the JAX summary; a prefetched one
spends under 5% there.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu import data as jdata
from horovod_tpu.profiler import perfscope as jps
from horovod_tpu_torch import data as tdata
from horovod_tpu_torch.profiler import perfscope as tps

GRID = [
    # n, rank, size, batch, shuffle, seed, epoch, drop_last, skip_to
    (n, rank, size, batch, shuffle, seed, epoch, drop_last, skip)
    for (n, size, batch), shuffle, (seed, epoch), drop_last, skip in
    itertools.product([(100, 4, 5), (37, 3, 4), (64, 1, 64), (10, 4, 3)],
                      [True, False], [(0, 0), (7, 3)], [True, False],
                      [0, 6])
    for rank in sorted({0, size - 1})
]


@pytest.mark.parametrize("case", GRID[::3] + GRID[1::7],
                         ids=lambda c: "-".join(map(str, c)))
def test_sharded_dataset_equals_jax(case):
    n, rank, size, batch, shuffle, seed, epoch, drop_last, skip = case
    data = list(range(1000, 1000 + n))
    out = []
    for mod in (jdata, tdata):
        s = mod.ShardedDataset(data, rank=rank, size=size, batch_size=batch,
                               shuffle=shuffle, seed=seed,
                               drop_last=drop_last)
        s.set_epoch(epoch)
        s.skip_to(skip)
        out.append((list(s), len(s), s._indices()))
    (jb, jn, ji), (tb, tn, ti) = out
    assert tb == jb and tn == jn
    assert ti.dtype == ji.dtype and np.array_equal(ti, ji)


def test_sharded_dataset_partitions_disjoint_and_complete():
    data = list(range(100))
    seen = []
    for r in range(4):
        for b in tdata.ShardedDataset(data, rank=r, size=4, batch_size=5,
                                      shuffle=False):
            assert len(b) == 5
            seen.extend(b)
    assert sorted(seen) == data


def test_sharded_dataset_elastic_resume():
    s = tdata.ShardedDataset(list(range(40)), rank=0, size=2, batch_size=5,
                             shuffle=False)
    first = list(s)
    assert len(first) == 4
    s.record_batch()
    s.record_batch()
    assert list(s) == first[2:]
    s.set_epoch(1)
    assert s.processed_indices == 0


def test_async_mixin_prefetches_all_batches():
    class Slow(tdata.BaseDataLoader):
        def _iterate(self):
            for i in range(5):
                time.sleep(0.01)
                yield i

    class AsyncSlow(tdata.AsyncDataLoaderMixin, Slow):
        pass

    loader = AsyncSlow(async_loader_queue_size=2)
    assert list(loader) == [0, 1, 2, 3, 4]
    assert list(loader) == [0, 1, 2, 3, 4]  # reusable across epochs
    loader.close_async_loader()
    assert list(AsyncSlow(async_loader_queue_size=0)) == [0, 1, 2, 3, 4]


# ------------------------------------------------------- DeviceFeed

def _batches(n):
    return [{"x": np.full((4,), i, np.float32), "tag": f"b{i}"}
            for i in range(n)]


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_device_feed_order_on_cpu(depth):
    feed = tdata.DeviceFeed(iter(_batches(5)), device="cpu", depth=depth)
    out = list(feed)
    assert [int(b["x"][0]) for b in out] == [0, 1, 2, 3, 4]
    assert [b["tag"] for b in out] == [f"b{i}" for i in range(5)]
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type ==
               "cpu" for b in out)
    assert feed.close() is True
    with pytest.raises(StopIteration):
        next(feed)


def test_device_feed_needs_a_device_or_init():
    """No device and no hvd.init(): the feed refuses rather than guess."""
    from horovod_tpu_torch.common.exceptions import HorovodError
    with pytest.raises(HorovodError, match="init"):
        tdata.DeviceFeed(iter(_batches(1)))


def test_device_feed_source_error_surfaces():
    def src():
        yield {"x": np.zeros((2,), np.float32)}
        raise RuntimeError("preprocessing exploded")

    feed = tdata.DeviceFeed(src(), device="cpu", depth=2)
    next(feed)
    with pytest.raises(RuntimeError, match="preprocessing exploded"):
        next(feed)
    with pytest.raises(RuntimeError, match="preprocessing exploded"):
        next(feed)   # keeps raising
    feed.close()


def test_device_feed_close_unblocks_full_queue_producer():
    feed = tdata.DeviceFeed(iter(_batches(50)), device="cpu", depth=1)
    next(feed)
    t = feed._thread
    assert feed.close() is True
    assert t is not None and not t.is_alive()


def test_device_feed_consumer_blocked_across_close_unblocks():
    gate = threading.Event()

    def src():
        yield {"x": np.zeros((2,), np.float32)}
        gate.wait(timeout=30)  # starve the consumer

    feed = tdata.DeviceFeed(src(), device="cpu", depth=2)
    next(feed)
    got = {}

    def consume():
        try:
            next(feed)
            got["result"] = "batch"
        except StopIteration:
            got["result"] = "stop"

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.1)  # let the consumer block in the queue's get
    feed.close(timeout=0.2)
    t.join(timeout=5)
    gate.set()
    assert not t.is_alive()
    assert got.get("result") == "stop"


def test_device_feed_close_with_source_blocked_producer():
    gate = threading.Event()

    def src():
        yield {"x": np.zeros((2,), np.float32)}
        gate.wait(timeout=30)  # "blocked in recv"
        yield {"x": np.ones((2,), np.float32)}

    feed = tdata.DeviceFeed(src(), device="cpu", depth=2)
    next(feed)
    t0 = time.monotonic()
    assert feed.close(timeout=0.3) is False
    assert time.monotonic() - t0 < 2.0
    t = feed._thread
    assert t is not None and t.is_alive()
    gate.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert feed._q.empty()


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _slow_source(clk, n, seconds):
    """Batches whose production takes `seconds` of the fake clock."""
    for b in _batches(n):
        clk.advance(seconds)
        yield b


def test_starved_feed_parks_time_in_input_wait_like_jax():
    """The synchronous path pulls inside input_wait: 0.5 s of source a
    batch is a third of each 1.5 s step, in both packages."""
    out = {}
    for tag, mod, psmod, kw in (("jax", jdata, jps, {}),
                                ("torch", tdata, tps, {"device": "cpu"})):
        clk = _FakeClock()
        ps = psmod.PerfScope(window=64, clock=clk)
        feed = mod.DeviceFeed(_slow_source(clk, 6, 0.5), depth=0, scope=ps,
                              **kw)
        for _ in range(4):
            with ps.step():
                next(feed)
                clk.advance(1.0)
        out[tag] = ps.summary()
    assert out["torch"]["phase_fractions"]["input_wait"] == \
        pytest.approx(1 / 3)
    assert out["torch"]["wall"]["mean_s"] == pytest.approx(1.5)
    for k in ("phases_s", "phase_fractions"):
        for ph, v in out["jax"][k].items():
            assert abs(out["torch"][k][ph] - v) <= 1e-12, (k, ph)


def test_prefetched_feed_input_wait_near_zero():
    """With the producer ahead, the get returns staged batches and
    input_wait stays ~0 of the fake clock's step."""
    clk = _FakeClock()
    ps = tps.PerfScope(window=64, clock=clk)
    feed = tdata.DeviceFeed(iter(_batches(6)), device="cpu", depth=2,
                            scope=ps)
    deadline = time.monotonic() + 10
    for _ in range(4):
        while feed._q.empty() and time.monotonic() < deadline:
            time.sleep(0.001)
        with ps.step():
            next(feed)
            clk.advance(1.0)
    s = ps.summary()
    feed.close()
    assert s["phase_fractions"].get("input_wait", 0.0) < 0.05
    assert s["wall"]["mean_s"] == pytest.approx(1.0)
