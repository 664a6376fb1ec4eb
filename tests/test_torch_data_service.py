"""The port's data service (horovod_tpu_torch/data/service.py):
dispatcher, workers and client over loopback TCP, the cases of
tests/test_data_service.py, plus the two packages on one wire: a port
client reading a JAX DataWorker's stream (the worker in a spawned
process, ended with a kill) and a JAX client reading a port worker's.
Batches are numpy arrays and must arrive bit for bit.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu.data import service as jsvc
from horovod_tpu_torch.data.service import (DataDispatcher,
                                            DataServiceClient,
                                            DataServiceError, DataWorker)
from horovod_tpu_torch.runner import secret as secret_mod
from torch_data_service_worker import range_dataset
from torch_threads import leftover, snapshot


@pytest.fixture(scope="module", autouse=True)
def threads_at_start():
    return snapshot()


@pytest.fixture()
def service():
    """Dispatcher + 2 workers, HMAC-signed frames."""
    secret = bytes.fromhex(secret_mod.make_secret_key())
    disp = DataDispatcher(expected_workers=2, secret=secret)
    port = disp.start()
    addr = ("127.0.0.1", port)
    workers = [DataWorker(addr, secret=secret, poll_interval=0.02)
               for _ in range(2)]
    for w in workers:
        w.start()
    client = DataServiceClient(addr, secret=secret)
    yield disp, workers, client, secret
    for w in workers:
        w.stop()
    disp.stop()


def _want(i):
    return {"x": np.full((4,), i, np.int32),
            "y": np.arange(3, dtype=np.float32) * i}


def test_stream_covers_all_shards_exactly_once(service):
    disp, workers, client, _ = service
    client.register_dataset("train", range_dataset)
    got = list(client.stream("train"))
    assert sorted(int(b["x"][0]) for b in got) == list(range(12))
    for b in got:
        i = int(b["x"][0])
        np.testing.assert_array_equal(b["y"], _want(i)["y"])


def test_device_stream_covers_all_shards_on_the_device(service):
    disp, workers, client, _ = service
    client.register_dataset("dev", range_dataset)
    feed = client.device_stream("dev", device="cpu")
    got = []
    try:
        for b in feed:
            assert isinstance(b["x"], torch.Tensor)
            assert b["x"].device.type == "cpu"
            assert b["x"].dtype == torch.int32
            got.append(int(b["x"][0]))
    finally:
        feed.close()
    assert sorted(got) == list(range(12))


def test_two_datasets_get_fresh_shards(service):
    disp, workers, client, _ = service
    client.register_dataset("a", range_dataset)
    client.register_dataset("b", range_dataset)
    assert sorted(int(b["x"][0]) for b in client.stream("a")) == \
        list(range(12))
    assert sorted(int(b["x"][0]) for b in client.stream("b")) == \
        list(range(12))


def test_worker_error_surfaces_to_client(service):
    disp, workers, client, _ = service

    def bad_dataset(shard, num_shards):
        yield {"x": np.zeros(1)}
        raise RuntimeError("preprocessing exploded")

    client.register_dataset("bad", bad_dataset)
    with pytest.raises(DataServiceError, match="preprocessing exploded"):
        list(client.stream("bad"))


def test_unsigned_frames_rejected(service):
    disp, workers, client, secret = service
    intruder = DataServiceClient(("127.0.0.1", disp.port),
                                 secret=b"wrong-secret")
    with pytest.raises(Exception):
        intruder.register_dataset("x", range_dataset)
        intruder.wait_for_workers(timeout=1.0)


def test_wait_for_workers_times_out():
    disp = DataDispatcher(expected_workers=3, secret=b"k1")
    port = disp.start()
    try:
        client = DataServiceClient(("127.0.0.1", port), secret=b"k1")
        with pytest.raises(DataServiceError, match="data workers"):
            client.wait_for_workers(timeout=0.3)
    finally:
        disp.stop()


def test_prefetch_overlaps_production(service, tmp_path):
    disp, workers, client, _ = service
    marker_dir = str(tmp_path)

    def traced(shard, num_shards, _dir=marker_dir):
        import os
        for i in range(shard, 8, num_shards):
            open(os.path.join(_dir, f"produced_{i}"), "w").close()
            yield i

    client.register_dataset("pf", traced)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and len(os.listdir(marker_dir)) < 4:
        time.sleep(0.05)
    assert len(os.listdir(marker_dir)) >= 4
    assert sorted(client.stream("pf")) == list(range(8))


def test_run_worker_entry():
    from horovod_tpu_torch.data.service import run_worker
    disp = DataDispatcher(expected_workers=1, secret=b"k2")
    port = disp.start()
    try:
        w = run_worker(f"127.0.0.1:{port}", secret=b"k2")
        client = DataServiceClient(("127.0.0.1", port), secret=b"k2")
        client.register_dataset("t", lambda s, n: iter([42]))
        assert list(client.stream("t")) == [42]
        w.stop()
    finally:
        disp.stop()


def test_register_without_cloudpickle_sends_by_import_path(
        service, monkeypatch):
    """Where cloudpickle is absent (the GPU machine may lack it), a
    module-level dataset function still travels, by import path."""
    import builtins
    real_import = builtins.__import__

    def no_cloudpickle(name, *a, **k):
        if name == "cloudpickle":
            raise ImportError(name)
        return real_import(name, *a, **k)

    disp, workers, client, _ = service
    monkeypatch.setattr(builtins, "__import__", no_cloudpickle)
    client.register_dataset("plain", range_dataset)
    monkeypatch.setattr(builtins, "__import__", real_import)
    assert sorted(int(b["x"][0]) for b in client.stream("plain")) == \
        list(range(12))


def test_producer_exits_promptly_on_abrupt_disconnect(service):
    disp, workers, client, _ = service

    def big(shard, num_shards):
        for i in range(shard, 1000, num_shards):
            yield {"x": np.full((256,), i, np.int32)}

    client.register_dataset("leak", big)
    deadline = time.monotonic() + 10.0
    streams = []
    while time.monotonic() < deadline:
        streams = [w._streams.get("leak") for w in workers]
        if all(s is not None and s.q.full() for s in streams):
            break
        time.sleep(0.02)
    assert all(s is not None and s.q.full() for s in streams)
    threads = [s._thread for s in streams]
    assert all(t.is_alive() for t in threads)
    t0 = time.monotonic()
    for w in workers:
        w.stop()
    for t in threads:
        t.join(timeout=3.0)
    assert not any(t.is_alive() for t in threads)
    assert time.monotonic() - t0 < 5.0


def test_secret_is_required(monkeypatch):
    monkeypatch.delenv("HOROVOD_SECRET_KEY", raising=False)
    with pytest.raises(ValueError, match="secret"):
        DataDispatcher(expected_workers=1)
    with pytest.raises(ValueError, match="secret"):
        DataWorker(("127.0.0.1", 1))
    with pytest.raises(ValueError, match="secret"):
        DataServiceClient(("127.0.0.1", 1))


def test_port_client_reads_a_jax_worker(tmp_path):
    """A JAX-package DataWorker in a spawned process serves the port's
    dispatcher and client; the batches arrive bit for bit."""
    import multiprocessing as mp

    import torch_world_worker as tww
    from torch_data_service_worker import jax_worker
    secret_hex = secret_mod.make_secret_key()
    disp = DataDispatcher(expected_workers=1,
                          secret=bytes.fromhex(secret_hex))
    port = disp.start()
    ctx = mp.get_context("spawn")
    err = str(tmp_path / "jax_worker.err")
    proc = ctx.Process(target=tww.enter, args=(
        jax_worker, (port, secret_hex), err, time.time() + 80.0))
    proc.start()
    try:
        client = DataServiceClient(("127.0.0.1", port),
                                   secret=bytes.fromhex(secret_hex))
        client.register_dataset("cross", range_dataset)
        got = list(client.stream("cross", timeout=60.0))
        assert [int(b["x"][0]) for b in got] == list(range(12))
        for b in got:
            want = _want(int(b["x"][0]))
            for k in ("x", "y"):
                assert b[k].dtype == want[k].dtype
                np.testing.assert_array_equal(b[k], want[k])
    finally:
        proc.kill()
        proc.join(10)
        disp.stop()
    assert not proc.is_alive()


def test_jax_client_reads_a_port_worker(service):
    disp, workers, client, secret = service
    jc = jsvc.DataServiceClient(("127.0.0.1", disp.port), secret=secret)
    jc.register_dataset("j", range_dataset)
    assert sorted(int(b["x"][0]) for b in jc.stream("j")) == \
        list(range(12))


def test_no_threads_left(threads_at_start):
    assert not leftover(threads_at_start, settle=3.0), \
        leftover(threads_at_start)
