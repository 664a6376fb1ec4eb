"""The port's native control-plane library (horovod_tpu_torch/native/)
against the JAX package's (horovod_tpu/native/), on this host's CPU.

- The contract of tests/test_native.py, case for case, on the port's
  server, client, timeline writer and stall inspector (built with g++
  from the port's own sources into horovod_tpu_torch/_build/).
- The KV server's stop() with clients connected: the JAX package's
  `KVServer::Stop` joins its connection threads while it holds the lock
  each of them takes on its way out, so it can hang; the port's joins
  them after releasing it. 200 rounds, each with two idle clients and a
  third closing at the moment of the stop, in a spawned process under a
  deadline, each stop() within 5 s.
- The wire protocol both ways on loopback: the port's client against
  the JAX server (in a spawned process, ended with a kill: the JAX
  server's stop() can deadlock in a test worker) and the JAX client
  against the port's server.
- The fallback: a build that fails logs a warning and `available()`
  says False.

Every server, client and process a test starts is stopped in a fixture's
teardown; the last test checks that no thread of this module is left.
"""

import json
import multiprocessing as mp
import os
import threading
import time

import pytest

import torch_native_worker
from horovod_tpu_torch import native
from torch_threads import leftover, snapshot

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain on this host")


@pytest.fixture(scope="module", autouse=True)
def threads_at_start():
    return snapshot()


@pytest.fixture()
def kv():
    srv = native.NativeKVServer()
    yield srv
    srv.stop()


def test_kv_put_get_roundtrip(kv):
    c = native.NativeKVClient("127.0.0.1", kv.port)
    assert c.ping()
    c.put("a/b", b"hello world")
    assert c.get("a/b") == b"hello world"
    assert c.get("missing") is None
    c.delete("a/b")
    assert c.get("a/b") is None
    c.close()


def test_kv_add_atomic_across_clients(kv):
    def worker(n):
        c = native.NativeKVClient("127.0.0.1", kv.port)
        for _ in range(n):
            c.add("ctr", 1)
        c.close()

    threads = [threading.Thread(target=worker, args=(100,)) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    c = native.NativeKVClient("127.0.0.1", kv.port)
    assert c.add("ctr", 0) == 800
    c.close()


def test_kv_barrier(kv):
    results = []

    def worker(i):
        c = native.NativeKVClient("127.0.0.1", kv.port)
        results.append((i, c.barrier("round1", size=4, timeout=10.0)))
        c.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 4 and all(ok for _, ok in results)


@pytest.mark.parametrize("op", ["and", "or"])
def test_kv_bitvector_and_or_counted_get(kv, op):
    """Every rank contributes its bitvector, then reads the combination
    once all three contributed (the counted get), as the consistency
    check does."""
    vecs = [bytes([0b1110]), bytes([0b0111]), bytes([0b1101])]
    want = bytes([0b1110 & 0b0111 & 0b1101]) if op == "and" \
        else bytes([0b1110 | 0b0111 | 0b1101])
    results = [None] * 3

    def worker(i):
        c = native.NativeKVClient("127.0.0.1", kv.port)
        c.bitwise(f"cache_{op}", vecs[i], op=op)
        results[i] = c.get_when(f"cache_{op}", expected=3, timeout=10.0)
        c.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [want] * 3
    c = native.NativeKVClient("127.0.0.1", kv.port)
    # Not ready for a fourth contributor: the counted get times out.
    assert c.get_when(f"cache_{op}", expected=4, timeout=0.05) is None
    c.close()


def test_timeline_writes_valid_chrome_trace(tmp_path):
    path = str(tmp_path / "tl.json")
    tl = native.NativeTimeline(path)
    t0 = int(time.time() * 1e6)
    tl.emit("allreduce.grad0", "NEGOTIATE_ALLREDUCE", "B", t0)
    tl.emit("allreduce.grad0", "NEGOTIATE_ALLREDUCE", "E", t0 + 50)
    tl.emit("allreduce.grad0", "ALLREDUCE", "X", t0 + 60, dur_us=400)
    tl.emit('weird"name\\x', "CAT", "i", t0 + 500)
    tl.emit_counter("bytes", "allreduce", 12.5, t0 + 600)
    tl.close()
    events = json.load(open(path))
    assert len(events) == 5
    assert events[2]["ph"] == "X" and events[2]["dur"] == 400
    assert events[0]["name"] == "allreduce.grad0"
    assert events[3]["name"] == 'weird"name\\x'
    assert events[4]["ph"] == "C" and events[4]["args"] == {"allreduce": 12.5}


def test_stall_inspector_flags_old_submissions():
    si = native.NativeStallInspector(warn_sec=0.05, shutdown_sec=0.0)
    si.submit("tensor_a")
    si.submit("tensor_b")
    si.done("tensor_b")
    time.sleep(0.1)
    assert si.check() == (["tensor_a"], False)
    si.done("tensor_a")
    assert si.check() == ([], False)
    si.free()


def test_stall_inspector_shutdown_window_matches_python_fallback():
    """The native inspector and common/resilience.py's PyStallInspector
    (the fallback without a toolchain) give the same verdicts."""
    from horovod_tpu_torch.common.resilience import PyStallInspector
    both = [native.NativeStallInspector(warn_sec=0.01, shutdown_sec=0.05),
            PyStallInspector(warn_sec=0.01, shutdown_sec=0.05)]
    for si in both:
        si.submit("t")
    time.sleep(0.1)
    assert [si.check() for si in both] == [(["t"], True)] * 2
    for si in both:
        si.free()


def test_kv_get_larger_than_buffer_refetches(kv):
    c = native.NativeKVClient("127.0.0.1", kv.port)
    big = bytes(range(256)) * 1024  # 256 KiB
    c.put("big", big)
    assert c.get("big", maxlen=1024) == big
    c.bitwise("bigc", big, op="or")
    assert c.get_when("bigc", expected=1, timeout=5.0, maxlen=1024) == big
    c.close()


# ------------------------------------------------- stop() with clients on

@pytest.fixture()
def spawned():
    procs = []
    yield procs
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)


def test_kv_stop_never_deadlocks_with_clients_connected(spawned):
    ctx = mp.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    p = ctx.Process(target=torch_native_worker.stop_rounds, args=(200, send))
    spawned.append(p)
    p.start()
    assert recv.poll(120), "the 200 stop rounds did not finish in 120 s"
    worst = recv.recv()
    assert worst is not None, "a stop() took longer than 5 s"
    assert worst < 5.0
    p.join(10)
    assert p.exitcode == 0


# ------------------------------------------------ the protocol both ways

def _exercise(client_cls, port: int) -> None:
    """One client drives every op of the protocol; two more contribute
    to the AND/OR rounds."""
    c = client_cls("127.0.0.1", port)
    assert c.ping()
    c.put("p/k", b"\x00\x01value")
    assert c.get("p/k") == b"\x00\x01value"
    assert c.get("p/none") is None
    assert c.add("ctr", 5) == 5 and c.add("ctr", -2) == 3
    others = [client_cls("127.0.0.1", port) for _ in range(2)]
    for i, x in enumerate([c] + others):
        x.bitwise("and", bytes([0xF0 | i, 0x0F]), op="and")
        x.bitwise("or", bytes([1 << i, 0]), op="or")
    assert c.get_when("and", expected=3, timeout=5.0) == bytes([0xF0, 0x0F])
    assert c.get_when("or", expected=3, timeout=5.0) == bytes([0b111, 0])
    big = os.urandom(300_000)
    c.put("big", big)
    assert c.get("big", maxlen=1024) == big
    c.delete("p/k")
    assert c.get("p/k") is None
    for x in [c] + others:
        x.close()


def test_port_client_talks_to_jax_server(spawned):
    ctx = mp.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    p = ctx.Process(target=torch_native_worker.jax_server, args=(send,))
    spawned.append(p)
    p.start()
    assert recv.poll(60)
    _exercise(native.NativeKVClient, recv.recv())


def test_jax_client_talks_to_port_server(kv):
    jn = torch_native_worker.load("horovod_tpu")
    if not jn.available():
        pytest.skip("the JAX package's native library does not build here")
    _exercise(jn.NativeKVClient, kv.port)


# ------------------------------------------------------------ the fallback

def test_failed_build_warns_and_reports_the_python_path(monkeypatch,
                                                        tmp_path, caplog):
    assert native.active_path() == "native"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    import logging
    from horovod_tpu_torch.common.hvd_logging import get_logger
    get_logger().addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING):
            assert native.load() is None
    finally:
        get_logger().removeHandler(caplog.handler)
    assert not native.available() and native.active_path() == "python"
    assert "pure-Python fallbacks" in caplog.text
    with pytest.raises(RuntimeError):
        native.NativeKVServer()


def test_no_thread_left_behind(threads_at_start):
    assert not leftover(threads_at_start), leftover(threads_at_start)
