"""The port's flight recorder (horovod_tpu_torch/observability/flight.py)
against the JAX package's, on this host's CPU.

The same events go into both recorders: their dumps must agree in every
field but the wall-clock times, the pid, the host and the thread stacks
(the same keys, the same events in the same order, the same per-group
call indices and rounds), and each package's dump must read as the
other's. Then the contract of tests/test_flight.py on the port (the
ring's wrap and drop count, the per-group indices across elastic
rounds, the no-op shell under HOROVOD_FLIGHT=0, the atomic rank-keyed
dump, the KV tail push and its launcher-side persistence, SIGUSR1),
and the dumps the port's failure paths write: a collective's dispatch
record and the stall watchdog's dump. Tolerance: exact. hvddoctor's
cases belong to ROADMAP A13 part 2.
"""

import json
import os
import signal

import pytest

from horovod_tpu.observability import flight as jflight
from horovod_tpu_torch.observability import flight as tflight
from torch_threads import leftover, snapshot

@pytest.fixture(scope="module", autouse=True)
def threads_at_start():
    return snapshot()


_VOLATILE = {"wall_time", "pid", "host", "stacks"}


@pytest.fixture()
def fresh(monkeypatch):
    for var in (tflight.FLIGHT_ENV, tflight.FLIGHT_DIR_ENV,
                tflight.FLIGHT_CAPACITY_ENV, tflight.FLIGHT_KV_TAIL_ENV,
                "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_ELASTIC_ROUND",
                "HOROVOD_GLOO_RENDEZVOUS_ADDR",
                "HOROVOD_GLOO_RENDEZVOUS_PORT"):
        monkeypatch.delenv(var, raising=False)
    jflight.reset_for_tests()
    tflight.reset_for_tests()
    yield monkeypatch
    jflight.reset_for_tests()
    tflight.reset_for_tests()


def _events(f):
    """One script of generic and collective events, an elastic round
    change included."""
    f.record("kv", "PUT /scope/key (3B)")
    f.record_collective(0, "allreduce(shape=(2, 4),dtype=float32,op=1,"
                        "ps=0)", "grad")
    f.record_collective(3, "barrier(ps=3)", "")
    f.record_collective(0, "broadcast(shape=(2, 1),dtype=int64,root=0,"
                        "ps=0)", "bcast")
    f.record("stall", "collective 'grad' stalled for 61.0s")
    f.set_round(2, 0)
    f.record_collective(0, "allreduce(shape=(2, 4),dtype=float32,op=1,"
                        "ps=0)", "grad")


def _normal(body):
    body = {k: v for k, v in body.items() if k not in _VOLATILE}
    body["events"] = [[x for i, x in enumerate(e) if i != 1]
                      for e in body["events"]]  # drop the wall time
    return body


@pytest.mark.parametrize("capacity", [16, 4096])
def test_dump_format_matches_jax(fresh, tmp_path, capacity):
    fresh.setenv(tflight.FLIGHT_CAPACITY_ENV, str(capacity))
    fresh.setenv("HOROVOD_RANK", "1")
    fresh.setenv("HOROVOD_SIZE", "2")
    bodies = {}
    for name, mod in (("jax", jflight), ("port", tflight)):
        d = tmp_path / name
        fresh.setenv(mod.FLIGHT_DIR_ENV, str(d))
        rec = mod.get()
        _events(rec)
        for i in range(20):
            rec.record("resilience", f"retry {i}")
        path = rec.dump("stall_watchdog", push_kv=False)
        assert os.path.basename(path) == "1.r2.json"
        bodies[name] = json.load(open(path))
    assert set(bodies["port"]) == set(bodies["jax"])
    assert _normal(bodies["port"]) == _normal(bodies["jax"])
    assert tflight.DUMP_VERSION == jflight.DUMP_VERSION
    assert bodies["port"]["rounds"] == {"2": 1}
    # the compact KV tail is the same payload, bounded
    tails = {n: m.get().payload("tick", tail=5, stacks=False)
             for n, m in (("jax", jflight), ("port", tflight))}
    assert _normal(tails["port"]) == _normal(tails["jax"])
    assert len(tails["port"]["events"]) == 5


def test_ring_wraps_and_counts_drops(fresh):
    fresh.setenv(tflight.FLIGHT_CAPACITY_ENV, "16")
    rec = tflight.get()
    for i in range(40):
        rec.record("kv", f"ev{i}")
    assert [e[0] for e in rec.snapshot()] == list(range(24, 40))
    assert rec.stats() == {"recorded": 40, "dropped": 24,
                           "collective_calls": 0}
    assert [e[3] for e in rec.snapshot(tail=3)] == ["ev37", "ev38", "ev39"]


def test_disabled_recorder_is_noop_shell(fresh):
    fresh.setenv(tflight.FLIGHT_ENV, "0")
    tflight.reset_for_tests()
    rec = tflight.get()
    tflight.record("kv", "x")
    tflight.record_collective(0, "y", "")
    assert rec.snapshot() == []
    assert tflight.dump("manual") is None
    assert tflight.dump_hint() == ""
    assert not tflight.push_tail()


class FakeKV:
    def __init__(self, fail=False):
        self.puts, self.fail = {}, fail

    def put(self, scope, key, value):
        if self.fail:
            raise ConnectionError("down")
        self.puts[(scope, key)] = value


def test_push_tail_is_rank_keyed_bounded_and_self_suppressing(fresh):
    fresh.setenv("HOROVOD_RANK", "2")
    fresh.setenv(tflight.FLIGHT_KV_TAIL_ENV, "4")
    tflight.reset_for_tests()
    rec = tflight.get()
    kv = FakeKV()
    rec._kv = kv
    for i in range(10):
        rec.record("kv", f"ev{i}")
    assert rec.push_tail("tick")
    body = json.loads(kv.puts[("flight", "rank-2.r0")])
    assert [e[3] for e in body["events"]] == [f"ev{i}" for i in range(6, 10)]
    # the push records nothing of its own (no kv event for the put)
    assert rec.stats()["recorded"] == 10
    rec._kv = FakeKV(fail=True)
    assert not rec.push_tail("tick")  # a failure is swallowed


def test_persist_kv_tails_from_rendezvous_server(fresh, tmp_path):
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    srv = RendezvousServer()
    srv.start()
    try:
        srv.put("flight", "rank-0.r0", b'{"rank": 0}')
        srv.put("flight", "rank-1.r0", b'{"rank": 1}')
        out = tmp_path / "flight"
        written = tflight.persist_kv_tails(srv, str(out))
        assert sorted(os.path.basename(p) for p in written) == [
            "kv-tail-rank-0.r0.json", "kv-tail-rank-1.r0.json"]
        assert json.load(open(out / "kv-tail-rank-1.r0.json")) == {"rank": 1}
        assert tflight.persist_kv_tails(srv, "") == []
    finally:
        srv.stop()


def test_sigusr1_triggers_dump(fresh, tmp_path):
    fresh.setenv(tflight.FLIGHT_DIR_ENV, str(tmp_path))
    fresh.setenv("HOROVOD_RANK", "5")
    rec = tflight.get()
    rec.record("kv", "poke me")
    prev = signal.getsignal(signal.SIGUSR1)
    try:
        tflight._sigusr1_installed = False
        tflight._install_process_hooks()
        os.kill(os.getpid(), signal.SIGUSR1)
        body = json.load(open(tmp_path / "5.json"))
        assert body["trigger"] == "sigusr1"
        assert body["events"][-1][3] == "poke me"
    finally:
        signal.signal(signal.SIGUSR1, prev)
        tflight._sigusr1_installed = False


def test_collective_dispatch_lands_in_the_ring(fresh, tmp_path):
    """Every eager collective passes the dispatch choke point: one
    record with the JAX package's descriptor, per-group indices."""
    import torch
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        hvd.allreduce(torch.ones(2, 4), name="grad")
        hvd.barrier()
    finally:
        hvd.shutdown()
    evs = [e for e in tflight.get().snapshot() if e[2] == "collective"]
    assert [(e[3], e[4], e[5], e[6]) for e in evs] == [
        ("allreduce(shape=(1, 2, 4),dtype=float32,op=0,ps=0)", "grad",
         0, 0),
        ("barrier(ps=0)", "", 0, 1)]


def test_no_thread_left_behind(threads_at_start):
    assert not leftover(threads_at_start), leftover(threads_at_start)
