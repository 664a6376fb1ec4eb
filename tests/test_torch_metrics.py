"""The port's metrics registry, its export paths and `GET /metrics`
(horovod_tpu_torch/observability/metrics.py, export.py,
runner/rendezvous.py) against the JAX package's, on this host's CPU.

The same script of counter, gauge and histogram operations runs on both
registries: their snapshots must be equal (all but the wall-clock
`time`) and their Prometheus text equal byte for byte, a rank label per
series where ranks merge. Then the contract of tests/test_metrics.py on
the port: the no-op shell under HOROVOD_METRICS=0, the label cap,
parse_snapshot and the staleness cutoff, the exporter's sinks, the
collectives' and the hook path's counters in a world of one (gloo), the
rendezvous server's `/metrics` route with ranks aged out and garbage
pushed, and the retry and breaker counters. Tolerance: exact.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu.observability import metrics as jm
from horovod_tpu_torch.observability import metrics as tm
from torch_threads import leftover, snapshot


@pytest.fixture(scope="module", autouse=True)
def threads_at_start():
    return snapshot()


@pytest.fixture(autouse=True)
def fresh_registries(monkeypatch):
    monkeypatch.delenv("HOROVOD_METRICS", raising=False)
    jm.reset_for_tests()
    tm.reset_for_tests()
    yield
    jm.reset_for_tests()
    tm.reset_for_tests()


def _script(m, rank_seed: int):
    """One registry's worth of every family kind, labels, the label cap
    and all three bucket ladders; values drawn from a seed."""
    rng = np.random.default_rng(rank_seed)
    reg = m.MetricsRegistry(enabled=True, label_max=4)
    calls = reg.counter("horovod_collective_calls_total", "Eager calls",
                        labelnames=("op", "dtype"))
    for op in ("allreduce", "allgather", "broadcast"):
        calls.labels(op=op, dtype="float32").inc(int(rng.integers(1, 9)))
    reg.counter("plain_total", "no labels").inc(float(rng.random()))
    g = reg.gauge("horovod_overlap_fraction", "a gauge")
    g.set(float(rng.random()))
    g.dec(0.125)
    capped = reg.counter("capped_total", "label cap", labelnames=("k",))
    for i in range(7):  # beyond label_max: folds into "other"
        capped.labels(k=f"v{i}").inc(i)
    for name, buckets in (("t_seconds", m.TIME_BUCKETS),
                          ("s_bytes", m.SIZE_BUCKETS),
                          ("c_tensors", m.COUNT_BUCKETS)):
        h = reg.histogram(name, f"{name} help", labelnames=("op",),
                          buckets=buckets)
        for v in rng.exponential(scale=buckets[len(buckets) // 2],
                                 size=11):
            h.labels(op="allreduce").observe(float(v))
    return reg


def _strip_time(snap):
    return {k: v for k, v in snap.items() if k != "time"}


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_snapshot_and_prometheus_text_match_jax(seed):
    snaps = {}
    for name, m in (("jax", jm), ("port", tm)):
        reg = _script(m, seed)
        snaps[name] = [reg.snapshot(rank=r) for r in (0, 1)]
    for j, t in zip(snaps["jax"], snaps["port"]):
        assert _strip_time(j) == _strip_time(t)
    text_j = jm.render_snapshots(snaps["jax"])
    text_t = tm.render_snapshots(snaps["port"])
    assert text_t == text_j
    assert 'rank="1"' in text_t and 'k="other"' in text_t
    # each package renders the other's snapshots identically
    assert tm.render_snapshots(snaps["jax"]) == text_j


def test_bucket_ladders_and_staleness_constants_match_jax():
    assert tm.TIME_BUCKETS == jm.TIME_BUCKETS
    assert tm.SIZE_BUCKETS == jm.SIZE_BUCKETS
    assert tm.COUNT_BUCKETS == jm.COUNT_BUCKETS
    assert tm.STALE_PUSH_INTERVALS == jm.STALE_PUSH_INTERVALS


def test_disabled_registry_is_noop_shell(monkeypatch):
    monkeypatch.setenv("HOROVOD_METRICS", "0")
    tm.reset_for_tests()
    reg = tm.registry()
    assert not reg.enabled and not tm.enabled()
    c = reg.counter("x_total", labelnames=("a",))
    assert c is tm.NOOP and c.labels(a="1") is tm.NOOP
    c.inc(3)
    reg.histogram("h").observe(1.0)
    assert reg.snapshot(0)["families"] == {}


def test_parse_snapshot_and_fresh_snapshots_match_jax(monkeypatch):
    for raw in (b"\xde\xad", b"[1,2]", b"not json", b'{"rank": 2}'):
        assert tm.parse_snapshot(raw) == jm.parse_snapshot(raw)
    snaps = [{"rank": 0, "time": 100.0}, {"rank": 1, "time": 10.0},
             {"rank": 2}]
    for stale in (30.0, 0.0, 200.0):
        assert tm.fresh_snapshots(snaps, stale, now=120.0) == \
            jm.fresh_snapshots(snaps, stale, now=120.0)
    for env in ({}, {"HOROVOD_METRICS_PUSH_INTERVAL": "2"},
                {"HOROVOD_METRICS_STALE_SECONDS": "7"}):
        for k in ("HOROVOD_METRICS_PUSH_INTERVAL",
                  "HOROVOD_METRICS_STALE_SECONDS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tm.stale_cutoff_seconds() == jm.stale_cutoff_seconds()


def test_thread_hammer_counter_and_histogram():
    reg = tm.MetricsRegistry(enabled=True)
    c = reg.counter("hammer_total")
    h = reg.histogram("hammer_seconds", buckets=tm.TIME_BUCKETS)

    def work():
        for _ in range(2000):
            c.inc()
            h.observe(0.001)

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    fams = reg.snapshot()["families"]
    assert fams["hammer_total"]["series"][0]["value"] == 16000
    assert fams["hammer_seconds"]["series"][0]["count"] == 16000


# ----------------------------------------------------------- the exporter

def _cfg(**kw):
    from horovod_tpu_torch.common.config import Config
    cfg = Config()
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def test_exporter_sinks_dump_push_and_counter_tracks(tmp_path):
    from horovod_tpu_torch.observability.export import MetricsExporter
    tm.registry().counter("tracked_total", labelnames=("op",)).labels(
        op="x").inc(5)
    pushed, emitted = {}, []

    class FakeKV:
        def put(self, scope, key, value):
            pushed[(scope, key)] = value

    class FakeTL:
        def counter(self, name, values):
            emitted.append((name, values))

    cfg = _cfg(metrics_dump=str(tmp_path / "m-{rank}.json"),
               metrics_dump_interval=0.1, metrics_push_interval=0.1)
    exp = MetricsExporter(cfg, rank_fn=lambda: 3, timeline_fn=FakeTL,
                          kv_factory=FakeKV)
    exp.tick(force=True)
    snap = json.loads((tmp_path / "m-3.json").read_text())
    assert snap["rank"] == 3
    assert snap["families"]["tracked_total"]["series"][0]["value"] == 5
    assert "tracked_total" in json.loads(pushed[("metrics", "rank-3")])[
        "families"]
    assert ("tracked_total", {"x": 5.0}) in emitted
    # no rank (mid-reset): nothing pushed under an unkeyable name
    pushed.clear()
    MetricsExporter(cfg, rank_fn=lambda: None, timeline_fn=lambda: None,
                    kv_factory=FakeKV).tick(force=True)
    assert not any(k[0] == "metrics" for k in pushed)


def test_exporter_thread_starts_and_stops_with_init(tmp_path, monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.observability import export
    monkeypatch.setenv("HOROVOD_METRICS_DUMP", str(tmp_path / "d.json"))
    monkeypatch.setenv("HOROVOD_METRICS_DUMP_INTERVAL", "0.1")
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        assert export._exporter is not None
        hvd.allreduce(torch.ones(4))
    finally:
        hvd.shutdown()
    assert export._exporter is None
    snap = json.loads((tmp_path / "d.json").read_text())
    assert "horovod_collective_calls_total" in snap["families"]


# ------------------------------------- the collectives' and hook counters

def _series(name):
    fam = tm.registry().snapshot()["families"].get(name, {"series": []})
    return {tuple(s["labels"]): s.get("value", s.get("count"))
            for s in fam["series"]}


@pytest.fixture()
def world(tmp_path):
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    yield hvd
    hvd.shutdown()


def test_collectives_record_calls_bytes_and_seconds(world):
    hvd = world
    hvd.allreduce(torch.ones(16), op=hvd.Sum)
    hvd.allreduce(torch.ones(16), op=hvd.Sum)
    hvd.grouped_allreduce([torch.ones(4), torch.ones(2, 2,
                                                     dtype=torch.float64)])
    hvd.allgather(torch.ones(3, 2, dtype=torch.int32))
    hvd.broadcast(torch.ones(5), root_rank=0)
    calls = _series("horovod_collective_calls_total")
    nbytes = _series("horovod_collective_bytes_total")
    assert calls[("allreduce", "float32")] == 3
    assert nbytes[("allreduce", "float32")] == 2 * 64 + 16 + 32
    assert calls[("allgather", "int32")] == 1
    assert nbytes[("allgather", "int32")] == 24
    assert calls[("broadcast", "float32")] == 1
    assert _series("horovod_collective_seconds")[("allreduce",)] == 3
    assert _series("horovod_grouped_fusion_tensors")[("allreduce",)] == 1
    text = hvd.metrics_text()
    assert 'horovod_collective_calls_total{op="allreduce",dtype="float32"' \
        ',rank="0"} 3' in text
    assert hvd.metrics()["rank"] == 0


def test_hook_path_counts_one_call_per_bucket(world, monkeypatch):
    hvd = world
    monkeypatch.setattr(hvd.core.topology.config(), "fusion_threshold_bytes",
                        64)
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.Linear(4, 2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    steps = 3
    for _ in range(steps):
        opt.zero_grad()
        model(torch.randn(2, 8)).sum().backward()
        opt.step()
    n = len(opt.plan)
    assert n > 1
    assert _series("horovod_collective_calls_total")[
        ("allreduce", "float32")] == steps * n
    assert _series("horovod_collective_bytes_total")[
        ("allreduce", "float32")] == steps * opt.plan_bytes
    assert _series("horovod_bucket_dispatch_total")[()] == steps * n
    assert hvd.bucket_overlap_stats()[0] >= steps * n


def test_disabled_mode_records_no_collective_metrics(tmp_path, monkeypatch):
    import horovod_tpu_torch as hvd
    monkeypatch.setenv("HOROVOD_METRICS", "0")
    tm.reset_for_tests()
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        hvd.allreduce(torch.ones(4))
        assert hvd.metrics()["families"] == {}
    finally:
        hvd.shutdown()


# ------------------------------------------------------- GET /metrics

def _scrape(port):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=10).read().decode()


@pytest.fixture()
def server():
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    srv = RendezvousServer()
    srv.start()
    yield srv
    srv.stop()


def test_rendezvous_metrics_route_merges_ranks(server):
    from horovod_tpu_torch.runner.rendezvous import KVClient
    kv = KVClient("127.0.0.1", server.port, secret=None)
    kv.put("scope", "key", b"v")
    for r in (0, 1):
        worker = tm.MetricsRegistry(enabled=True)
        worker.counter("horovod_collective_calls_total", "",
                       ("op", "dtype")).labels(
                           op="allreduce", dtype="float32").inc(9 + r)
        kv.put("metrics", f"rank-{r}",
               json.dumps(worker.snapshot(rank=r)).encode())
    text = _scrape(server.port)
    assert 'horovod_kv_requests_total{method="PUT"}' in text
    assert "horovod_kv_request_seconds_bucket" in text
    for r in (0, 1):
        assert ('horovod_collective_calls_total{op="allreduce",'
                f'dtype="float32",rank="{r}"}} {9 + r}') in text
    assert 'horovod_retry_attempts_total{policy="kv"}' in text
    assert "horovod_metrics_scrapes_total 1" in text


def test_metrics_route_ages_out_dead_ranks_and_survives_garbage(
        server, monkeypatch):
    import time
    from horovod_tpu_torch.runner.rendezvous import KVClient
    monkeypatch.setenv("HOROVOD_METRICS_STALE_SECONDS", "30")
    kv = KVClient("127.0.0.1", server.port, secret=None)
    worker = tm.MetricsRegistry(enabled=True)
    worker.counter("horovod_x_total").inc(5)
    live = worker.snapshot(rank=0)
    live["time"] = time.time() - 1000.0  # a skewed worker clock
    kv.put("metrics", "rank-0", json.dumps(live).encode())
    kv.put("metrics", "rank-1", json.dumps(worker.snapshot(rank=1)).encode())
    kv.put("metrics", "rank-2", b"\xde\xad not json")
    with server._handler.lock:
        server._handler.put_times["metrics/rank-1"] = time.time() - 1000.0
    text = _scrape(server.port)
    assert 'horovod_x_total{rank="0"} 5' in text
    assert 'rank="1"' not in text


def test_jax_scraper_reads_the_port_route(server):
    """The route's text parses as the JAX package's launcher would serve
    it: the same families for the same pushed snapshot."""
    from horovod_tpu.runner.rendezvous import RendezvousServer as JServer
    worker = tm.MetricsRegistry(enabled=True)
    worker.counter("horovod_y_total").inc(2)
    body = json.dumps(worker.snapshot(rank=4)).encode()
    jsrv = JServer()
    jsrv.start()
    try:
        for s in (server, jsrv):
            s.put("metrics", "rank-4", body)
        pick = [ln for ln in _scrape(server.port).splitlines()
                if "horovod_y_total" in ln]
        jpick = [ln for ln in _scrape(jsrv.port).splitlines()
                 if "horovod_y_total" in ln]
        assert pick == jpick and 'horovod_y_total{rank="4"} 2' in pick
    finally:
        jsrv.stop()


# ------------------------------------------------------------ resilience

def test_retry_and_breaker_metrics_match_jax():
    from horovod_tpu.common import resilience as jres
    from horovod_tpu_torch.common import resilience as tres
    from horovod_tpu_torch.common.exceptions import (CircuitOpenError,
                                                     RetryError)
    from horovod_tpu.common.exceptions import (
        CircuitOpenError as JCircuitOpenError, RetryError as JRetryError)
    out = {}
    for name, res, m, retry_err, open_err in (
            ("jax", jres, jm, JRetryError, JCircuitOpenError),
            ("port", tres, tm, RetryError, CircuitOpenError)):
        pol = res.RetryPolicy(max_attempts=3, base_delay=0.001,
                              max_delay=0.001, deadline=None,
                              retryable=lambda e: True, name="testpol")
        with pytest.raises(retry_err):
            pol.call(lambda: (_ for _ in ()).throw(ConnectionError("x")))
        clock = [0.0]
        br = res.CircuitBreaker(failure_threshold=2, recovery_timeout=10.0,
                                clock=lambda: clock[0])
        for _ in range(2):
            with pytest.raises(ValueError):
                br.call(lambda: (_ for _ in ()).throw(ValueError("y")))
        with pytest.raises(open_err):
            br.call(lambda: 1)
        clock[0] = 11.0
        assert br.call(lambda: 42) == 42
        fams = m.registry().snapshot()["families"]
        out[name] = {k: fams[k]["series"] for k in (
            "horovod_retry_attempts_total", "horovod_retry_exhausted_total",
            "horovod_circuit_transitions_total")}
    assert out["port"] == out["jax"]
    retries = {tuple(s["labels"]): s["value"]
               for s in out["port"]["horovod_retry_attempts_total"]}
    assert retries[("testpol",)] == 2


def test_no_thread_left_behind(threads_at_start):
    assert not leftover(threads_at_start), leftover(threads_at_start)
