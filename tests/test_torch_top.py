"""hvdtop in the port (horovod_tpu_torch/observability/top.py) against
the JAX package's, on this host's CPU.

The same Prometheus page parses to the same document in both packages.
Then a live rendezvous server of the port, fed by the port's own
recorders (a perfscope summary, an hvdwatch record, a flight tail, a
trace tail and a pushed metrics snapshot, each through its KV push),
is read by both packages' `snapshot`: the snapshots and their renders
must be equal (the snapshot's clock aside). Tolerance: exact.
"""

import json

import pytest

from horovod_tpu.observability import top as jtop
from horovod_tpu_torch.common import hvd_logging
from horovod_tpu_torch.observability import flight as tflight
from horovod_tpu_torch.observability import metrics as tm
from horovod_tpu_torch.observability import top as ttop
from horovod_tpu_torch.observability import tracing as ttracing
from horovod_tpu_torch.observability import watch as twatch
from horovod_tpu_torch.profiler import perfscope as tp
from horovod_tpu_torch.runner.rendezvous import RendezvousServer

PAGE = (
    "# HELP horovod_mfu whatever\n"
    "# TYPE horovod_mfu gauge\n"
    'horovod_mfu{rank="0"} 0.25\n'
    'horovod_mfu{rank="1"} 0.5\n'
    'horovod_step_phase_seconds{phase="comms",rank="0"} 0.01\n'
    'horovod_label_escape{path="a\\"b\\\\c",rank="2"} 3e-05\n'
    "horovod_serve_queue_depth 7\n"
    "not a series line\n"
    "horovod_kv_requests_total 12\n")


def test_parse_metrics_text_and_rank_filter():
    doc = ttop.parse_metrics_text(PAGE)
    assert doc == jtop.parse_metrics_text(PAGE)
    assert ttop.series_by_rank(doc, "horovod_mfu") == {0: 0.25, 1: 0.5}
    assert ttop.series_by_rank(doc, "horovod_step_phase_seconds",
                               phase="comms") == {0: 0.01}
    assert doc["horovod_kv_requests_total"][0] == ({}, 12.0)
    assert doc["horovod_label_escape"][0][0]["path"] == 'a"b\\c'


def test_parse_of_the_port_registry_page():
    tm.reset_for_tests()
    try:
        reg = tm.registry()
        reg.gauge("horovod_mfu", "m").set(0.375)
        reg.histogram("horovod_step_seconds", "s",
                      buckets=tm.TIME_BUCKETS).observe(0.2)
        reg.counter("horovod_x_total", "x", labelnames=("op",)) \
            .labels(op="allreduce").inc(3)
        page = tm.render_snapshots([reg.snapshot(0), reg.snapshot(1)])
    finally:
        tm.reset_for_tests()
    doc = ttop.parse_metrics_text(page)
    assert doc == jtop.parse_metrics_text(page)
    for name in ("horovod_mfu", "horovod_x_total",
                 "horovod_step_seconds_count"):
        assert ttop.series_by_rank(doc, name) == \
            jtop.series_by_rank(doc, name)
    assert ttop.series_by_rank(doc, "horovod_mfu") == {0: 0.375, 1: 0.375}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture()
def live(monkeypatch):
    """A port rendezvous server holding what rank 0's recorders pushed."""
    for var in ("HOROVOD_SECRET_KEY", "HOROVOD_ELASTIC_ROUND",
                "HOROVOD_WATCH_DIR", "HOROVOD_FLIGHT_DIR"):
        monkeypatch.delenv(var, raising=False)
    srv = RendezvousServer()
    port = srv.start()
    monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_PORT", str(port))
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.setenv("HOROVOD_SIZE", "1")
    monkeypatch.setenv("HOROVOD_PERFSCOPE", "1")
    monkeypatch.setenv("HOROVOD_TRACE_SAMPLE", "1")
    monkeypatch.setenv("HOROVOD_WATCH_WARMUP", "5")
    for mod in (tm, tp, twatch, tflight, ttracing):
        mod.reset_for_tests()
    try:
        clock = _Clock()
        scope = tp.PerfScope(window=64, clock=clock)
        monkeypatch.setattr(tp, "_scope", scope)
        w = twatch.Watcher(clock=clock, dump_fn=lambda t: None,
                           capture_fn=lambda *a, **k: True)
        for i in range(16):
            with scope.step():
                with scope.phase("dispatch"):
                    clock.t += 0.15 if i < 10 else 0.6
            w.tick()
        assert scope.push_summary()
        assert w.push_record()
        tflight.record("kv", "PUT /perf/rank-0.r0")
        assert tflight.push_tail()
        with ttracing.get().start_span("serve.request", root=True):
            pass
        ttracing.push_tail()
        reg = tm.registry()
        reg.gauge("horovod_mfu", "m").set(0.31)
        srv.put("metrics", "rank-0", json.dumps(reg.snapshot(0)).encode())
        yield srv, port
    finally:
        srv.stop()
        # hvd_logging too: the watcher's anomaly log line made the
        # logger, whose handler holds this test's sys.stderr.
        for mod in (tm, tp, twatch, tflight, ttracing, hvd_logging):
            mod.reset_for_tests()


def test_snapshot_and_render_equal_to_the_jax_tool(live):
    srv, port = live
    snap_t = ttop.snapshot("127.0.0.1", port, max_ranks=4)
    snap_j = jtop.snapshot("127.0.0.1", port, max_ranks=4)
    snap_j["time"] = snap_t["time"]
    assert snap_t == snap_j
    row = snap_t["ranks"]["0"]
    assert row["steps"] == 16
    assert row["step_ms"]["mean"] == pytest.approx(
        (10 * 150 + 6 * 600) / 16)
    assert row["active_anomalies"] == ["step_time"]
    assert row["dominant_phase"] == "dispatch"
    assert snap_t["job"]["anomalies_total"] == 1
    assert "rank0:step_time" in snap_t["job"]["active_anomalies"]
    assert snap_t["errors"] == []
    text = ttop.render(snap_t)
    assert text == jtop.render(snap_j)
    assert "hvdtop" in text and "step_time!" in text


def test_cli_once_json_over_the_live_server(live, capsys):
    srv, port = live
    assert ttop.main(["--addr", f"127.0.0.1:{port}", "--once",
                      "--json"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["ranks"]["0"]["step_ms"]["mean"] > 0
    assert ttop.main(["--addr", f"127.0.0.1:{port}", "--once"]) == 0
    assert "hvdtop" in capsys.readouterr().out


def test_cli_requires_addr(monkeypatch):
    for var in ("HOROVOD_GLOO_RENDEZVOUS_ADDR",
                "HOROVOD_GLOO_RENDEZVOUS_PORT",
                "HOROVOD_RENDEZVOUS_PORT_FILE"):
        monkeypatch.delenv(var, raising=False)
    assert ttop.main(["--addr", ""]) == 2
    assert ttop.main(["--addr", "nonsense"]) == 2


def test_default_addr_from_port_file(monkeypatch, tmp_path):
    for var in ("HOROVOD_GLOO_RENDEZVOUS_ADDR",
                "HOROVOD_GLOO_RENDEZVOUS_PORT"):
        monkeypatch.delenv(var, raising=False)
    f = tmp_path / "rdv.port"
    f.write_text("127.0.0.1:4242,127.0.0.1:4343\n")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_PORT_FILE", str(f))
    assert ttop._default_addr() == jtop._default_addr() == \
        "127.0.0.1:4242,127.0.0.1:4343"
