"""hvddoctor in the port (horovod_tpu_torch/observability/doctor.py)
against the JAX package's, on this host's CPU.

One set of records written by the port's own recorders (two ranks'
flight dumps with a straggler, their perfscope summaries, an hvdwatch
record and trace fragments) is loaded and merged by both packages'
doctors: the JSON reports must be equal and `render` must give the
same text. Then the contract cases of tests/test_flight.py (the
straggler, the first divergence, missing ranks, KV-tail-only ranks, the
per-round attribution, --json and --trace, --kv), of
tests/test_tracing.py (the [traces] join, the Perfetto export) and the
[serve] sections of tests/test_serve.py, each run through both CLIs
with equal output, and the port's own assertions on it. `--rounds`
(the perfboard trajectory) exits 2 in the port. Tolerance: exact.
"""

import json
import os

import pytest

from horovod_tpu.observability import doctor as jdoc
from horovod_tpu_torch.common import hvd_logging
from horovod_tpu_torch.observability import doctor as tdoc
from horovod_tpu_torch.observability import flight as tflight
from horovod_tpu_torch.observability import tracing as ttracing
from horovod_tpu_torch.observability import watch as twatch
from horovod_tpu_torch.profiler import perfscope as tp
from horovod_tpu_torch.runner.rendezvous import RendezvousServer


def both(capsys, argv):
    """Run both CLIs on `argv`; their exit codes and stdout must agree.
    Returns the port's (rc, stdout, stderr)."""
    rc_j = jdoc.main(list(argv))
    cap_j = capsys.readouterr()
    rc_t = tdoc.main(list(argv))
    cap_t = capsys.readouterr()
    assert rc_t == rc_j
    assert cap_t.out == cap_j.out
    return rc_t, cap_t.out, cap_t.err


# ------------------------------------------ records from the port itself

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture()
def port_records(tmp_path, monkeypatch):
    """Two ranks' records, each written by the port's recorders."""
    for var in ("HOROVOD_ELASTIC_ROUND", "HOROVOD_WATCH_DIR",
                "HOROVOD_GLOO_RENDEZVOUS_ADDR",
                "HOROVOD_GLOO_RENDEZVOUS_PORT"):
        monkeypatch.delenv(var, raising=False)
    d = str(tmp_path)
    monkeypatch.setenv("HOROVOD_FLIGHT_DIR", d)
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.setenv("HOROVOD_PERFSCOPE", "1")
    monkeypatch.setenv("HOROVOD_TRACE_SAMPLE", "1")
    monkeypatch.setenv("HOROVOD_WATCH_WARMUP", "5")
    desc = "allreduce(shape=(2, 4),dtype=float32,op=1,ps=0)"
    try:
        for rank, calls, slow in ((0, 9, 0.0), (1, 5, 0.45)):
            for mod in (tflight, ttracing, tp, twatch):
                mod.reset_for_tests()
            monkeypatch.setenv("HOROVOD_RANK", str(rank))
            monkeypatch.setenv("HOROVOD_HOSTNAME", f"h{rank}")
            rec = tflight.FlightRecorder()
            for i in range(calls):
                rec.record_collective(0, desc, f"grad.{i}")
            rec.record("kv", "PUT /perf/rank")
            assert rec.dump("stall_watchdog" if rank else "atexit",
                            push_kv=False)
            clock = _Clock()
            scope = tp.PerfScope(window=64, clock=clock)
            w = twatch.Watcher(clock=clock, dump_fn=lambda t: None,
                               capture_fn=lambda *a, **k: True)
            monkeypatch.setattr(tp, "_scope", scope)
            for i in range(16):
                with scope.step():
                    with scope.phase("input_wait"):
                        clock.t += slow if i >= 10 else 0.01
                    with scope.phase("dispatch"):
                        clock.t += 0.1
                    with scope.phase("comms"):
                        clock.t += 0.02
                w.tick()
            with open(os.path.join(d, f"perf-rank-{rank}.r0.json"),
                      "w") as f:
                json.dump(scope.kv_payload(), f)
            body = w.kv_payload()
            if body is not None:
                with open(os.path.join(d, f"watch-rank-{rank}.r0.json"),
                          "w") as f:
                    json.dump(body, f)
            tr = ttracing.get()
            with tr.start_span("serve.request", root=True,
                               attrs={"rid": rank}):
                with tr.start_span("serve.queue"):
                    pass
            assert ttracing.dump("atexit", push_kv=False)
    finally:
        # hvd_logging too: the watcher's anomaly log line made the
        # logger, whose handler holds this test's sys.stderr.
        for mod in (tflight, ttracing, tp, twatch, hvd_logging):
            mod.reset_for_tests()
    return d


def _load(doc, d):
    return (doc.dedupe(doc.load_dir(d)), doc.load_perf_dir(d),
            doc.load_watch_dir(d), doc.load_trace_dir(d))


def test_port_records_merge_equal_in_both_doctors(port_records):
    d = port_records
    dumps_t, perf_t, watch_t, traces_t = _load(tdoc, d)
    dumps_j, perf_j, watch_j, traces_j = _load(jdoc, d)
    assert len(dumps_t) == 2 and len(perf_t) == 2 and len(traces_t) == 2
    assert len(watch_t) == 1  # only rank 1's input stalled
    rep_t = tdoc.merge(dumps_t, perf=perf_t, watch=watch_t,
                       traces=traces_t)
    rep_j = jdoc.merge(dumps_j, perf=perf_j, watch=watch_j,
                       traces=traces_j)
    assert json.loads(json.dumps(rep_t)) == json.loads(json.dumps(rep_j))
    assert tdoc.render(rep_t) == jdoc.render(rep_j)
    world = rep_t["groups"][tdoc.group_key(0, tdoc.WORLD_GROUP)]
    assert world["stragglers"] == [1]
    assert world["last_agreed"]["call"] == 4
    assert rep_t["perf"]["stragglers"][0]["rank"] == 1
    assert rep_t["perf"]["stragglers"][0]["dominant_phase"] == "input_wait"
    an = rep_t["anomalies"]
    assert an["detectors"] == {"input_wait": 1, "step_time": 1}
    assert rep_t["traces"]["requests"] == 2


def test_port_records_cli_text_json_and_trace(port_records, capsys,
                                              tmp_path):
    d = port_records
    rc, out, _ = both(capsys, ["--dir", d])
    assert rc == 0
    assert "STRAGGLER rank 1" in out and "[anomalies]" in out
    assert "[perf]" in out and "[traces]" in out
    rc, out, _ = both(capsys, ["--dir", d, "--json"])
    assert json.loads(out)["ranks_dumped"] == [0, 1]
    for name, doc in (("t", tdoc), ("j", jdoc)):
        assert doc.main(["--dir", d, "--trace",
                         str(tmp_path / f"{name}.trace")]) == 0
    capsys.readouterr()
    assert json.load(open(tmp_path / "t.trace")) == \
        json.load(open(tmp_path / "j.trace"))


def test_rounds_waits_for_the_port_benchmark(tmp_path, capsys):
    assert tdoc.main(["--dir", str(tmp_path), "--rounds",
                      str(tmp_path)]) == 2
    err = capsys.readouterr().err
    assert "ROADMAP A13" in err and "benchmark" in err


# ------------------------------------------------- tests/test_flight.py

def _mk_dump(d, rank, size, calls, trigger="atexit", extra_events=(),
             name_fn=lambda i: f"t{i}", desc_fn=None, tail_name=None,
             round_id=0, host=None, pid=None):
    """Write a synthetic dump for `rank` with `calls` world collectives."""
    desc_fn = desc_fn or (
        lambda i: f"allreduce(shape=({size}, 4),dtype=float32,op=2,ps=0)")
    t0 = 1_700_000_000.0
    events = []
    seq = 0
    for i in range(calls):
        events.append([seq, t0 + 0.1 * i, "collective", desc_fn(i),
                       name_fn(i), 0, i, round_id])
        seq += 1
    for kind, desc in extra_events:
        events.append([seq, t0 + 0.1 * seq, kind, desc])
        seq += 1
    body = {"version": tflight.DUMP_VERSION, "rank": rank, "size": size,
            "elastic_round": str(round_id) if round_id else "",
            "hostname": host or f"h{rank}",
            "pid": pid if pid is not None else 1000 + rank,
            "trigger": trigger, "wall_time": t0 + 99,
            "round": round_id, "rounds": {str(round_id): rank},
            "recorded": seq, "dropped": 0,
            "collective_calls": calls, "events": events,
            "stacks": {"MainThread-1": ["  File \"train.py\", line 10"]}}
    with open(os.path.join(d, tail_name or f"{rank}.json"), "w") as f:
        json.dump(body, f)
    return body


def test_doctor_names_straggler_and_last_agreed(tmp_path, capsys):
    d = str(tmp_path)
    _mk_dump(d, 0, 2, calls=12, trigger="stall_watchdog")
    _mk_dump(d, 1, 2, calls=7, trigger="atexit")
    rc, out, _ = both(capsys, ["--dir", d])
    assert rc == 0
    assert "STRAGGLER rank 1" in out
    assert "5 call(s) behind" in out
    assert "last collective all ranks agreed on: call #6" in out
    assert "name=t6" in out


def test_doctor_names_first_divergence_clusters(tmp_path, capsys):
    d = str(tmp_path)
    _mk_dump(d, 0, 2, calls=8)
    _mk_dump(d, 1, 2, calls=8, desc_fn=lambda i: (
        "broadcast(shape=(2, 4),dtype=float32,root=0,ps=0)" if i == 5
        else "allreduce(shape=(2, 4),dtype=float32,op=2,ps=0)"))
    rc, out, _ = both(capsys, ["--dir", d])
    assert "FIRST DIVERGENCE at call #5" in out
    assert "rank(s) [0] issued allreduce" in out
    assert "rank(s) [1] issued broadcast" in out
    assert "last collective all ranks agreed on: call #4" in out


def test_doctor_reports_missing_ranks(tmp_path, capsys):
    d = str(tmp_path)
    _mk_dump(d, 0, 3, calls=4)
    _mk_dump(d, 1, 3, calls=4)
    rc, out, _ = both(capsys, ["--dir", d])
    assert "MISSING ranks" in out and "[2]" in out


def test_doctor_merges_kv_tail_only_rank(tmp_path, capsys):
    d = str(tmp_path)
    _mk_dump(d, 0, 2, calls=9, trigger="stall_watchdog")
    _mk_dump(d, 1, 2, calls=5, trigger="tick",
             tail_name="kv-tail-rank-1.json")
    rc, out, _ = both(capsys, ["--dir", d])
    assert "1 KV-tail-only" in out
    assert "rank 1 (KV tail" in out
    assert "STRAGGLER rank 1" in out


def test_doctor_prefers_full_dump_over_same_process_tail(tmp_path):
    d = str(tmp_path)
    _mk_dump(d, 0, 2, calls=9)
    _mk_dump(d, 0, 2, calls=3, tail_name="kv-tail-rank-0.json")
    dumps = tdoc.dedupe(tdoc.load_dir(d))
    assert len(dumps) == 1 == len(jdoc.dedupe(jdoc.load_dir(d)))
    assert not dumps[0].tail_only
    assert len(dumps[0].collectives()[(0, 0)]) == 9


def test_doctor_attributes_multi_round_dump_to_per_round_ranks(tmp_path,
                                                               capsys):
    d = str(tmp_path)
    _mk_dump(d, 0, 2, calls=5, trigger="tick", round_id=1,
             host="h-dead", pid=50, tail_name="kv-tail-rank-0.r1.json")
    body = _mk_dump(d, 0, 1, calls=4, trigger="atexit", round_id=2,
                    host="h-live", pid=60)
    body["rounds"] = {"1": 1, "2": 0}
    t0 = 1_700_000_000.0
    body["events"] = [[100 + i, t0 + 0.1 * i, "collective",
                       "allreduce(shape=(2, 4),dtype=float32,op=2,ps=0)",
                       f"t{i}", 0, i, 1] for i in range(7)] + body["events"]
    with open(os.path.join(d, "0.json"), "w") as f:
        json.dump(body, f)
    rc, out, _ = both(capsys, ["--dir", d])
    report = tdoc.merge(tdoc.dedupe(tdoc.load_dir(d)))
    assert report == jdoc.merge(jdoc.dedupe(jdoc.load_dir(d)))
    r1 = report["groups"][tdoc.group_key(1, tdoc.WORLD_GROUP)]
    assert r1["members"] == [0, 1]
    assert r1["stragglers"] == [0]
    assert r1["last_agreed"]["call"] == 4
    r2 = report["groups"][tdoc.group_key(2, tdoc.WORLD_GROUP)]
    assert r2["members"] == [0] and r2["stragglers"] == []
    assert "round 1 · world" in out and "STRAGGLER rank 0" in out


def test_doctor_json_and_trace_outputs(tmp_path, capsys):
    d = str(tmp_path)
    _mk_dump(d, 0, 2, calls=6)
    _mk_dump(d, 1, 2, calls=4)
    trace = tmp_path / "merged.json"
    rc, out, _ = both(capsys, ["--dir", d, "--json", "--trace",
                               str(trace)])
    report = json.loads(out)
    world = report["groups"][tdoc.group_key(0, tdoc.WORLD_GROUP)]
    assert world["stragglers"] == [1]
    assert world["last_agreed"]["call"] == 3
    doc = json.load(open(trace))
    assert {e["pid"] for e in doc["traceEvents"]} == {0, 1}
    assert any(e.get("cat") == "collective" for e in doc["traceEvents"])


def test_doctor_exit_2_when_no_dumps(tmp_path, capsys):
    rc, _, err = both(capsys, ["--dir", str(tmp_path)])
    assert rc == 2 and "no flight dumps" in err


def test_doctor_exit_2_without_a_source(monkeypatch, capsys):
    monkeypatch.delenv("HOROVOD_FLIGHT_DIR", raising=False)
    assert tdoc.main(["--dir", ""]) == 2
    assert tdoc.main(["--kv", "nonsense"]) == 2


def test_doctor_scrapes_live_kv(tmp_path, capsys, monkeypatch):
    """--kv reads the tails, summaries and records straight off a live
    port rendezvous server."""
    monkeypatch.delenv("HOROVOD_SECRET_KEY", raising=False)
    rdv = RendezvousServer()
    port = rdv.start()
    try:
        d = str(tmp_path)
        b0 = _mk_dump(d, 0, 2, calls=6, trigger="tick")
        b1 = _mk_dump(d, 1, 2, calls=2, trigger="tick")
        rdv.put(tflight.SCOPE, "rank-0.r0", json.dumps(b0).encode())
        rdv.put(tflight.SCOPE, "rank-1.r0", json.dumps(b1).encode())
        rdv.put(twatch.SCOPE, "rank-1.r0",
                json.dumps(_watch_record(1, 0)).encode())
        rc, out, _ = both(capsys, ["--kv", f"127.0.0.1:{port}"])
        assert rc == 0
        assert "STRAGGLER rank 1" in out and "[anomalies]" in out
    finally:
        rdv.stop()


# ------------------------------------------------ hvdwatch [anomalies]

def _watch_record(rank, rnd, detector="step_time", step=12, **kw):
    a = {"detector": detector, "value": 0.6, "median": 0.15, "z": 20.0,
         "rank": rank, "round": rnd, "step": step,
         "wall_time": 100.0 + rank, "active": True}
    a.update(kw)
    return {"watch": 1, "rank": rank, "round": rnd, "size": 2,
            "wall_time": 101.0, "anomalies": [a],
            "counts": {detector: 1}, "active": [detector]}


def test_doctor_survives_malformed_watch_record(tmp_path, capsys):
    rec = {"watch": 1, "rank": "0", "round": None, "size": 2,
           "anomalies": [
               {"detector": "step_time"},
               "not-a-dict",
               {"detector": "mfu", "value": "x", "median": 1},
               {"detector": "input_wait", "value": 0.5,
                "median": 0.1, "z": "bad", "step": 3},
           ],
           "counts": {"input_wait": 1, "junk": "NaNish"}}
    (tmp_path / "watch-rank-0.r0.json").write_text(json.dumps(rec))
    rc, out, _ = both(capsys, ["--dir", str(tmp_path)])
    assert "[anomalies]" in out
    assert "input_wait" in out and "junk" not in out
    rc, out, _ = both(capsys, ["--dir", str(tmp_path), "--json"])
    an = json.loads(out)["anomalies"]
    assert sorted(a["detector"] for a in an["anomalies"]) == \
        ["input_wait", "step_time"]


def test_doctor_watch_dedupe_and_version_gate():
    early = _watch_record(0, 1)
    late = _watch_record(0, 1)
    late["counts"] = {"step_time": 3}
    late["anomalies"] = late["anomalies"] * 3
    out = tdoc.dedupe_watch([early, late])
    assert out == jdoc.dedupe_watch([early, late])
    assert len(out) == 1 and out[0]["counts"] == {"step_time": 3}
    newer = dict(_watch_record(0, 1), watch=99)
    assert tdoc._parse_watch(json.dumps(newer).encode(), "x") is None


# ------------------------------------------------ tests/test_tracing.py

def _span(tid, sid, psid, name, t0, dur, status="ok", attrs=None):
    return {"tid": tid, "sid": sid, "psid": psid, "name": name,
            "t0": t0, "dur": dur, "status": status,
            "attrs": dict(attrs or {})}


def _frag(rank, pid, spans, round=0, host="h0"):
    traces = {}
    for sp in spans:
        traces.setdefault(sp["tid"], []).append(sp)
    return {"version": ttracing.TRACE_VERSION, "rank": rank,
            "size": 2, "round": round, "hostname": host, "pid": pid,
            "wall_time": 11.0,
            "stats": {"started": len(traces), "finished": len(traces),
                      "unsampled": 0, "spans": len(spans), "evicted": 0},
            "traces": [{"tid": tid, "done": True, "dur": None,
                        "kept": None, "spans": sps}
                       for tid, sps in traces.items()]}


def _serving_fragments():
    frontend = _frag(0, 100, [
        _span("T1", "req1", "cli1", "serve.request", 10.0, 0.1,
              attrs={"rid": 5, "requeues": 1}),
        _span("T1", "q1", "req1", "serve.queue", 10.0, 0.02),
        _span("T1", "d0", "req1", "serve.dispatch", 10.02, 0.01,
              status="error",
              attrs={"replica": "h1:111", "attempt": 0, "batch": "B0"}),
        _span("T1", "d1", "req1", "serve.dispatch", 10.03, 0.06,
              attrs={"replica": "h1:222", "attempt": 1, "batch": "B1"}),
        _span("T1", "B1", "req1", "serve.batch", 10.03, 0.06,
              attrs={"replica": "h1:222", "size": 2}),
        _span("T2", "req2", None, "serve.request", 10.01, 0.09,
              attrs={"rid": 6, "requeues": 0}),
        _span("T2", "q2", "req2", "serve.queue", 10.01, 0.01),
        _span("T2", "d2", "req2", "serve.dispatch", 10.03, 0.06,
              attrs={"replica": "h1:222", "attempt": 0, "batch": "B1"}),
    ])
    replica = _frag(1, 222, [
        _span("T1", "rb1", "B1", "replica.infer_batch", 10.035, 0.05),
        _span("T1", "e1", "rb1", "engine.execute", 10.04, 0.04,
              attrs={"bucket": 8, "padded_shape": "(8, 2)"}),
    ], host="h1")
    return frontend, replica


def test_parse_trace_version_gates_and_sanitizes(capsys):
    ok = _frag(0, 1, [_span("T", "a", None, "r", 0.0, 0.1)])
    assert tdoc._parse_trace(json.dumps(ok).encode(), "x") is not None
    newer = dict(ok, version=ttracing.TRACE_VERSION + 1)
    assert tdoc._parse_trace(json.dumps(newer).encode(), "x") is None
    assert "newer than this tool" in capsys.readouterr().err
    assert tdoc._parse_trace(b"not json", "x") is None
    dirty = dict(ok)
    dirty["traces"] = [
        {"tid": "T", "spans": [
            {"tid": "T", "sid": "a", "t0": "1.5", "dur": 2,
             "attrs": "not a dict"},
            {"tid": "T"},
            "not a span",
        ]},
        {"tid": "U", "spans": ["junk only"]},
        "not a trace",
    ]
    raw = json.dumps(dirty).encode()
    rec = tdoc._parse_trace(raw, "x")
    assert rec == jdoc._parse_trace(raw, "x")
    [t] = rec["traces"]
    [sp] = t["spans"]
    assert sp["t0"] == 1.5 and sp["dur"] == 2.0
    assert sp["attrs"] == {} and sp["status"] == "ok"


def test_dedupe_trace_keeps_fullest_payload_per_process():
    small = _frag(0, 100, [_span("T", "a", None, "r", 0.0, 0.1)])
    big = _frag(0, 100, [_span("T", "a", None, "r", 0.0, 0.1),
                         _span("T", "b", "a", "c", 0.0, 0.05)])
    other = _frag(1, 200, [_span("U", "x", None, "r", 0.0, 0.1)])
    out = tdoc.dedupe_trace([small, other, big])
    assert out == jdoc.dedupe_trace([small, other, big])
    assert [(r["rank"], len(r["traces"][0]["spans"])) for r in out] == \
        [(0, 2), (1, 1)]


def test_analyze_traces_joins_cross_process_split():
    frontend, replica = _serving_fragments()
    serve = {"replicas": [{"host": "h1", "pid": 222, "rank": 1,
                           "state": "up", "batches": 1}],
             "deaths": [{"host": "h1", "pid": 111, "rank": 0,
                         "requeued": 1}]}
    rep = tdoc.analyze_traces([frontend, replica], serve=serve)
    assert rep == jdoc.analyze_traces([frontend, replica], serve=serve)
    assert rep["requests"] == 2 and rep["complete"] == 2
    slowest = rep["slowest"][0]
    assert slowest["trace_id"] == "T1" and slowest["rid"] == 5
    assert slowest["queue_s"] == pytest.approx(0.02)
    assert slowest["dispatch_s"] == pytest.approx(0.07)
    assert slowest["device_s"] == pytest.approx(0.04)
    [rq] = rep["requeued"]
    assert [(a["attempt"], a["status"], a["replica"])
            for a in rq["attempts"]] == \
        [(0, "error", "h1:111"), (1, "ok", "h1:222")]
    t2 = next(e for e in rep["slowest"] if e["trace_id"] == "T2")
    assert t2["device_s"] == pytest.approx(0.04) and t2["complete"]
    assert tdoc.analyze_traces([]) is None
    frag = _frag(0, 1, [_span("S", "a", None, "train.step", 0.0, 0.5)])
    assert tdoc.analyze_traces([frag])["train_steps"] == 1


def test_doctor_reports_traces_from_dir(tmp_path, capsys):
    frontend, replica = _serving_fragments()
    (tmp_path / "trace-0.json").write_text(json.dumps(frontend))
    (tmp_path / "trace-1.json").write_text(json.dumps(replica))
    (tmp_path / "trace-bad.json.tmp.1").write_text("partial")
    rc, out, _ = both(capsys, ["--dir", str(tmp_path), "--json"])
    report = json.loads(out)
    assert report["traces"]["requests"] == 2
    assert report["traces"]["slowest"][0]["rid"] == 5
    rc, text, _ = both(capsys, ["--dir", str(tmp_path)])
    assert "[traces]" in text
    assert "SLOWEST request rid=5 trace=T1" in text
    assert "queue 20.0 ms, dispatch 70.0 ms, device 40.0 ms" in text
    assert "REQUEUED request rid=5" in text
    assert "attempt 0 -> replica h1:111: error" in text


@pytest.mark.parametrize("with_replica", [True, False])
def test_export_trace_nested_tracks_and_flows(tmp_path, with_replica):
    frontend, replica = _serving_fragments()
    frags = [frontend, replica] if with_replica else [frontend]
    tdoc.export_trace([], str(tmp_path / "t.json"), traces=frags)
    jdoc.export_trace([], str(tmp_path / "j.json"), traces=frags)
    evs = json.load(open(tmp_path / "t.json"))["traceEvents"]
    assert evs == json.load(open(tmp_path / "j.json"))["traceEvents"]
    starts = [e for e in evs if e.get("ph") == "s"]
    finishes = [e for e in evs if e.get("ph") == "f"]
    assert {e["id"] for e in starts} == {"B1:T1", "B1:T2"}
    assert {e["id"] for e in finishes} == {"B1:T1", "B1:T2"}
    want_pid = 1 if with_replica else 0
    assert all(e["pid"] == want_pid for e in finishes)


# ---------------------------------------- tests/test_serve.py [serve]

def _serve_dump(events):
    return {"version": tflight.DUMP_VERSION, "rank": None, "size": None,
            "hostname": "launcher", "pid": 1, "trigger": "serve_exit",
            "round": 0, "rounds": {},
            "recorded": len(events), "dropped": 0, "collective_calls": 0,
            "wall_time": 0.0,
            "events": [[i, float(i), "serve", desc]
                       for i, desc in enumerate(events)]}


def _serve_both(body):
    rt = tdoc.RankDump(body, "<mem>", tail_only=False)
    rj = jdoc.RankDump(body, "<mem>", tail_only=False)
    rep_t, rep_j = tdoc.merge([rt]), jdoc.merge([rj])
    assert rep_t == rep_j
    text = tdoc.render(rep_t)
    assert text == jdoc.render(rep_j)
    return rt, rep_t, text


def test_doctor_serve_section_names_dead_replica():
    rt, report, text = _serve_both(_serve_dump([
        "launcher: frontend UP port=1234",
        "pool: replica rank=0 host=a pid=11 addr=1.2.3.4:5 ADOPTED round=1",
        "pool: replica rank=1 host=b pid=22 addr=1.2.3.5:5 ADOPTED round=1",
        "replica rank=0 host=a pid=11 addr=1.2.3.4:5 DEAD batches=7 "
        "requeued=3 error=ConnectionResetError: peer reset",
        "replica rank=2 host=c pid=33 EVICTED (exiting for respawn) "
        "batches=4",
    ]))
    serve = report["serve"]
    assert len(serve["replicas"]) == 3 and len(serve["deaths"]) == 1
    evicted = [r for r in serve["replicas"] if r["rank"] == 2]
    assert evicted and evicted[0]["state"] == "evicted"
    dead = serve["deaths"][0]
    assert (dead["rank"], dead["host"], dead["pid"]) == (0, "a", 11)
    assert dead["requeued"] == 3 and dead["batches"] == 7
    assert "SERVE REPLICA DEATH: rank 0 (host a, pid 11)" in text, text
    assert "3 in-flight request(s) requeued" in text, text


def test_doctor_folds_late_requeue_into_death_total():
    events = [
        "pool: replica rank=0 host=a pid=11 addr=1.2.3.4:5 ADOPTED "
        "round=0",
        "replica rank=0 host=a pid=11 addr=1.2.3.4:5 DEAD batches=2 "
        "requeued=0 error=StaleHeartbeat: no advance in 5s",
        "pool: late requeue after eviction of replica rank=0 host=a "
        "pid=11 addr=1.2.3.4:5 requeued=4",
    ]
    rt, report, text = _serve_both(_serve_dump(events))
    assert report["serve"]["deaths"][0]["requeued"] == 4
    rt2 = tdoc.RankDump(_serve_dump(events), "<mem2>", tail_only=False)
    assert tdoc.analyze_serve([rt, rt2])["deaths"][0]["requeued"] == 4
    assert "4 in-flight request(s) requeued" in text, text


def test_doctor_serve_section_absent_without_serve_events():
    body = _serve_dump([])
    body["events"] = [[0, 0.0, "kv", "PUT /x/y (3B)"]]
    rt, report, text = _serve_both(body)
    assert tdoc.analyze_serve([rt]) is None
    assert "[serve]" not in text


# --------------------------------------------------- [ckpt], [control]

def test_doctor_ckpt_and_control_plane_sections():
    body = _serve_dump([])
    body["events"] = [
        [0, 0.0, "ckpt", "commit step=10 gen=1 seconds=0.500 bytes=1000"],
        [1, 1.0, "ckpt", "restore step=10 gen=1 source=checkpoint "
                         "seconds=0.200"],
        [2, 2.0, "ckpt", "persist_error step=20 gen=2 "
                         "error=OSError: disk full"],
        [3, 3.0, "kv-failover", "leader 1 -> 2 epoch=3"],
    ]
    _serve_both(body)
