"""The port's tracer (horovod_tpu_torch/observability/tracing.py) against
the JAX package's, on this host's CPU.

The same spans go through both tracers from the same `random` seed (span
and trace ids are drawn from it): their trace fragments, and the
payloads they push and dump, must be equal in every field but the
wall-clock times and the host. Then the contract of tests/test_tracing.py
on the port, and the step spans on the port's own threading: perfscope
opens a `train.step` root per step, and a collective instrumented on
another thread (autograd's device thread on a card) still lands under
it, which the JAX package's thread-local step cannot do. Tolerance:
exact, durations within 1e-9 s where given.

Left out, with their reasons:
- test_request_context_adopts_or_head_samples,
  test_request_lifecycle_stamps_and_queue_wait_histogram,
  test_trace_context_rides_data_service_frames,
  test_frames_stay_bare_when_tracing_disabled,
  test_perf_gate_requires_serving_section_presence: serving and the
  data service (ROADMAP A12);
- test_parse_trace_version_gates_and_sanitizes,
  test_dedupe_trace_keeps_fullest_payload_per_process,
  test_analyze_traces_joins_cross_process_split,
  test_analyze_traces_counts_train_steps_and_empty_is_none,
  test_doctor_reports_traces_from_dir,
  test_doctor_exits_2_when_nothing_loadable,
  test_export_trace_emits_nested_tracks_and_flow_events,
  test_export_trace_flows_fall_back_to_batch_slice,
  test_perf_gate_accepts_complete_trace_stamp,
  test_perf_gate_rejects_missing_or_partial_trace_stamp: hvddoctor and
  perfboard read the dumps offline (ROADMAP A13 part 2);
- test_step_begin_defers_to_an_adopted_ambient_trace reads the JAX
  package's thread-local step span; the port's case below holds the
  same rule on its process-wide one.
"""

import json
import os
import random
import threading

import pytest

from horovod_tpu.observability import tracing as jtr
from horovod_tpu_torch.observability import tracing as ttr
from torch_threads import leftover, snapshot


@pytest.fixture(scope="module", autouse=True)
def threads_at_start():
    return snapshot()


@pytest.fixture()
def fresh(monkeypatch):
    for var in (ttr.TRACE_ENV, ttr.TRACE_SAMPLE_ENV, ttr.TRACE_CAPACITY_ENV,
                ttr.TRACE_KV_TAIL_ENV, ttr.TRACE_SLOW_KEEP_ENV, ttr.DIR_ENV,
                "HOROVOD_RANK", "HOROVOD_ELASTIC_ROUND",
                "HOROVOD_GLOO_RENDEZVOUS_ADDR",
                "HOROVOD_GLOO_RENDEZVOUS_PORT", "HOROVOD_HOSTNAME"):
        monkeypatch.delenv(var, raising=False)
    jtr.reset_for_tests()
    ttr.reset_for_tests()
    yield monkeypatch
    jtr.reset_for_tests()
    ttr.reset_for_tests()


def _script(tr):
    """Roots, nested children, an error, explicit parents and retroactive
    spans, from a fixed seed."""
    random.seed(1234)
    t = tr.get()
    root = t.start_span("root", new=True, root=True, attrs={"k": 1})
    with tr.span("child", attrs={"n": 2}):
        with tr.span("grandchild"):
            pass
    root.end()
    with pytest.raises(RuntimeError):
        with t.start_span("boom", new=True, root=True):
            raise RuntimeError("bad step")
    sp = t.start_span("remote", parent={"t": "aa", "s": "bb"})
    sp.end("timeout")
    t.add_span("retro", 10.0, 0.25, trace_id="cc", root=True,
               attrs={"bucket": 3})
    for i in range(12):  # evictions and the slowest-keep set
        t.add_span(f"r{i}", 20.0 + i, 0.01 * (i % 5), trace_id=f"t{i}",
                   root=True)
    return t


def _norm(frags):
    out = []
    for f in frags:
        f = {k: v for k, v in f.items() if k not in ("t0", "dur")}
        f["spans"] = [{k: v for k, v in s.items()
                       if k not in ("t0", "dur")} for s in f["spans"]]
        out.append(f)
    return out


def test_span_records_match_jax(fresh):
    fresh.setenv(ttr.TRACE_CAPACITY_ENV, "8")
    fresh.setenv(ttr.TRACE_SLOW_KEEP_ENV, "2")
    jt, tt = _script(jtr), _script(ttr)
    assert _norm(tt.snapshot()) == _norm(jt.snapshot())
    assert tt.stats() == jt.stats()
    fresh.setenv("HOROVOD_RANK", "3")
    pj, pt = jt.payload(), tt.payload()
    for p in (pj, pt):
        p.pop("host", None)
        p.pop("wall_time", None)
        p["traces"] = _norm(p["traces"])
    assert pt == pj
    assert ttr.TRACE_VERSION == jtr.TRACE_VERSION
    # retroactive spans keep their given times exactly
    [retro] = [f for f in tt.snapshot() if f["tid"] == "cc"]
    assert retro["spans"][0]["t0"] == 10.0
    assert abs(retro["spans"][0]["dur"] - 0.25) < 1e-9


def test_span_exit_captures_exception_and_pins_trace(fresh):
    tr = ttr.get()
    with pytest.raises(RuntimeError):
        with tr.start_span("boom", new=True, root=True):
            raise RuntimeError("bad step")
    [frag] = tr.snapshot()
    assert frag["spans"][0]["status"] == "error"
    assert frag["spans"][0]["attrs"]["error"] == "RuntimeError: bad step"
    assert frag["kept"] == "error"
    assert not ttr.active()


def test_head_sampling_zero_returns_noop_but_keeps_adopted(fresh):
    fresh.setenv(ttr.TRACE_SAMPLE_ENV, "0")
    tr = ttr.get()
    assert tr.start_span("r", new=True, root=True) is ttr.NOOP_SPAN
    sp = tr.start_span("child", parent={"t": "aa", "s": "bb"})
    assert sp is not ttr.NOOP_SPAN
    sp.end()
    assert [t["tid"] for t in tr.snapshot()] == ["aa"]


def test_disabled_tracer_is_noop_shell(fresh):
    fresh.setenv(ttr.TRACE_ENV, "0")
    ttr.reset_for_tests()
    t = ttr.get()
    assert t is ttr.NOOP
    assert ttr.start_trace("x") is ttr.NOOP_SPAN
    assert ttr.span("y") is ttr.NOOP_SPAN
    assert ttr.adopt({"t": "aa", "s": "bb"}) is None
    ttr.step_begin()
    assert not ttr.active()
    ttr.step_end()
    ttr.collective_span("g", "allreduce", 0.01)
    ttr.record_dispatch("allreduce(f32[4])", "g")
    assert t.snapshot() == [] and t.payload() == {}
    assert ttr.dump("manual") is None and not ttr.push_tail()


def test_step_spans_parent_collective_children_from_any_thread(fresh):
    tr = ttr.get()
    ttr.step_begin()
    ttr.step_begin()  # idempotent while a step is open
    assert ttr.active()
    ttr.record_dispatch("allreduce(f32[4]) ps0#0", "grads")

    def hook_thread():  # autograd's device thread on a card
        assert ttr.active()
        ttr.collective_span("bucketed_allreduce/b0", "ALLREDUCE", 0.01,
                            nbytes=16.0)

    t = threading.Thread(target=hook_thread)
    t.start()
    t.join()
    ttr.step_end()
    ttr.step_end()  # idempotent once closed
    assert not ttr.active()
    [frag] = tr.snapshot()
    by_name = {s["name"]: s for s in frag["spans"]}
    root = by_name["train.step"]
    assert by_name["dispatch"]["psid"] == root["sid"]
    coll = by_name["collective.bucketed_allreduce/b0"]
    assert coll["psid"] == root["sid"]
    assert coll["attrs"] == {"activity": "ALLREDUCE", "nbytes": 16.0}
    assert abs(coll["dur"] - 0.01) < 1e-9


def test_step_begin_defers_to_an_adopted_ambient_trace(fresh):
    ttr.get()
    tok = ttr.adopt({"t": "cafe", "s": "feed"})
    ttr.step_begin()
    assert ttr._step_span is None
    assert ttr.current_context() == {"t": "cafe", "s": "feed"}
    ttr.clear(tok)


def test_perfscope_steps_and_collectives_are_spans(fresh, tmp_path):
    """Through the port's own paths: each optimizer step is a train.step
    root, and its bucket launches and eager collectives its children."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.profiler import perfscope
    perfscope.reset_for_tests()
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        model = torch.nn.Linear(4, 2)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        for _ in range(3):
            opt.zero_grad()
            model(torch.ones(2, 4)).sum().backward()
            opt.step()
            hvd.allreduce(torch.ones(2), name="loss")
    finally:
        hvd.shutdown()
        perfscope.reset_for_tests()
    steps = [f for f in ttr.get().snapshot()
             if f["spans"] and any(s["name"] == "train.step"
                                   for s in f["spans"])]
    assert len(steps) >= 3
    names = {s["name"] for f in steps for s in f["spans"]}
    assert "collective.bucketed_allreduce/b0" in names
    assert "collective.loss" in names and "dispatch" in names


def test_dump_and_push_tail_are_rank_round_keyed(fresh, tmp_path):
    assert ttr.dump("manual", push_kv=False) is None  # no dir set
    fresh.setenv(ttr.DIR_ENV, str(tmp_path))
    fresh.setenv("HOROVOD_RANK", "3")
    fresh.setenv("HOROVOD_ELASTIC_ROUND", "2")
    tr = ttr.get()
    tr.add_span("train.step", 0.0, 0.1, trace_id="aa", root=True)
    path = ttr.dump("manual", push_kv=False)
    assert path == str(tmp_path / "trace-3.r2.json")
    body = json.load(open(path))
    assert body["rank"] == 3 and body["round"] == 2
    assert [t["tid"] for t in body["traces"]] == ["aa"]
    puts = []

    class FakeKV:
        def put(self, scope, key, value):
            puts.append((scope, key, ttr.suppressed()))

    tr._kv = FakeKV()
    assert ttr.push_tail()
    assert puts == [(ttr.SCOPE, "rank-3.r2", True)]


def test_persist_kv_spans_from_rendezvous_server(fresh, tmp_path):
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    rdv = RendezvousServer()
    rdv.start()
    try:
        rdv.put(ttr.SCOPE, "rank-0.r1", b'{"traces": []}')
        rdv.put(ttr.SCOPE, "rank-1.r1", b'{"traces": []}')
        rdv.put("metrics", "rank-0", b"not a trace key")
        written = ttr.persist_kv_spans(rdv, str(tmp_path / "fl"))
        assert sorted(os.path.basename(p) for p in written) == \
            ["trace-kv-rank-0.r1.json", "trace-kv-rank-1.r1.json"]
        assert ttr.persist_kv_spans(rdv, "") == []
    finally:
        rdv.stop()


def test_no_thread_left_behind(threads_at_start):
    assert not leftover(threads_at_start), leftover(threads_at_start)
