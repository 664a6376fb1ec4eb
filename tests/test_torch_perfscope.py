"""The port's perfscope (horovod_tpu_torch/profiler/perfscope.py)
against the JAX package's.

Each scripted case drives both scopes through the same steps, phase
switches, `attribute` calls and implicit optimizer boundaries under a
fake clock; their `summary()` must agree key for key, every number
within 1e-12 (the same float operations in the same order give the same
bits; the bound leaves room for nothing else). The pinned values of
tests/test_perfscope.py are asserted on the port, and the phases must
sum to the wall time. Then: attribution from another thread while the
training thread is inside a phase (the gradient hooks on autograd's
device thread), the HOROVOD_PERFSCOPE=0 shell, the KV payload, and a
push through the port's rendezvous KV that `persist_kv_summaries`
writes out.
"""

import json
import os
import sys
import threading

import pytest

from horovod_tpu.profiler import perfscope as jps
from horovod_tpu_torch.profiler import perfscope as tps
from horovod_tpu_torch.runner import rendezvous

TOL = 1e-12


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture()
def fresh(monkeypatch):
    for var in ("HOROVOD_PERFSCOPE", "HOROVOD_PERFSCOPE_WINDOW",
                "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_ELASTIC_ROUND",
                "HOROVOD_BENCH_PEAK_TFLOPS", "HOROVOD_GLOO_RENDEZVOUS_ADDR",
                "HOROVOD_GLOO_RENDEZVOUS_PORT"):
        monkeypatch.delenv(var, raising=False)
    tps.reset_for_tests()
    jps.reset_for_tests()
    yield
    tps.reset_for_tests()
    jps.reset_for_tests()


# ------------------------------------------------------ scripted cases

def phase_attribution(ps, clk):
    with ps.step():
        clk.advance(1.0)
        with ps.phase("input_wait"):
            clk.advance(2.0)
        clk.advance(0.5)
        with ps.phase("device_compute"):
            clk.advance(0.25)
    return {"steps": 1, "mean_s": 3.75, "input_wait": 2.0,
            "dispatch": 1.5, "device_compute": 0.25,
            "dominant_phase": "input_wait"}


def nested_phases(ps, clk):
    with ps.step():
        with ps.phase("comms"):
            clk.advance(1.0)
            with ps.phase("compile"):
                clk.advance(0.5)
            clk.advance(1.0)
    return {"comms": 2.0, "compile": 0.5}


def attribute_moves_time(ps, clk):
    with ps.step():
        clk.advance(3.0)
        ps.attribute("comms", 1.0)
    return {"comms": 1.0, "dispatch": 2.0, "mean_s": 3.0}


def attribute_into_active(ps, clk):
    with ps.step():
        with ps.phase("comms"):
            clk.advance(2.0)
            ps.attribute("comms", 1.5)
    return {"comms": 2.0}


def marker_subtracts_nested(ps, clk):
    with ps.step():
        m0 = ps.attributed_marker()
        clk.advance(4.0)
        ps.attribute("compile", 1.0)
        nested = ps.attributed_marker() - m0
        ps.attribute("comms", 4.0 - nested)
    return {"compile": 1.0, "comms": 3.0}


def step_weight(ps, clk):
    with ps.step(weight=10):
        clk.advance(5.0)
        with ps.phase("device_compute"):
            clk.advance(5.0)
    return {"mean_s": 1.0, "dispatch": 0.5, "device_compute": 0.5}


def implicit_optimizer_steps(ps, clk):
    for fwd_bwd in (1.0, 2.0, 2.0):
        ps.step_entry()
        clk.advance(fwd_bwd)
        with ps.phase("comms"):
            clk.advance(0.5)
        with ps.phase("optimizer"):
            clk.advance(0.25)
        ps.step_boundary()
    return {"steps": 3, "max_s": 2.75, "comms": 0.5, "optimizer": 0.25}


def implicit_with_accumulation(ps, clk):
    """backward_passes_per_step 2: entry on every call, the boundary on
    the second only."""
    for i in range(4):
        ps.step_entry()
        clk.advance(1.0)
        if i % 2:
            with ps.phase("comms"):
                clk.advance(0.5)
            ps.step_boundary()
    return {"steps": 2}


def explicit_supersedes_implicit(ps, clk):
    ps.step_entry()
    clk.advance(1.0)
    with ps.step():
        clk.advance(2.0)
        ps.step_entry()
        ps.step_boundary()
        clk.advance(0.5)
    return {"steps": 2, "max_s": 2.5}


def reset_abandons_inflight(ps, clk):
    ps.step_entry()
    clk.advance(100.0)
    ps.reset()
    with ps.step():
        clk.advance(1.0)
    return {"steps": 1, "max_s": 1.0}


def percentiles(ps, clk):
    for dt in [0.1] * 10 + [0.2] * 9 + [1.0]:
        with ps.step():
            clk.advance(dt)
    return {"steps": 20, "p50_s": 0.2, "p95_s": 1.0, "max_s": 1.0}


def window_bounded(ps, clk):
    for _ in range(100):
        with ps.step():
            clk.advance(0.1)
    return {"steps": 100}


def mfu_from_model_flops(ps, clk):
    ps.set_model_flops(5e13, "fallback")
    with ps.step():
        clk.advance(1.0)
    return {"mfu": 0.5}


def dominant_local_excludes_waits(ps, clk):
    with ps.step():
        with ps.phase("input_wait"):
            clk.advance(0.4)
        with ps.phase("comms"):
            clk.advance(3.0)
    return {"dominant_phase": "comms", "dominant_local_phase": "input_wait",
            "local_mean_s": 0.4}


def comms_axes_and_free_phase(ps, clk):
    ps.set_comms_axes({"hvd": 102236160})
    for dt in (0.3, 0.7):
        with ps.step():
            with ps.phase("my_phase"):
                clk.advance(dt)
            ps.attribute("checkpoint", dt / 10)
            clk.advance(dt)
    return {"steps": 2}


def outside_step_is_noop(ps, clk):
    ps.attribute("comms", 5.0)
    with ps.phase("comms"):
        clk.advance(1.0)
    return {}


CASES = [phase_attribution, nested_phases, attribute_moves_time,
         attribute_into_active, marker_subtracts_nested, step_weight,
         implicit_optimizer_steps, implicit_with_accumulation,
         explicit_supersedes_implicit, reset_abandons_inflight, percentiles,
         window_bounded, mfu_from_model_flops, dominant_local_excludes_waits,
         comms_axes_and_free_phase, outside_step_is_noop]


def _close(a, b, path="summary"):
    """a == b key for key; floats within TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_summary_equals_jax(fresh, monkeypatch, case):
    monkeypatch.setenv("HOROVOD_BENCH_PEAK_TFLOPS", "100")  # 1e14 FLOP/s
    window = 16 if case is window_bounded else None
    out = {}
    for tag, mod in (("jax", jps), ("torch", tps)):
        clk = FakeClock()
        ps = mod.PerfScope(window=window, clock=clk)
        pinned = case(ps, clk)
        out[tag] = ps.summary()
        assert ps.step_count() == out[tag].get("steps", 0)
    _close(out["torch"], out["jax"])
    s = out["torch"]
    if not pinned:
        assert s == {}
        return
    flat = dict(s, **s["wall"], **s["phases_s"])
    for k, v in pinned.items():
        assert flat[k] == pytest.approx(v), k
    # The phases sum to the wall time (coverage 1), the switching timer's
    # invariant.
    assert s["coverage"] == pytest.approx(1.0, abs=TOL)


def test_step_profile_equals_jax(fresh):
    got = {}
    for tag, mod in (("jax", jps), ("torch", tps)):
        clk = FakeClock()
        ps = mod.PerfScope(clock=clk)
        implicit_optimizer_steps(ps, clk)
        got[tag] = ps.step_profile("sec", extra=1)
    _close(got["torch"], got["jax"])


def test_attribute_from_another_thread(fresh):
    """The gradient hooks run on autograd's device thread while the
    training thread is blocked inside backward(): their comms time is
    taken out of the training thread's active phase."""
    clk = FakeClock()
    ps = tps.PerfScope(clock=clk)
    with ps.step():
        with ps.phase("device_compute"):
            clk.advance(2.0)
            t = threading.Thread(target=ps.attribute, args=("comms", 0.5))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        clk.advance(1.0)
    s = ps.summary()
    assert s["phases_s"] == {"dispatch": 1.0, "device_compute": 1.5,
                             "comms": 0.5}
    assert s["coverage"] == 1.0


def test_concurrent_attribution_loses_nothing(fresh):
    """Many threads attribute at once, with a short switch interval:
    a lost update would break the comms total."""
    clk = FakeClock()
    ps = tps.PerfScope(clock=clk)
    n_threads, n_iter = 8, 250
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ps.step():
            threads = [threading.Thread(
                target=lambda: [ps.attribute("comms", 0.001)
                                for _ in range(n_iter)])
                for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            clk.advance(10.0)
    finally:
        sys.setswitchinterval(old)
    s = ps.summary()
    assert s["phases_s"]["comms"] == pytest.approx(2.0, abs=1e-9)
    assert s["phases_s"]["dispatch"] == pytest.approx(8.0, abs=1e-9)


# ------------------------------------------------------- NOOP + env

def test_disabled_env_returns_noop(fresh, monkeypatch):
    monkeypatch.setenv("HOROVOD_PERFSCOPE", "0")
    tps.reset_for_tests()
    ps = tps.get()
    assert ps is tps.NOOP
    with ps.step():
        with ps.phase("input_wait"):
            pass
    ps.step_entry()
    ps.step_boundary()
    ps.attribute("comms", 1.0)
    assert ps.attributed_marker() == 0.0
    assert ps.summary() == {} and ps.step_count() == 0
    assert ps.kv_payload() is None and not ps.push_summary()
    assert ps.step_profile("x") == {"name": "x", "perfscope": 1}


@pytest.mark.parametrize("value,on", [("0", False), ("", True), (" ", True),
                                      ("1", True), ("off", False)])
def test_gate_reads_like_jax(fresh, monkeypatch, value, on):
    monkeypatch.setenv("HOROVOD_PERFSCOPE", value)
    assert tps.enabled() == jps.enabled() == on


def test_default_enabled_singleton(fresh):
    assert isinstance(tps.get(), tps.PerfScope)
    assert tps.get() is tps.get()


# ----------------------------------------------------------- KV push

def test_kv_payload_like_jax(fresh, monkeypatch):
    bodies = {}
    for tag, mod in (("jax", jps), ("torch", tps)):
        clk = FakeClock()
        ps = mod.PerfScope(clock=clk)
        with ps.step():
            clk.advance(0.5)
        assert ps.kv_payload() is None   # no rank: unkeyable
        monkeypatch.setenv("HOROVOD_RANK", "3")
        monkeypatch.setenv("HOROVOD_ELASTIC_ROUND", "2")
        bodies[tag] = ps.kv_payload()
        monkeypatch.delenv("HOROVOD_RANK")
        monkeypatch.delenv("HOROVOD_ELASTIC_ROUND")
    for b in bodies.values():
        b.pop("wall_time")
    _close(bodies["torch"], bodies["jax"])
    assert bodies["torch"]["rank"] == 3 and bodies["torch"]["round"] == 2


def test_push_and_persist_through_the_rendezvous_kv(fresh, monkeypatch,
                                                    tmp_path):
    """A rank's push lands in the port's KV server under the (rank,
    round) key; `persist_kv_summaries` writes it as the JAX package's
    does, and the JAX one reads the port's server alike."""
    monkeypatch.delenv("HOROVOD_SECRET_KEY", raising=False)
    srv = rendezvous.RendezvousServer()
    srv.start()
    try:
        for k, v in srv.worker_env("127.0.0.1").items():
            monkeypatch.setenv(k, v)
        monkeypatch.setenv("HOROVOD_RANK", "1")
        monkeypatch.setenv("HOROVOD_ELASTIC_ROUND", "4")
        clk = FakeClock()
        ps = tps.PerfScope(clock=clk)
        with ps.step():
            clk.advance(0.25)
        assert ps.push_summary()
        out = tmp_path / "flight"
        written = tps.persist_kv_summaries(srv, str(out))
        assert [os.path.basename(p) for p in written] == \
            ["perf-rank-1.r4.json"]
        body = json.load(open(written[0]))
        assert body["rank"] == 1 and body["summary"]["steps"] == 1
        assert jps.persist_kv_summaries(srv, str(tmp_path / "j")) and \
            open(tmp_path / "j" / "perf-rank-1.r4.json").read() == \
            open(written[0]).read()
        monkeypatch.setenv("HOROVOD_FLIGHT_DIR", str(tmp_path / "env"))
        assert tps.persist_kv_summaries(srv) == \
            [str(tmp_path / "env" / "perf-rank-1.r4.json")]
    finally:
        srv.stop()


def test_push_is_paced_at_step_boundaries(fresh, monkeypatch):
    """A push at the first recorded step, then none until the interval
    has passed."""
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.setenv("HOROVOD_METRICS_PUSH_INTERVAL", "3600")
    puts = []

    class FakeKV:
        def put(self, scope, key, value):
            puts.append((scope, key, json.loads(value.decode())))

    clk = FakeClock()
    ps = tps.PerfScope(clock=clk)
    ps._kv = FakeKV()
    for _ in range(3):
        ps.step_entry()
        clk.advance(0.1)
        ps.step_boundary()
    assert [(s, k) for s, k, _ in puts] == [("perf", "rank-0.r0")]
    assert puts[0][2]["summary"]["steps"] == 1


def test_persist_without_a_dir_is_a_noop(fresh):
    class Store:
        def scope_items(self, scope):  # pragma: no cover - not reached
            raise AssertionError

    assert tps.persist_kv_summaries(Store(), "") == []
