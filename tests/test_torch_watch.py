"""hvdwatch in the port (horovod_tpu_torch/observability/watch.py)
against the JAX package's, on this host's CPU.

The same sample sequences go through both packages' detectors and
through a `Watcher` of each package driven by a fake clock over a
fake-clock perfscope: the anomalies, the counts, the active set and the
KV payloads must be equal (all but the wall-clock times, the pid and
the host name). Then the contract of tests/test_watch.py on the port:
warmup silence, single-step spikes against sustained shifts,
hysteresis and cooldown, the elastic-round reset and churn, the serve
burn rate and its gauge, the rank/round-keyed KV record, the rank-0
sink, the no-op shell, the job-end persistence, and the escalation
into an injected on-demand capture. Tolerance: exact (the detectors
hold the same floats in the same order).
"""

import json
import os
import random

import pytest

from horovod_tpu.common import hvd_logging as jlog
from horovod_tpu.observability import metrics as jm
from horovod_tpu.observability import watch as jw
from horovod_tpu.profiler import perfscope as jp
from horovod_tpu_torch.common import hvd_logging as tlog
from horovod_tpu_torch.observability import metrics as tm
from horovod_tpu_torch.observability import watch as tw
from horovod_tpu_torch.profiler import perfscope as tp

PKGS = {"jax": (jw, jp, jm), "torch": (tw, tp, tm)}
_VOLATILE = {"wall_time", "pid", "hostname"}


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in _VOLATILE}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


# ----------------------------------------------------- detector parity

def _series(seed, n=120):
    """A baseline with noise, a spike, a sustained shift and a return."""
    rng = random.Random(seed)
    base = 0.1 + 0.05 * rng.random()
    out = [base * (1 + 0.05 * rng.gauss(0, 1)) for _ in range(40)]
    out += [base * 20, base]
    out += [base * (3 + rng.random()) for _ in range(15)]
    out += [base * (1 + 0.05 * rng.gauss(0, 1)) for _ in range(n - 57)]
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("direction", [1, -1])
def test_detector_parity(seed, direction):
    cfg = dict(warmup=8, z=6.0, hysteresis=3, cooldown_s=5.0, window=32,
               direction=direction, min_delta=0.01)
    dj = jw.Detector(jw.DetectorConfig("d", **cfg))
    dt = tw.Detector(tw.DetectorConfig("d", **cfg))
    vals = _series(seed)
    if direction < 0:
        vals = [1.0 - v for v in vals]
    got_j, got_t = [], []
    for i, v in enumerate(vals):
        got_j.append((dj.observe(v, float(i)), dj.state, dj.last_z))
        got_t.append((dt.observe(v, float(i)), dt.state, dt.last_z))
    assert got_t == got_j
    assert dt.triggers == dj.triggers


@pytest.mark.parametrize("seed", range(3))
def test_threshold_and_churn_parity(seed):
    rng = random.Random(seed)
    tj = jw.ThresholdDetector("b", 2.0, hysteresis=2, cooldown_s=3.0)
    tt = tw.ThresholdDetector("b", 2.0, hysteresis=2, cooldown_s=3.0)
    cj = jw.ChurnDetector(max_events=2, window_s=10.0, cooldown_s=4.0)
    ct = tw.ChurnDetector(max_events=2, window_s=10.0, cooldown_s=4.0)
    now = 0.0
    for _ in range(80):
        now += rng.choice([0.5, 1.0, 4.0])
        v = rng.choice([0.5, 1.0, 3.0, 5.0])
        assert tt.observe(v, now) == tj.observe(v, now)
        assert ct.observe_event(now) == cj.observe_event(now)
        assert (tt.state, ct.state) == (tj.state, cj.state)


def test_slo_helpers_parity():
    bounds = [0.001 * 2 ** i for i in range(16)]
    rng = random.Random(0)
    for _ in range(50):
        deltas = [rng.randrange(0, 20) for _ in bounds]
        slo = rng.choice([0.01, 0.1, 1.0, 0.0005])
        assert tw.over_slo_count(bounds, deltas, slo) == \
            jw.over_slo_count(bounds, deltas, slo)
        bad, total = rng.randrange(0, 30), rng.randrange(0, 30)
        assert tw.burn_rate(bad, total, 0.01) == \
            jw.burn_rate(bad, total, 0.01)


# --------------------------------------------------------- fake clocks

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeKV:
    def __init__(self):
        self.puts = []
        self.store = {}

    def put(self, scope, key, value):
        self.puts.append((scope, key, value))
        self.store[f"{scope}/{key}"] = value

    def get(self, scope, key, timeout=0.0):
        return self.store.get(f"{scope}/{key}")


@pytest.fixture()
def env(monkeypatch):
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_ELASTIC_ROUND",
                "HOROVOD_WATCH_DIR", "HOROVOD_FLIGHT_DIR",
                "HOROVOD_WATCH_WEBHOOK", "HOROVOD_HOSTNAME",
                "HOROVOD_GLOO_RENDEZVOUS_ADDR",
                "HOROVOD_GLOO_RENDEZVOUS_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOROVOD_PERFSCOPE", "1")
    monkeypatch.setenv("HOROVOD_WATCH_WARMUP", "5")
    monkeypatch.setenv("HOROVOD_WATCH_HYSTERESIS", "3")
    monkeypatch.setenv("HOROVOD_WATCH_COOLDOWN_SECONDS", "60")
    for w, p, m in PKGS.values():
        m.reset_for_tests()
        w.reset_for_tests()
    yield monkeypatch
    for w, p, m in PKGS.values():
        m.reset_for_tests()
        w.reset_for_tests()
        p.reset_for_tests()
    # An anomaly logs through each package's logger, whose handler holds
    # the sys.stderr of the test that made it: drop them.
    jlog.reset_for_tests()
    tlog.reset_for_tests()


class Twin:
    """One package's watcher over its own fake-clock perfscope."""

    def __init__(self, pkg, monkeypatch, **kw):
        self.w_mod, self.p_mod, self.m_mod = PKGS[pkg]
        self.clock = FakeClock()
        self.scope = self.p_mod.PerfScope(window=256, clock=self.clock)
        monkeypatch.setattr(self.p_mod, "_scope", self.scope)
        self.dumps, self.captures = [], []
        kw.setdefault("dump_fn", self.dumps.append)
        kw.setdefault("capture_fn",
                      lambda *a, **k: self.captures.append((a, k)) or True)
        self.w = self.w_mod.Watcher(clock=self.clock, **kw)

    def step(self, dur, comms=0.0, input_wait=0.0):
        with self.scope.step():
            if input_wait:
                with self.scope.phase("input_wait"):
                    self.clock.advance(input_wait)
            self.clock.advance(dur)
            if comms:
                with self.scope.phase("comms"):
                    self.clock.advance(comms)

    def outcome(self):
        return {"counts": self.w.counts(), "active": self.w.active(),
                "records": _strip(self.w.records()),
                "payload": _strip(self.w.kv_payload()),
                "dumps": list(self.dumps)}


def _both(monkeypatch, scenario, **kw):
    """Run `scenario(twin)` through each package in turn; returns the
    port's twin after asserting its outcome equals the JAX twin's."""
    out = {}
    twins = {}
    for pkg in ("jax", "torch"):
        twins[pkg] = t = Twin(pkg, monkeypatch, **kw)
        scenario(t)
        out[pkg] = t.outcome()
        t.m_mod.reset_for_tests()
    assert out["torch"] == out["jax"]
    return twins["torch"], out["torch"]


def _slowdown(t):
    for _ in range(10):
        t.step(0.15)
        t.w.tick()
    for _ in range(5):
        t.step(0.60)
        t.w.tick()


def test_watcher_detects_sustained_local_slowdown(env, tmp_path):
    env.setenv("HOROVOD_WATCH_DIR", str(tmp_path))
    t, out = _both(env, _slowdown)
    assert out["counts"] == {"step_time": 1}
    assert "step_time" in out["active"]
    assert out["dumps"] == ["anomaly:step_time"]
    assert len(t.captures) == 1
    (path,), kw = t.captures[0]
    assert path.startswith(str(tmp_path)) and "step_time" in path
    assert kw["steps"] == 8 and kw["timeout_s"] == 30.0
    assert kw["step_count_fn"]() == t.scope.step_count()
    rec = out["records"][0]
    assert rec["detector"] == "step_time" and rec["z"] > 6
    assert rec["step"] > 0 and rec["active"]


def test_watcher_metric_counts_anomaly(env):
    t = Twin("torch", env)
    _slowdown(t)
    fam = tm.registry().peek("hvdwatch_anomalies_total")
    series = {tuple(s["labels"]): s["value"]
              for s in fam.snapshot_series()}
    assert series.get(("step_time",)) == 1.0


def test_watcher_ignores_peer_wait_in_comms(env):
    def sc(t):
        for _ in range(10):
            t.step(0.15, comms=0.02)
            t.w.tick()
        for _ in range(6):
            t.step(0.15, comms=0.50)
            t.w.tick()
    _, out = _both(env, sc)
    assert out["counts"] == {}


def test_watcher_detects_input_wait_creep(env):
    def sc(t):
        for _ in range(10):
            t.step(0.05, input_wait=0.01)
            t.w.tick()
        for _ in range(6):
            t.step(0.05, input_wait=0.40)
            t.w.tick()
    _, out = _both(env, sc)
    assert out["counts"].get("input_wait") == 1
    assert "input_wait" in out["active"]


def test_watcher_resets_baselines_on_elastic_round(env):
    def sc(t):
        env.setenv("HOROVOD_ELASTIC_ROUND", "1")
        for _ in range(10):
            t.step(0.1)
            t.w.tick()
        env.setenv("HOROVOD_ELASTIC_ROUND", "2")
        for _ in range(8):
            t.step(0.5)
            t.w.tick()
    _, out = _both(env, sc)
    assert out["counts"].get("step_time") is None


def test_watcher_flags_elastic_round_churn(env):
    env.setenv("HOROVOD_WATCH_CHURN_ROUNDS", "2")
    env.setenv("HOROVOD_WATCH_CHURN_WINDOW_SECONDS", "1000")

    def sc(t):
        env.setenv("HOROVOD_ELASTIC_ROUND", "1")
        t.w.tick()
        for rnd in (2, 3, 4):
            t.clock.advance(5.0)
            env.setenv("HOROVOD_ELASTIC_ROUND", str(rnd))
            t.w.tick()
    _, out = _both(env, sc)
    assert out["counts"].get("elastic_churn") == 1


def test_watcher_serve_burn_rate_trips_and_sets_gauge(env):
    env.setenv("HOROVOD_WATCH_SERVE_SLO_MS", "1000")
    env.setenv("HOROVOD_WATCH_SERVE_BUDGET", "0.01")
    env.setenv("HOROVOD_WATCH_BURN_RATE", "14")
    burns = {}

    def sc(t):
        reg = t.m_mod.registry()
        hist = reg.histogram("horovod_serve_request_seconds",
                             buckets=t.m_mod.TIME_BUCKETS)
        t.w.tick()
        for _ in range(4):
            for _ in range(50):
                hist.observe(0.01)
            t.clock.advance(5.0)
            t.w.tick()
        assert t.w.counts() == {}
        for _ in range(4):
            for _ in range(25):
                hist.observe(0.01)
            for _ in range(25):
                hist.observe(4.0)
            t.clock.advance(5.0)
            t.w.tick()
        burns[t.w_mod.__name__] = reg.peek(
            "horovod_serve_slo_burn_rate").value
    _, out = _both(env, sc)
    assert out["counts"].get("serve_burn") == 1
    assert burns[tw.__name__] == pytest.approx(50.0)
    assert burns[tw.__name__] == burns[jw.__name__]


def test_watcher_ckpt_backpressure_detector(env):
    def sc(t):
        reg = t.m_mod.registry()
        g = reg.gauge("horovod_ckpt_skipped_total", "")
        skipped = 0.0
        for i in range(12):
            if i >= 6:
                skipped += 1.0
            g.set(skipped)
            t.clock.advance(1.0)
            t.w.tick()
    _, out = _both(env, sc)
    assert out["counts"].get("ckpt_skipped") == 1


def test_watcher_kv_record_is_rank_round_keyed(env):
    env.setenv("HOROVOD_RANK", "3")
    env.setenv("HOROVOD_ELASTIC_ROUND", "2")
    kvs = {}

    def sc(t):
        kv = kvs[t.w_mod.__name__]
        for _ in range(10):
            t.step(0.1)
            t.w.tick()
        assert not kv.puts
        for _ in range(5):
            t.step(0.6)
            t.w.tick()

    for pkg, mod in (("jax", jw), ("torch", tw)):
        kvs[mod.__name__] = FakeKV()
    out = {}
    for pkg, mod in (("jax", jw), ("torch", tw)):
        kv = kvs[mod.__name__]
        t = Twin(pkg, env, kv_factory=lambda kv=kv: kv)
        sc(t)
        out[pkg] = [(s, k, _strip(json.loads(v))) for s, k, v in kv.puts]
        t.m_mod.reset_for_tests()
    assert out["torch"] == out["jax"]
    scopes_keys = {(s, k) for s, k, _ in out["torch"]}
    assert (tw.SCOPE, "rank-3.r2") in scopes_keys
    body = out["torch"][-1][2]
    assert body["watch"] == tw.WATCH_VERSION == jw.WATCH_VERSION
    assert body["rank"] == 3 and body["round"] == 2
    assert body["counts"]["step_time"] == 1
    assert body["anomalies"][0]["detector"] == "step_time"
    assert "step_time" in body["active"]


def test_watcher_rank0_sink_aggregates_and_webhooks(env):
    env.setenv("HOROVOD_RANK", "0")
    env.setenv("HOROVOD_SIZE", "2")
    env.setenv("HOROVOD_WATCH_WEBHOOK", "http://sink.test/hook")
    env.setenv("HOROVOD_WATCH_AGGREGATE_SECONDS", "1")
    peer = json.dumps({
        "watch": 1, "rank": 1, "round": 0,
        "anomalies": [{"detector": "mfu", "value": 0.1, "median": 0.5,
                       "z": -9.0, "rank": 1, "round": 0, "step": 7,
                       "wall_time": 1.0, "active": True}],
        "counts": {"mfu": 1}, "active": ["mfu"]}).encode()
    hooks = {}
    for pkg in ("jax", "torch"):
        kv = FakeKV()
        kv.store[f"watch/rank-1.r0"] = peer
        got = hooks[pkg] = []
        t = Twin(pkg, env, kv_factory=lambda kv=kv: kv,
                 webhook_fn=lambda url, a, got=got: got.append((url, a)))
        for _ in range(3):
            t.clock.advance(2.0)
            t.w.tick()
        n = len(got)
        t.clock.advance(2.0)
        t.w.tick()
        assert len(got) == n  # dedupe: no second alert
        t.m_mod.reset_for_tests()
    assert hooks["torch"] == hooks["jax"]
    assert any(a["detector"] == "mfu" and a["rank"] == 1
               and url == "http://sink.test/hook"
               for url, a in hooks["torch"])


def test_noop_shell_under_env_off(env):
    env.setenv("HOROVOD_WATCH", "0")
    tw.reset_for_tests()
    w = tw.get()
    assert w is tw.NOOP
    assert w.tick() == [] and w.push_record() is False
    assert w.kv_payload() is None and w.counts() == {}
    assert w.active() == [] and w.records() == []
    tw.on_export_tick()  # never raises
    assert tw.enabled() is False


def test_get_is_one_watcher_per_process(env):
    env.setenv("HOROVOD_WATCH", "1")
    tw.reset_for_tests()
    assert tw.get() is tw.get()
    assert isinstance(tw.get(), tw.Watcher)


def test_env_knobs_match_the_jax_package():
    names = sorted(n for n in dir(jw) if n.startswith("WATCH_")
                   and n.endswith("_ENV") or n == "WATCH_ENV")
    assert names
    for n in names:
        assert getattr(tw, n) == getattr(jw, n), n
    assert (tw.SCOPE, tw.WATCH_VERSION, tw.MAX_RECORDS) == \
        (jw.SCOPE, jw.WATCH_VERSION, jw.MAX_RECORDS)


class _Store:
    def __init__(self, items):
        self.items = items

    def scope_items(self, scope):
        assert scope == tw.SCOPE
        return self.items


def test_persist_kv_records_writes_files(tmp_path):
    items = {"rank-0.r1": b'{"watch": 1, "anomalies": []}',
             "rank-1.r1": b'{"watch": 1, "anomalies": [1]}'}
    out_t = tw.persist_kv_records(_Store(items), str(tmp_path / "t"))
    out_j = jw.persist_kv_records(_Store(items), str(tmp_path / "j"))
    assert [os.path.basename(p) for p in out_t] == \
        [os.path.basename(p) for p in out_j] == \
        ["watch-rank-0.r1.json", "watch-rank-1.r1.json"]
    for a, b in zip(out_t, out_j):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_persist_kv_records_defaults_to_flight_dir(env, tmp_path):
    env.setenv("HOROVOD_FLIGHT_DIR", str(tmp_path))
    out = tw.persist_kv_records(_Store({"rank-2.r0": b"{}"}))
    assert out == [str(tmp_path / "watch-rank-2.r0.json")]


def test_persist_kv_records_noop_without_dir(env):
    class Store:
        def scope_items(self, scope):  # pragma: no cover - not reached
            raise AssertionError("must not be consulted without a dir")

    assert tw.persist_kv_records(Store()) == []


def test_launcher_persists_watch_records(env, tmp_path):
    """runner/launch.py persist_job_records (the launcher's and the
    elastic driver's job end) writes the watch/ scope beside the
    flight tails."""
    from horovod_tpu_torch.runner.launch import persist_job_records

    class Store:
        def scope_items(self, scope):
            return {"rank-0.r0": b'{"watch": 1}'} if scope == "watch" \
                else {}

    env.setenv("HOROVOD_FLIGHT_DIR", str(tmp_path))
    persist_job_records(Store())
    assert (tmp_path / "watch-rank-0.r0.json").read_bytes() == \
        b'{"watch": 1}'


def test_exporter_tick_runs_the_watcher(env):
    """observability/export.py: each push tick is one detection pass."""
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.observability.export import MetricsExporter
    ticks = []

    class W:
        def tick(self):
            ticks.append(1)
            return []

    env.setattr(tw, "_watcher", W())
    ex = MetricsExporter(Config.from_env(), lambda: None, lambda: None)
    ex.tick(force=True)
    assert ticks == [1]


def test_escalation_starts_the_port_capture_by_default(env, tmp_path):
    """Without an injected capture_fn the escalation calls the port's
    device_profile.start_on_demand_capture with the watch knobs."""
    from horovod_tpu_torch.profiler import device_profile
    calls = []
    env.setattr(device_profile, "start_on_demand_capture",
                lambda out, **kw: calls.append((out, kw)) or True)
    env.setenv("HOROVOD_WATCH_DIR", str(tmp_path))
    env.setenv("HOROVOD_WATCH_CAPTURE_STEPS", "3")
    t = Twin("torch", env, capture_fn=None)
    _slowdown(t)
    assert len(calls) == 1
    out, kw = calls[0]
    assert os.path.dirname(out) == str(tmp_path)
    assert os.path.basename(out).startswith("devtrace-rankNone.r0-step_time")
    assert kw["steps"] == 3


def test_capture_off_and_without_dir_is_skipped(env, tmp_path):
    t = Twin("torch", env)
    _slowdown(t)  # no watch dir: nothing captured
    assert t.captures == [] and t.w.counts() == {"step_time": 1}
    env.setenv("HOROVOD_WATCH_DIR", str(tmp_path))
    env.setenv("HOROVOD_WATCH_CAPTURE", "0")
    t = Twin("torch", env)
    _slowdown(t)
    assert t.captures == []
