"""hvdwatch: always-on online anomaly detection with triggered deep
capture (counterpart of horovod_tpu/observability/watch.py: the same
detectors, knobs, records and KV payloads).

Every observability layer before this one is passive or postmortem: the
metrics plane must be scraped, the flight recorder dumps only on
fatal errors, perfscope summarizes when asked. This
module closes the loop the way production-scale systems do (MegaScale,
NSDI '24; Beyer et al., *Site Reliability Engineering*, 2016 — SLOs as
burn-rate alerts, not dashboards): per-rank detectors ride the signals
the runtime already emits, notice a regression the moment it happens,
and **escalate capture automatically** so the evidence exists before
anyone is paged.

Detectors (rolling median + MAD z-score unless noted; each with warmup,
hysteresis, and per-detector cooldown so a recompile spike or an
elastic round cannot flap alerts):

``step_time``     per-step LOCAL time (wall minus peer-wait phases,
                  from perfscope samples) — local, not wall, because in
                  a synchronous job every rank's wall converges to the
                  slowest rank's; only local time names the culprit
``input_wait``    per-step ``input_wait`` seconds (host input starvation)
``mfu``           the ``horovod_mfu`` gauge, low side (throughput drop)
``overlap``       the ``horovod_overlap_fraction`` gauge, low side
                  (backward/comms overlap collapse)
``queue_depth``   the ``horovod_serve_queue_depth`` gauge, high side
``elastic_churn`` elastic round transitions per time window (rule-based:
                  more than HOROVOD_WATCH_CHURN_ROUNDS changes within
                  HOROVOD_WATCH_CHURN_WINDOW_SECONDS)
``serve_burn``    serve SLO error-budget burn rate (fixed threshold):
                  the fraction of requests in the tick window that were
                  slower than HOROVOD_WATCH_SERVE_SLO_MS or failed,
                  divided by the budget HOROVOD_WATCH_SERVE_BUDGET —
                  burn >= HOROVOD_WATCH_BURN_RATE sustained trips it

On trigger the watcher escalates:

* ``hvdwatch_anomalies_total{detector}`` is incremented,
* a typed ``anomaly`` flight event is recorded and a flight-recorder
  dump forced (``anomaly:<detector>`` trigger, round-suffixed like
  every flight dump path),
* an on-demand ``torch.profiler`` trace of the card (its own kernels)
  is started for HOROVOD_WATCH_CAPTURE_STEPS steps
  (profiler/device_profile.py start_on_demand_capture — serialized
  behind a single capture lock so two triggers, or a
  trigger racing an operator's capture, cannot collide),
* a rank/round-keyed KV record is pushed under scope ``watch``
  (persisted at job end by both launchers like the flight tails, so
  ``hvddoctor`` gains an ``[anomalies]`` section offline).

Rank 0 additionally aggregates job-wide by probing peers' ``watch``
records on the exporter cadence and feeds every new anomaly to the
alert sink: a log line, plus an optional webhook POST
(HOROVOD_WATCH_WEBHOOK).

The watcher ticks on the metrics-exporter cadence
(observability/export.py) and is on by default; ``HOROVOD_WATCH=0``
swaps it for a no-op shell (the HOROVOD_METRICS=0 pattern).
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from horovod_tpu_torch.common.config import _env_float, _env_int, _env_on

WATCH_ENV = "HOROVOD_WATCH"
WATCH_WARMUP_ENV = "HOROVOD_WATCH_WARMUP"
WATCH_Z_ENV = "HOROVOD_WATCH_Z"
WATCH_HYSTERESIS_ENV = "HOROVOD_WATCH_HYSTERESIS"
WATCH_COOLDOWN_ENV = "HOROVOD_WATCH_COOLDOWN_SECONDS"
WATCH_WINDOW_ENV = "HOROVOD_WATCH_WINDOW"
WATCH_MIN_STEP_DELTA_ENV = "HOROVOD_WATCH_MIN_STEP_DELTA"
WATCH_CAPTURE_ENV = "HOROVOD_WATCH_CAPTURE"
WATCH_CAPTURE_STEPS_ENV = "HOROVOD_WATCH_CAPTURE_STEPS"
WATCH_CAPTURE_SECONDS_ENV = "HOROVOD_WATCH_CAPTURE_SECONDS"
WATCH_DIR_ENV = "HOROVOD_WATCH_DIR"
WATCH_WEBHOOK_ENV = "HOROVOD_WATCH_WEBHOOK"
WATCH_SERVE_SLO_MS_ENV = "HOROVOD_WATCH_SERVE_SLO_MS"
WATCH_SERVE_BUDGET_ENV = "HOROVOD_WATCH_SERVE_BUDGET"
WATCH_BURN_RATE_ENV = "HOROVOD_WATCH_BURN_RATE"
WATCH_CHURN_ROUNDS_ENV = "HOROVOD_WATCH_CHURN_ROUNDS"
WATCH_CHURN_WINDOW_ENV = "HOROVOD_WATCH_CHURN_WINDOW_SECONDS"
WATCH_AGGREGATE_ENV = "HOROVOD_WATCH_AGGREGATE_SECONDS"
WATCH_CKPT_SKIPPED_ENV = "HOROVOD_WATCH_CKPT_SKIPPED"

#: Rendezvous-KV scope the per-rank anomaly records live under.
SCOPE = "watch"

#: Schema tag in every pushed/persisted record (doctor compatibility).
WATCH_VERSION = 1

#: Anomalies retained per rank record (KV payload + local history).
MAX_RECORDS = 64


# ----------------------------------------------------------- detectors

class DetectorConfig:
    """Tuning of one detector's state machine (all fake-clock
    testable; env defaults resolved once at watcher construction)."""

    __slots__ = ("name", "warmup", "z", "hysteresis", "cooldown_s",
                 "window", "direction", "min_delta", "rel_floor",
                 "abs_floor")

    def __init__(self, name: str, warmup: int = 20, z: float = 8.0,
                 hysteresis: int = 3, cooldown_s: float = 120.0,
                 window: int = 64, direction: int = 1,
                 min_delta: float = 0.0, rel_floor: float = 0.05,
                 abs_floor: float = 1e-9) -> None:
        self.name = name
        self.warmup = max(1, warmup)
        self.z = z
        self.hysteresis = max(1, hysteresis)
        self.cooldown_s = cooldown_s
        self.window = max(8, window)
        self.direction = 1 if direction >= 0 else -1  # +1: high is bad
        self.min_delta = min_delta
        self.rel_floor = rel_floor
        self.abs_floor = abs_floor


class Detector:
    """Rolling median + MAD z-score anomaly detector.

    State machine: ``warmup`` (first `warmup` samples are baseline
    only, never alert) -> ``ok`` -> ``active`` after `hysteresis`
    CONSECUTIVE anomalous samples (a single-step spike — a recompile —
    can never trigger), back to ``ok`` after `hysteresis` consecutive
    normal samples. A new trigger is suppressed for `cooldown_s` after
    the previous one. Anomalous samples are NOT absorbed into the
    baseline, so a sustained shift stays visible instead of teaching
    the detector that slow is the new normal.

    Single-threaded by design: the watcher drives every detector from
    inside its own lock.
    """

    def __init__(self, cfg: DetectorConfig) -> None:
        self.cfg = cfg
        self.values: collections.deque = collections.deque(
            maxlen=cfg.window)
        self.seen = 0
        self.bad_streak = 0
        self.ok_streak = 0
        self.active = False
        self.cooldown_until = float("-inf")
        self.triggers = 0
        self.last_z = 0.0
        self.last_median = 0.0

    @property
    def state(self) -> str:
        if self.seen < self.cfg.warmup:
            return "warmup"
        return "active" if self.active else "ok"

    def reset(self) -> None:
        """Back to warmup (elastic round adopted: rank assignment and
        the performance regime both changed — stale baselines would
        flap)."""
        self.values.clear()
        self.seen = 0
        self.bad_streak = 0
        self.ok_streak = 0
        self.active = False

    def _sigma(self, med: float) -> float:
        if len(self.values) < 2:
            return max(self.cfg.rel_floor * abs(med), self.cfg.abs_floor)
        mad = statistics.median(abs(v - med) for v in self.values)
        return max(mad / 0.6745, self.cfg.rel_floor * abs(med),
                   self.cfg.abs_floor)

    def observe(self, value: float, now: float) -> Optional[Dict[str, Any]]:
        """Feed one sample; returns the anomaly dict on the OK->ACTIVE
        transition, else None."""
        cfg = self.cfg
        self.seen += 1
        if self.seen <= cfg.warmup or not self.values:
            self.values.append(value)
            return None
        med = statistics.median(self.values)
        z = (value - med) / self._sigma(med)
        self.last_z = z
        self.last_median = med
        delta = (value - med) * cfg.direction
        anomalous = (z * cfg.direction >= cfg.z
                     and delta >= cfg.min_delta)
        if not anomalous:
            self.values.append(value)
            self.bad_streak = 0
            if self.active:
                self.ok_streak += 1
                if self.ok_streak >= cfg.hysteresis:
                    self.active = False
                    self.ok_streak = 0
            return None
        self.ok_streak = 0
        self.bad_streak += 1
        if self.active or self.bad_streak < cfg.hysteresis:
            return None
        if now < self.cooldown_until:
            return None
        self.active = True
        self.cooldown_until = now + cfg.cooldown_s
        self.triggers += 1
        return {"detector": cfg.name, "value": value, "median": med,
                "z": z}


class ThresholdDetector:
    """Fixed-threshold variant (serve burn rate: the threshold IS the
    alerting policy — 14x burn means the 30-day budget gone in ~2 days
    — so a learned baseline would be wrong). Same hysteresis/cooldown
    machinery; no warmup (burn is only computed once traffic flows)."""

    def __init__(self, name: str, threshold: float,
                 hysteresis: int = 3, cooldown_s: float = 120.0) -> None:
        self.name = name
        self.threshold = threshold
        self.hysteresis = max(1, hysteresis)
        self.cooldown_s = cooldown_s
        self.bad_streak = 0
        self.ok_streak = 0
        self.active = False
        self.cooldown_until = float("-inf")
        self.triggers = 0

    @property
    def state(self) -> str:
        return "active" if self.active else "ok"

    def reset(self) -> None:
        self.bad_streak = 0
        self.ok_streak = 0
        self.active = False

    def observe(self, value: float, now: float) -> Optional[Dict[str, Any]]:
        if value < self.threshold:
            self.bad_streak = 0
            if self.active:
                self.ok_streak += 1
                if self.ok_streak >= self.hysteresis:
                    self.active = False
                    self.ok_streak = 0
            return None
        self.ok_streak = 0
        self.bad_streak += 1
        if self.active or self.bad_streak < self.hysteresis:
            return None
        if now < self.cooldown_until:
            return None
        self.active = True
        self.cooldown_until = now + self.cooldown_s
        self.triggers += 1
        return {"detector": self.name, "value": value,
                "median": self.threshold, "z": None}


class ChurnDetector:
    """Elastic-round churn: more than `max_events` round transitions
    inside `window_s` is an anomaly (a healthy elastic job resizes
    occasionally; a flapping host resizes constantly). Event-driven —
    fed by the watcher on every observed round change."""

    def __init__(self, name: str = "elastic_churn", max_events: int = 3,
                 window_s: float = 600.0, cooldown_s: float = 600.0) -> None:
        self.name = name
        self.max_events = max(1, max_events)
        self.window_s = window_s
        self.cooldown_s = cooldown_s
        self.events: collections.deque = collections.deque()
        self.active = False
        self.cooldown_until = float("-inf")
        self.triggers = 0

    @property
    def state(self) -> str:
        return "active" if self.active else "ok"

    def reset(self) -> None:
        # Round changes are exactly what this detector counts — an
        # elastic reset must NOT clear it (unlike the baseline
        # detectors), or churn could never accumulate.
        pass

    def observe_event(self, now: float) -> Optional[Dict[str, Any]]:
        self.events.append(now)
        while self.events and now - self.events[0] > self.window_s:
            self.events.popleft()
        count = len(self.events)
        if count <= self.max_events:
            self.active = False
            return None
        if self.active or now < self.cooldown_until:
            return None
        self.active = True
        self.cooldown_until = now + self.cooldown_s
        self.triggers += 1
        return {"detector": self.name, "value": float(count),
                "median": float(self.max_events), "z": None}


# --------------------------------------------------- serve burn helpers

def over_slo_count(bounds: Sequence[float], bucket_deltas: Sequence[int],
                   slo_s: float) -> int:
    """Requests in a histogram-delta window that were slower than
    `slo_s`. Buckets whose upper bound is <= slo_s are within SLO; the
    straddling bucket counts as over (conservative toward alerting —
    the log2 ladder makes the error at most one bucket)."""
    total = sum(bucket_deltas)
    ok = sum(d for b, d in zip(bounds, bucket_deltas) if b <= slo_s)
    return max(total - ok, 0)


def burn_rate(bad: float, total: float, budget: float) -> float:
    """SRE burn rate: the fraction of the error budget consumed per
    unit of budget — `(bad/total) / budget`. 1.0 means exactly on
    budget; 14 means the 30-day budget gone in ~2 days (the classic
    fast-burn page threshold). 0 when there was no traffic."""
    if total <= 0 or budget <= 0:
        return 0.0
    return (bad / total) / budget


# -------------------------------------------------------------- watcher

def _identity() -> Dict[str, Any]:
    rank = size = None
    try:
        from horovod_tpu_torch.core import topology
        rank = topology.rank_or_none()
        st = topology.raw_state()
        size = st.size if st.initialized else None
    except Exception:
        pass
    if rank is None:
        v = os.environ.get("HOROVOD_RANK", "")
        rank = int(v) if v.strip().isdigit() else None
    if size is None:
        v = os.environ.get("HOROVOD_SIZE", "")
        size = int(v) if v.strip().isdigit() else None
    v = os.environ.get("HOROVOD_ELASTIC_ROUND", "")
    return {"rank": rank, "size": size,
            "round": int(v) if v.strip().isdigit() else 0,
            "hostname": os.environ.get("HOROVOD_HOSTNAME", ""),
            "pid": os.getpid()}


class Watcher:
    """Per-rank anomaly watcher (see module docstring).

    `clock` (monotonic) is injectable for fake-clock tests, as are the
    KV client factory and the capture/dump hooks — the unit suite
    exercises every detector and the full escalation path without
    sleeping or touching the network.
    """

    def __init__(self,
                 clock: Optional[Callable[[], float]] = None,
                 kv_factory: Optional[Callable[[], object]] = None,
                 capture_fn: Optional[Callable[..., bool]] = None,
                 dump_fn: Optional[Callable[[str], Any]] = None,
                 webhook_fn: Optional[Callable[[str, dict], None]] = None
                 ) -> None:
        self._clock = clock or time.monotonic
        self._kv_factory = kv_factory
        self._capture_fn = capture_fn
        self._dump_fn = dump_fn
        self._webhook_fn = webhook_fn
        warmup = _env_int(WATCH_WARMUP_ENV, 20)
        z = _env_float(WATCH_Z_ENV, 8.0)
        hyst = _env_int(WATCH_HYSTERESIS_ENV, 3)
        cool = _env_float(WATCH_COOLDOWN_ENV, 120.0)
        window = _env_int(WATCH_WINDOW_ENV, 64)
        step_delta = _env_float(WATCH_MIN_STEP_DELTA_ENV, 0.1)

        def mk(name, **kw):
            base = dict(warmup=warmup, z=z, hysteresis=hyst,
                        cooldown_s=cool, window=window)
            base.update(kw)
            return Detector(DetectorConfig(name, **base))

        self._lock = threading.Lock()
        # Baseline detectors, fed under _lock from tick().
        self._detectors: Dict[str, Any] = {  # guarded-by: _lock
            "step_time": mk("step_time", direction=1,
                            min_delta=step_delta),
            "input_wait": mk("input_wait", direction=1,
                             min_delta=step_delta),
            "mfu": mk("mfu", direction=-1, min_delta=0.05),
            "overlap": mk("overlap", direction=-1, min_delta=0.1),
            "queue_depth": mk("queue_depth", direction=1, min_delta=4.0),
            "serve_burn": ThresholdDetector(
                "serve_burn", _env_float(WATCH_BURN_RATE_ENV, 14.0),
                hysteresis=hyst, cooldown_s=cool),
            "elastic_churn": ChurnDetector(
                max_events=_env_int(WATCH_CHURN_ROUNDS_ENV, 3),
                window_s=_env_float(WATCH_CHURN_WINDOW_ENV, 600.0),
                cooldown_s=cool),
            # Sustained checkpoint back-pressure: the async writer
            # (ckpt/async_ckpt.py) skips-and-counts saves while busy —
            # skipping EVERY tick means the persist tier can't keep up
            # and checkpoint freshness (the preemption recovery point)
            # is silently aging.
            "ckpt_skipped": ThresholdDetector(
                "ckpt_skipped",
                _env_float(WATCH_CKPT_SKIPPED_ENV, 0.5),
                hysteresis=hyst, cooldown_s=cool),
        }
        self._records: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._counts: Dict[str, int] = {}  # guarded-by: _lock
        self._last_step = 0  # guarded-by: _lock
        self._last_round: Optional[int] = None  # guarded-by: _lock
        self._serve_prev: Optional[Dict[str, Any]] = None  # guarded-by: _lock
        self._ckpt_skipped_prev: Optional[float] = None  # guarded-by: _lock
        self.slo_s = _env_float(WATCH_SERVE_SLO_MS_ENV, 1000.0) / 1e3
        self.budget = _env_float(WATCH_SERVE_BUDGET_ENV, 0.01)
        self._kv = None
        self._kv_dead = False
        # Rank-0 aggregation state (only the aggregation pass touches
        # these, still under _lock for the bench-thread/exporter race).
        self._agg_interval = _env_float(WATCH_AGGREGATE_ENV, 10.0)
        self._agg_next = 0.0  # guarded-by: _lock
        self._agg_seen: set = set()  # guarded-by: _lock

    # ---------------------------------------------------------- signals
    def _serve_snapshot(self) -> Optional[Dict[str, Any]]:
        """Raw serve-SLO inputs from the registry, None when the
        process serves no traffic (the families were never created —
        peeking must not create them)."""
        from horovod_tpu_torch.observability import metrics as m
        reg = m.registry()
        hist = reg.peek("horovod_serve_request_seconds")
        if hist is None:
            return None
        series = hist.snapshot_series()
        if not series:
            return None
        s = series[0]
        failed = 0.0
        req = reg.peek("horovod_serve_requests_total")
        if req is not None:
            for rs in req.snapshot_series():
                if rs.get("labels") == ["failed"]:
                    failed = float(rs["value"])
        return {"bounds": list(hist.buckets or ()),
                "buckets": list(s.get("buckets", [])),
                "count": int(s.get("count", 0)),
                "failed": failed}

    def _serve_burn_sample(self) -> Optional[float]:
        cur = self._serve_snapshot()
        if cur is None:
            return None
        prev, self._serve_prev = self._serve_prev, cur  # hvdlint: disable=HVD101 -- _serve_burn_sample is only called from tick() inside the `with self._lock` critical section
        if prev is None:
            return None
        deltas = [max(c - p, 0) for c, p in
                  zip(cur["buckets"], prev["buckets"])]
        total = max(cur["count"] - prev["count"], 0)
        if total <= 0:
            return None
        bad = over_slo_count(cur["bounds"], deltas, self.slo_s) \
            + max(cur["failed"] - prev["failed"], 0.0)
        return burn_rate(min(bad, total), total, self.budget)

    @staticmethod
    def _gauge_value(name: str) -> Optional[float]:
        from horovod_tpu_torch.observability import metrics as m
        fam = m.registry().peek(name)
        if fam is None:
            return None
        try:
            return float(fam.value)
        except Exception:
            return None

    # ------------------------------------------------------------- tick
    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One detection pass (exporter cadence; also called by bench
        at section boundaries). Returns the anomalies triggered by this
        pass — side effects (capture escalation, KV push, alert sink)
        have already run by the time it returns."""
        now = self._clock() if now is None else now
        from horovod_tpu_torch.profiler import perfscope
        scope = perfscope.get()
        ident = _identity()
        triggered: List[Dict[str, Any]] = []
        with self._lock:
            det = self._detectors
            # Elastic round adoption: reset baselines (rank assignment
            # and perf regime changed), count the transition as churn.
            rnd = ident["round"]
            if self._last_round is not None and rnd != self._last_round:
                self._last_round = rnd
                for d in det.values():
                    d.reset()
                self._last_step = scope.step_count()
                a = det["elastic_churn"].observe_event(now)
                if a:
                    triggered.append(a)
            else:
                self._last_round = rnd
                # Per-step samples since the last tick.
                total, samples = scope.recent_samples(self._last_step)
                self._last_step = total
                for wall, phases in samples:
                    local = wall - sum(
                        v for k, v in phases.items()
                        if k in perfscope.WAIT_PHASES)
                    a = det["step_time"].observe(local, now)
                    if a:
                        triggered.append(a)
                    a = det["input_wait"].observe(
                        phases.get("input_wait", 0.0), now)
                    if a:
                        triggered.append(a)
                # Gauge-backed signals, one sample per tick.
                for key, gauge, skip_zero in (
                        ("mfu", "horovod_mfu", True),
                        ("overlap", "horovod_overlap_fraction", True),
                        ("queue_depth", "horovod_serve_queue_depth",
                         False)):
                    v = self._gauge_value(gauge)
                    if v is None or (skip_zero and v <= 0.0):
                        continue
                    a = det[key].observe(v, now)
                    if a:
                        triggered.append(a)
                burn = self._serve_burn_sample()
                if burn is not None:
                    self._set_burn_gauge(burn)
                    a = det["serve_burn"].observe(burn, now)
                    if a:
                        triggered.append(a)
                # Checkpoint back-pressure: per-tick delta of the
                # writer's skip counter (ckpt/async_ckpt.py).
                skipped = self._gauge_value("horovod_ckpt_skipped_total")
                if skipped is not None:
                    prev = self._ckpt_skipped_prev
                    self._ckpt_skipped_prev = skipped
                    if prev is not None:
                        a = det["ckpt_skipped"].observe(
                            max(0.0, skipped - prev), now)
                        if a:
                            triggered.append(a)
            step = scope.step_count()
            for a in triggered:
                a.update({"rank": ident["rank"], "round": rnd,
                          "step": step, "wall_time": time.time(),
                          "active": True})
                self._records.append(a)
                self._counts[a["detector"]] = \
                    self._counts.get(a["detector"], 0) + 1
            del self._records[:-MAX_RECORDS]
            any_records = bool(self._records)
        # Everything slow — file IO, KV, webhook — runs outside the
        # lock (HVD103) on the ticking thread.
        for a in triggered:
            self._escalate(a)
        if any_records:
            self.push_record()
        self._aggregate(now, ident)
        return triggered

    def _set_burn_gauge(self, burn: float) -> None:
        from horovod_tpu_torch.observability import metrics as m
        try:
            m.registry().gauge(
                "horovod_serve_slo_burn_rate",
                "SLO error-budget burn rate over the last watch tick "
                "(1.0 = exactly on budget; hvdwatch alerts at "
                "HOROVOD_WATCH_BURN_RATE)").set(burn)
        except Exception:
            pass

    # -------------------------------------------------------- escalation
    @staticmethod
    def watch_dir() -> str:
        return os.environ.get(WATCH_DIR_ENV, "") \
            or os.environ.get("HOROVOD_FLIGHT_DIR", "")

    def _escalate(self, anomaly: Dict[str, Any]) -> None:
        """Deep-capture escalation for one triggered anomaly. Never
        raises: the watcher rides the exporter thread."""
        name = anomaly["detector"]
        _anomaly_counter().labels(detector=name).inc()
        desc = (f"detector={name} rank={anomaly.get('rank')} "
                f"round={anomaly.get('round')} step={anomaly.get('step')} "
                f"value={anomaly.get('value'):.6g} "
                f"median={anomaly.get('median'):.6g}"
                + (f" z={anomaly['z']:.1f}"
                   if anomaly.get("z") is not None else ""))
        try:
            from horovod_tpu_torch.observability import flight
            flight.record("anomaly", desc)
            if self._dump_fn is not None:
                self._dump_fn(f"anomaly:{name}")
            else:
                flight.dump(f"anomaly:{name}")
        except Exception:
            pass
        self._start_capture(anomaly)
        try:
            from horovod_tpu_torch.common.hvd_logging import get_logger
            get_logger().warning("hvdwatch ANOMALY %s", desc)
        except Exception:
            pass

    def _start_capture(self, anomaly: Dict[str, Any]) -> None:
        if not _env_on(WATCH_CAPTURE_ENV, True):
            return
        d = self.watch_dir()
        if not d:
            return
        out = os.path.join(
            d, "devtrace-rank{}.r{}-{}-s{}".format(
                anomaly.get("rank"), anomaly.get("round"),
                anomaly["detector"], anomaly.get("step")))
        try:
            from horovod_tpu_torch.profiler import device_profile, perfscope
            fn = self._capture_fn \
                or device_profile.start_on_demand_capture
            fn(out,
               steps=_env_int(WATCH_CAPTURE_STEPS_ENV, 8),
               step_count_fn=perfscope.get().step_count,
               timeout_s=_env_float(WATCH_CAPTURE_SECONDS_ENV, 30.0))
        except Exception:
            pass

    # ---------------------------------------------------------- KV push
    def _kv_client(self):
        if self._kv is None and not self._kv_dead:
            try:
                if self._kv_factory is not None:
                    self._kv = self._kv_factory()
                    return self._kv
                from horovod_tpu_torch.common import config as C
                from horovod_tpu_torch.common.resilience import RetryPolicy
                from horovod_tpu_torch.runner.rendezvous import KVClient
                addr = os.environ.get(C.HOROVOD_RENDEZVOUS_ADDR, "")
                port = os.environ.get(C.HOROVOD_RENDEZVOUS_PORT, "")
                if not addr or not port:
                    self._kv_dead = True
                    return None
                # Telemetry budget: one attempt, 2s transport cap.
                self._kv = KVClient(addr, int(port),
                                    retry_policy=RetryPolicy(max_attempts=1),
                                    request_timeout=2.0)
            except Exception:
                self._kv_dead = True
        return self._kv

    def kv_payload(self) -> Optional[Dict[str, Any]]:
        body = _identity()
        if body["rank"] is None:
            return None  # mid-reset: an unkeyable record would linger
        with self._lock:
            if not self._records:
                return None
            body.update({
                "watch": WATCH_VERSION,
                "wall_time": time.time(),
                "anomalies": list(self._records),
                "counts": dict(self._counts),
                "active": sorted(n for n, d in self._detectors.items()
                                 if d.active),
            })
        return body

    def push_record(self) -> bool:
        """Best-effort KV push of this rank's anomaly record, keyed by
        (rank, round) like flight tails — elastic resets reuse rank
        numbers, and a survivor's next-round record must not clobber a
        dead rank's evidence."""
        body = self.kv_payload()
        if body is None:
            return False
        kv = self._kv_client()
        if kv is None:
            return False
        try:
            kv.put(SCOPE, f"rank-{body['rank']}.r{body['round']}",
                   json.dumps(body).encode("utf-8"))
            return True
        except Exception:
            return False

    # ----------------------------------------------------- rank-0 sink
    def _aggregate(self, now: float, ident: Dict[str, Any]) -> None:
        """Rank 0: probe peers' `watch/` records and feed every unseen
        anomaly to the alert sink (log + webhook). Local anomalies flow
        through the same dedupe, so single-process jobs alert too."""
        if ident["rank"] not in (0, None):
            return
        with self._lock:
            if now < self._agg_next:
                return
            self._agg_next = now + max(self._agg_interval, 0.5)
            local = list(self._records)
        fresh: List[Dict[str, Any]] = list(local)
        size = ident.get("size")
        kv = self._kv_client() if (size or 0) > 1 else None
        if kv is not None:
            for r in range(size):
                if r == ident["rank"]:
                    continue
                try:
                    raw = kv.get(SCOPE, f"rank-{r}.r{ident['round']}",
                                 timeout=0.0)
                except Exception:
                    break  # KV down: next aggregation pass retries
                if raw is None:
                    continue
                try:
                    body = json.loads(raw.decode("utf-8"))
                except ValueError:
                    continue
                fresh.extend(body.get("anomalies") or [])
        for a in fresh:
            key = (a.get("rank"), a.get("round"), a.get("detector"),
                   a.get("step"))
            with self._lock:
                if key in self._agg_seen:
                    continue
                self._agg_seen.add(key)
            self._sink(a)

    def _sink(self, anomaly: Dict[str, Any]) -> None:
        line = ("hvdwatch ALERT rank={rank} round={round} "
                "detector={detector} value={value:.6g} step={step}"
                .format(**{k: anomaly.get(k) for k in
                           ("rank", "round", "detector", "value",
                            "step")}))
        try:
            from horovod_tpu_torch.common.hvd_logging import get_logger
            get_logger().error(line)
        except Exception:
            pass
        url = os.environ.get(WATCH_WEBHOOK_ENV, "")
        if not url:
            return
        try:
            if self._webhook_fn is not None:
                self._webhook_fn(url, anomaly)
            else:
                import urllib.request
                req = urllib.request.Request(
                    url, data=json.dumps(anomaly).encode("utf-8"),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                urllib.request.urlopen(req, timeout=2.0).read()
        except Exception:
            pass  # the webhook is best-effort; the log line landed

    # ------------------------------------------------------- inspection
    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def active(self) -> List[str]:
        with self._lock:
            return sorted(n for n, d in self._detectors.items()
                          if d.active)

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def detector(self, name: str):
        """Test/diagnostic access to one detector's state machine."""
        with self._lock:
            return self._detectors[name]


class _NoopWatcher:
    """HOROVOD_WATCH=0 shell: every hook is a cheap no-op."""

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        return []

    def push_record(self) -> bool:
        return False

    def kv_payload(self) -> Optional[Dict[str, Any]]:
        return None

    def counts(self) -> Dict[str, int]:
        return {}

    def active(self) -> List[str]:
        return []

    def records(self) -> List[Dict[str, Any]]:
        return []


NOOP = _NoopWatcher()

_mx_cache = None


def _anomaly_counter():
    global _mx_cache
    from horovod_tpu_torch.observability import metrics as m
    reg = m.registry()
    if _mx_cache is None or _mx_cache[0] is not reg:
        fam = reg.counter(
            "hvdwatch_anomalies_total",
            "Anomalies detected by hvdwatch (observability/watch.py)",
            labelnames=("detector",))
        _mx_cache = (reg, fam)
    return _mx_cache[1]


_watcher: Optional[object] = None
_watcher_lock = threading.Lock()


def enabled() -> bool:
    return _env_on(WATCH_ENV, True)


def get():
    """The process-wide watcher (NOOP shell under HOROVOD_WATCH=0)."""
    global _watcher
    w = _watcher
    if w is not None:
        return w
    with _watcher_lock:
        if _watcher is None:
            _watcher = Watcher() if enabled() else NOOP
        return _watcher


def on_export_tick() -> None:
    """Exporter-cadence hook (observability/export.py). Never raises."""
    try:
        get().tick()
    except Exception:
        pass


def reset_for_tests() -> None:
    """Drop the process-wide watcher so the next get() re-reads env."""
    global _watcher, _mx_cache
    with _watcher_lock:
        _watcher = None
        _mx_cache = None


def persist_kv_records(store, out_dir: Optional[str] = None) -> List[str]:
    """Launcher-side: write every pushed ``watch/`` record the
    rendezvous server holds to `out_dir` (default: HOROVOD_WATCH_DIR,
    then HOROVOD_FLIGHT_DIR — next to the flight tails) as
    ``watch-rank-<r>.r<round>.json``, so hvddoctor's [anomalies]
    section works offline — including for workers that died without a
    clean exit."""
    if out_dir is None:
        out_dir = os.environ.get(WATCH_DIR_ENV, "") \
            or os.environ.get("HOROVOD_FLIGHT_DIR", "")
    if not out_dir:
        return []
    try:
        items = store.scope_items(SCOPE)
    except Exception:
        return []
    written: List[str] = []
    for key, raw in sorted(items.items()):
        safe = key.replace("/", "_")
        path = os.path.join(out_dir, f"watch-{safe}.json")
        try:
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(raw)
            os.replace(tmp, path)
            written.append(path)
        except OSError:
            continue
    return written
