"""Metrics fan-out (counterpart of horovod_tpu/observability/export.py).

`MetricsExporter` is a background thread, started by `hvd.init()` where
there is a sink to feed, that on the HOROVOD_METRICS_PUSH_INTERVAL
cadence:
* pushes this rank's registry snapshot into the rendezvous KV as
  `metrics/rank-<r>`, which the launcher's `GET /metrics` route merges
  into one Prometheus page for the whole job;
* writes a JSON snapshot to HOROVOD_METRICS_DUMP (a `{rank}` in the path
  is the rank) every HOROVOD_METRICS_DUMP_INTERVAL seconds;
* emits the counters and gauges as `"ph":"C"` tracks on the live
  timeline;
* refreshes this rank's flight-recorder tail and trace-span tail in the
  KV, so a SIGKILL'd worker still leaves them with the launcher (the
  perfscope summary pushes itself at step boundaries on the same
  interval, profiler/perfscope.py);
* runs one hvdwatch detection pass (observability/watch.py).
`hvd.shutdown()` stops it with one final forced flush.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Callable, Optional

from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.observability import metrics as metrics_mod

SCOPE = "metrics"  # rendezvous KV scope for pushed snapshots


class MetricsExporter:
    """Background fan-out thread. `rank_fn`/`timeline_fn` are lazy so the
    exporter can start before topology init has settled; `kv_factory` is
    injectable for tests."""

    def __init__(self, cfg: Config,
                 rank_fn: Callable[[], Optional[int]],
                 timeline_fn: Callable[[], object],
                 kv_factory: Optional[Callable[[], object]] = None) -> None:
        self.cfg = cfg
        self.rank_fn = rank_fn
        self.timeline_fn = timeline_fn
        self._kv_factory = kv_factory
        self._kv = None
        self._kv_dead = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_dump = 0.0
        self._next_push = 0.0
        reg = metrics_mod.registry()
        self._push_failures = reg.counter(
            "horovod_metrics_push_failures_total",
            "Snapshot pushes to the rendezvous KV that failed")

    # ---------------------------------------------------------------- kv
    def _kv_client(self):
        if self._kv is None and not self._kv_dead:
            try:
                if self._kv_factory is not None:
                    self._kv = self._kv_factory()
                elif self.cfg.rendezvous_addr:
                    from horovod_tpu_torch.common import resilience
                    from horovod_tpu_torch.runner.rendezvous import KVClient
                    # Telemetry gets a SHORT budget on BOTH axes — the
                    # retry deadline AND the per-request socket timeout
                    # (a blackholed connect otherwise blocks ~30s on its
                    # first attempt): a push that can't land in ~2s is
                    # dropped, the next tick supersedes it. Never seconds
                    # of blocking inside a shutdown flush.
                    self._kv = KVClient(
                        self.cfg.rendezvous_addr,
                        self.cfg.rendezvous_port,
                        retry_policy=resilience.kv_retry_policy(
                            max_attempts=2, deadline=2.0),
                        request_timeout=2.0)
                else:
                    self._kv_dead = True
            except Exception:
                self._kv_dead = True
        return self._kv

    # -------------------------------------------------------------- sinks
    def _dump(self, snap: dict) -> None:
        path = self.cfg.metrics_dump
        if "{rank}" in path:
            path = path.format(rank=snap.get("rank") or 0)
        tmp = path + ".tmp"
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(snap, f)
            os.replace(tmp, path)
        except OSError:
            pass

    def _push(self, snap: dict) -> None:
        kv = self._kv_client()
        if kv is None:
            return
        rank = snap.get("rank")
        if rank is None:
            # Mid-reset (topology torn down): a push keyed by anything but
            # rank would linger forever and render WITHOUT a rank label —
            # co-hosted workers would then publish duplicate series and
            # poison every later scrape. Skip; the next tick supersedes.
            return
        try:
            kv.put(SCOPE, f"rank-{rank}", json.dumps(snap).encode())
        except Exception:
            self._push_failures.inc()

    def _timeline_counters(self, snap: dict) -> None:
        tl = self.timeline_fn()
        if tl is None or not getattr(tl, "counter", None):
            return
        for name, fam in snap.get("families", {}).items():
            if fam["kind"] not in ("counter", "gauge"):
                continue
            values = {}
            for s in fam.get("series", []):
                series = ",".join(s["labels"]) or "value"
                values[series] = s["value"]
            if values:
                try:
                    tl.counter(name, values)
                except Exception:
                    return  # timeline shut down mid-tick

    def tick(self, now: Optional[float] = None, force: bool = False) -> None:
        """One export pass (public for tests and the final shutdown
        flush). `force` ignores the per-sink schedules."""
        now = time.monotonic() if now is None else now
        reg = metrics_mod.registry()
        if not reg.enabled:
            return
        snap = None
        if self.cfg.metrics_dump and (force or now >= self._next_dump):
            self._next_dump = now + max(self.cfg.metrics_dump_interval, 0.1)
            snap = reg.snapshot(self.rank_fn())
            self._dump(snap)
        if force or now >= self._next_push:
            self._next_push = now + max(self.cfg.metrics_push_interval, 0.1)
            snap = snap or reg.snapshot(self.rank_fn())
            self._push(snap)
            self._timeline_counters(snap)
            # Refresh this rank's flight-recorder KV tail on the same
            # cadence (observability/flight.py): it is what survives in
            # the launcher if this worker is SIGKILL'd before any dump
            # trigger fires. Best-effort like every other sink.
            try:
                from horovod_tpu_torch.observability import flight
                flight.push_tail()
            except Exception:
                pass
            # Same cadence for the hvdtrace span tail
            # (observability/tracing.py): the launcher persists the
            # trace/ scope at job end so the doctor can join a
            # SIGKILL'd worker's fragments offline.
            try:
                from horovod_tpu_torch.observability import tracing
                tracing.push_tail()
            except Exception:
                pass
            # hvdwatch detection pass (observability/watch.py): the
            # detectors read the perfscope samples and registry series
            # since the last tick, escalate capture on a trigger, and
            # refresh this rank's `watch/` KV record.
            try:
                from horovod_tpu_torch.observability import watch
                watch.on_export_tick()
            except Exception:
                pass

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="hvd-metrics-export",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        period = max(min(self.cfg.metrics_push_interval,
                         self.cfg.metrics_dump_interval
                         if self.cfg.metrics_dump else 1e9) / 2.0, 0.1)
        while not self._stop.wait(period):
            try:
                self.tick()
            except Exception:
                pass

    def stop(self, final_flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if final_flush:
            try:
                self.tick(force=True)
            except Exception:
                pass


_exporter: Optional[MetricsExporter] = None
_exporter_lock = threading.Lock()


def start_exporter(cfg: Config) -> Optional[MetricsExporter]:
    """Idempotent process-wide exporter start (called from hvd.init();
    elastic in-process re-inits reuse the running thread). Starts only
    when there is a sink to feed: a dump path, a rendezvous to push to,
    or a live timeline for counter tracks."""
    global _exporter
    if not (cfg.metrics_enabled and metrics_mod.registry().enabled):
        return None
    with _exporter_lock:
        if _exporter is not None:
            return _exporter
        from horovod_tpu_torch.core import topology

        def rank_fn() -> Optional[int]:
            return topology.rank_or_none()

        def timeline_fn():
            return topology.timeline()

        if not (cfg.metrics_dump or cfg.rendezvous_addr
                or cfg.timeline_path):
            return None
        _exporter = MetricsExporter(cfg, rank_fn, timeline_fn)
        _exporter.start()
        # Interpreter-exit flush: a short-lived or crashing job that
        # never reaches hvd.shutdown() (or whose init failed after the
        # exporter started — topology's atexit shutdown() returns early
        # then) still leaves one final snapshot/KV push behind.
        # stop_exporter is idempotent, so the normal shutdown path and
        # this hook compose.
        atexit.register(stop_exporter)
        return _exporter


def stop_exporter() -> None:
    """Final flush + thread stop (called from hvd.shutdown())."""
    global _exporter
    with _exporter_lock:
        exp, _exporter = _exporter, None
    if exp is not None:
        exp.stop()
