"""Process-local metrics registry: Counter, Gauge, Histogram (counterpart
of horovod_tpu/observability/metrics.py).

Every layer of the runtime (collectives, the optimizer's buckets, the
tuners, perfscope, elastic, checkpointing, resilience, the rendezvous
KV) counts what it does into one process-local registry, and the export
paths fan the numbers out (observability/export.py): a Prometheus
`/metrics` route on the rendezvous server, periodic JSON snapshots, and
`"ph":"C"` counter tracks on the timeline.

* Lock-cheap hot path. A bound series (`family.labels(...)`) is resolved
  once and cached by the call site; recording is then one short lock
  around a float add. Histograms bisect a precomputed bound tuple.
* No-op shell when disabled. With `HOROVOD_METRICS=0` every factory
  returns the shared `NOOP` object whose methods do nothing; call sites
  that compute inputs branch on `registry().enabled` once instead.
* Bounded label cardinality. Each family folds series beyond
  `HOROVOD_METRICS_LABEL_MAX` into one `other` series.
* Rendering is pull-shaped: `snapshot()` is a plain-JSON dict (what
  workers push to the launcher through the rendezvous KV) and
  `render_snapshots()` merges any number of them into Prometheus text
  with a `rank` label per series, byte for byte as the JAX package's.
"""

from __future__ import annotations

import json
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.common.config import _env_bool, _env_int

HOROVOD_METRICS = "HOROVOD_METRICS"
HOROVOD_METRICS_LABEL_MAX = "HOROVOD_METRICS_LABEL_MAX"
HOROVOD_METRICS_STALE_SECONDS = "HOROVOD_METRICS_STALE_SECONDS"

#: Default staleness cutoff for pushed rank snapshots in the job-wide
#: `/metrics` merge, as a multiple of the exporter push interval: a rank
#: that missed ~3 pushes is gone (evicted, crashed, SIGKILL'd), and its
#: frozen series must age out of the scrape rather than render forever.
STALE_PUSH_INTERVALS = 3.0

# Fixed log-scale bucket ladders (powers of two). Fixed — not
# configurable per call site — so per-rank histograms merge bucket-by-
# bucket in render_snapshots without resampling.
TIME_BUCKETS: Tuple[float, ...] = tuple(2.0 ** e for e in range(-20, 7))
#   ~1 us .. 64 s
SIZE_BUCKETS: Tuple[float, ...] = tuple(float(2 ** e)
                                        for e in range(0, 32, 2))
#   1 B .. 2 GiB
COUNT_BUCKETS: Tuple[float, ...] = tuple(float(2 ** e) for e in range(0, 13))
#   1 .. 4096 items


class _Noop:
    """Shared do-nothing metric: what every factory returns when the
    registry is disabled. Accepts the full Counter/Gauge/Histogram
    surface so instrumented code needs no branches."""

    __slots__ = ()

    def labels(self, **_kw) -> "_Noop":
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0


NOOP = _Noop()


class _Series:
    """One (labelvalues) time series of a counter or gauge."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def observe(self, value: float) -> None:  # pragma: no cover - misuse
        raise TypeError("observe() is only valid on histograms")


class _HistSeries:
    """One (labelvalues) series of a histogram: counts per bucket + sum."""

    __slots__ = ("_lock", "bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1

    @property
    def value(self) -> float:
        return self.sum


_OTHER = "other"  # folded label value once a family hits its cap


class _Family:
    """A named metric with a fixed label schema and its live series."""

    def __init__(self, name: str, kind: str, help_: str,
                 labelnames: Tuple[str, ...], label_max: int,
                 buckets: Optional[Tuple[float, ...]] = None) -> None:
        self.name = name
        self.kind = kind
        self.help = help_
        self.labelnames = labelnames
        self.buckets = buckets
        self._label_max = label_max
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}  # guarded-by: _lock
        if not labelnames:
            self._default = self._new_series()
            self._series[()] = self._default
        else:
            self._default = None

    def _new_series(self):
        if self.kind == "histogram":
            return _HistSeries(self.buckets or TIME_BUCKETS)
        return _Series()

    def labels(self, **kw):
        key = tuple(str(kw.get(n, "")) for n in self.labelnames)
        # Lock-free fast path: dict.get on an existing key is atomic
        # under the GIL and series are never removed, so a hit can only
        # return a fully-constructed series; misses fall through to the
        # locked double-check below.
        s = self._series.get(key)  # hvdlint: disable=HVD101 -- racy read is benign: series are add-only and dict.get is atomic under the GIL
        if s is not None:
            return s
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self._label_max:
                    # Cardinality cap: all overflow keys share one series.
                    key = (_OTHER,) * len(self.labelnames)
                    s = self._series.get(key)
                    if s is None:
                        s = self._new_series()
                        self._series[key] = s
                else:
                    s = self._new_series()
                    self._series[key] = s
            return s

    # Label-less convenience: family acts as its own default series.
    def inc(self, amount: float = 1.0) -> None:
        (self._default or self.labels()).inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        (self._default or self.labels()).dec(amount)

    def set(self, value: float) -> None:
        (self._default or self.labels()).set(value)

    def observe(self, value: float) -> None:
        (self._default or self.labels()).observe(value)

    @property
    def value(self) -> float:
        return (self._default or self.labels()).value

    def snapshot_series(self) -> List[dict]:
        out = []
        with self._lock:
            items = list(self._series.items())
        for key, s in items:
            if isinstance(s, _HistSeries):
                with s._lock:
                    out.append({"labels": list(key), "sum": s.sum,
                                "count": s.count,
                                "buckets": list(s.counts)})
            else:
                out.append({"labels": list(key), "value": s.value})
        return out


class MetricsRegistry:
    """Thread-safe family table. One per process (see `registry()`);
    construct directly (enabled=False) to unit-test the no-op shell."""

    def __init__(self, enabled: bool = True,
                 label_max: Optional[int] = None) -> None:
        self.enabled = enabled
        self.label_max = label_max if label_max is not None \
            else _env_int(HOROVOD_METRICS_LABEL_MAX, 64)
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}  # guarded-by: _lock

    def _family(self, name: str, kind: str, help_: str,
                labelnames: Sequence[str],
                buckets: Optional[Sequence[float]] = None):
        if not self.enabled:
            return NOOP
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help_, tuple(labelnames),
                              self.label_max,
                              tuple(buckets) if buckets else None)
                self._families[name] = fam
            elif fam.kind != kind or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered as {kind}"
                    f"{tuple(labelnames)} but exists as {fam.kind}"
                    f"{fam.labelnames}")
            return fam

    def counter(self, name: str, help_: str = "",
                labelnames: Sequence[str] = ()):
        return self._family(name, "counter", help_, labelnames)

    def gauge(self, name: str, help_: str = "",
              labelnames: Sequence[str] = ()):
        return self._family(name, "gauge", help_, labelnames)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = TIME_BUCKETS):
        return self._family(name, "histogram", help_, labelnames, buckets)

    def peek(self, name: str) -> Optional[_Family]:
        """An existing family, or None — WITHOUT creating it. Readers
        that merely observe (the hvdwatch detectors sampling serve
        series) must not materialize families a process never emits."""
        if not self.enabled:
            return None
        with self._lock:
            return self._families.get(name)

    # ------------------------------------------------------------- export
    def snapshot(self, rank: Optional[int] = None) -> dict:
        """Plain-JSON state of every family — the KV-push / dump payload."""
        fams = {}
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            fams[fam.name] = {
                "kind": fam.kind, "help": fam.help,
                "labelnames": list(fam.labelnames),
                "bounds": list(fam.buckets or TIME_BUCKETS)
                if fam.kind == "histogram" else None,
                "series": fam.snapshot_series(),
            }
        return {"rank": rank, "time": time.time(), "families": fams}

    def render(self, rank: Optional[int] = None) -> str:
        return render_snapshots([self.snapshot(rank)])


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _labelstr(names: Sequence[str], values: Sequence[str],
              extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = [(n, v) for n, v in zip(names, values)] + list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{n}="{_esc(v)}"' for n, v in pairs) + "}"


def render_snapshots(snapshots: Sequence[dict]) -> str:
    """Merge snapshots (one per rank/process) into Prometheus text
    (exposition format 0.0.4). Each series gains a `rank` label when its
    snapshot carries a rank, so one scrape shows the whole job."""
    merged: Dict[str, dict] = {}
    rows: Dict[str, List[str]] = {}
    for snap in snapshots:
        rank = snap.get("rank")
        extra = [("rank", str(rank))] if rank is not None else []
        for name, fam in sorted(snap.get("families", {}).items()):
            if name not in merged:
                merged[name] = fam
                rows[name] = []
            kind = fam["kind"]
            names = fam.get("labelnames", [])
            for s in fam.get("series", []):
                ls = s.get("labels", [])
                if kind == "histogram":
                    bounds = fam.get("bounds") or []
                    cum = 0
                    for b, c in zip(bounds, s.get("buckets", [])):
                        cum += c
                        lab = _labelstr(names, ls,
                                        extra + [("le", _fmt(b))])
                        rows[name].append(f"{name}_bucket{lab} {cum}")
                    lab = _labelstr(names, ls, extra + [("le", "+Inf")])
                    rows[name].append(f"{name}_bucket{lab} {s['count']}")
                    lab = _labelstr(names, ls, extra)
                    rows[name].append(f"{name}_sum{lab} {_fmt(s['sum'])}")
                    rows[name].append(f"{name}_count{lab} {s['count']}")
                else:
                    lab = _labelstr(names, ls, extra)
                    rows[name].append(f"{name}{lab} {_fmt(s['value'])}")
    out: List[str] = []
    for name in sorted(merged):
        fam = merged[name]
        if fam.get("help"):
            out.append(f"# HELP {name} {fam['help']}")
        out.append(f"# TYPE {name} {fam['kind']}")
        out.extend(rows[name])
    return "\n".join(out) + ("\n" if out else "")


def stale_cutoff_seconds() -> float:
    """Age (seconds) beyond which a pushed rank snapshot is dropped from
    the `/metrics` merge. `HOROVOD_METRICS_STALE_SECONDS` overrides; 0
    disables aging. Default: 3 exporter push intervals — dead/evicted
    ranks otherwise persist in the job-wide scrape forever."""
    from horovod_tpu_torch.common.config import (
        HOROVOD_METRICS_PUSH_INTERVAL, _env_float)
    explicit = _env_float(HOROVOD_METRICS_STALE_SECONDS, -1.0)
    if explicit >= 0.0:
        return explicit
    return STALE_PUSH_INTERVALS * max(
        _env_float(HOROVOD_METRICS_PUSH_INTERVAL, 5.0), 0.1)


def fresh_snapshots(snapshots: Sequence[dict],
                    stale_seconds: Optional[float] = None,
                    now: Optional[float] = None) -> List[dict]:
    """Drop pushed snapshots whose `time` stamp is older than
    `stale_seconds` (wall clock; `now` injectable for tests). Snapshots
    without a stamp are kept — aging must fail open, never hide live
    data. `stale_seconds <= 0` disables aging."""
    if stale_seconds is None:
        stale_seconds = stale_cutoff_seconds()
    if stale_seconds <= 0.0:
        return list(snapshots)
    now = time.time() if now is None else now
    out: List[dict] = []
    for snap in snapshots:
        t = snap.get("time")
        if isinstance(t, (int, float)) and now - t > stale_seconds:
            continue
        out.append(snap)
    return out


def parse_snapshot(data: bytes) -> Optional[dict]:
    """Decode a pushed snapshot; None on garbage (a scrape must never 500
    because one worker pushed a truncated payload)."""
    try:
        snap = json.loads(data.decode("utf-8"))
        return snap if isinstance(snap, dict) else None
    except (ValueError, UnicodeDecodeError):
        return None


# ---------------------------------------------------------------- process
_registry: Optional[MetricsRegistry] = None  # guarded-by: _registry_lock
_registry_lock = threading.Lock()


def registry() -> MetricsRegistry:
    """The process-local registry, created on first use. Enabled unless
    HOROVOD_METRICS=0 (metrics are on by default: the registry costs ~ns
    per event and the export paths all gate separately)."""
    global _registry
    reg = _registry  # hvdlint: disable=HVD101 -- double-checked locking: unlocked read either sees None (slow path re-checks under lock) or the final value
    if reg is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry(
                    enabled=_env_bool(HOROVOD_METRICS, True))
            reg = _registry
    return reg


def enabled() -> bool:
    return registry().enabled


def reset_for_tests() -> None:
    """Drop the process registry so the next `registry()` re-reads env.
    Call-site caches keyed on registry identity refresh automatically."""
    global _registry
    with _registry_lock:
        _registry = None
