"""`hvddoctor`: merge per-rank flight-recorder dumps into one story
(counterpart of horovod_tpu/observability/doctor.py: the same loaders,
analyses, report and rendering over the same record formats, which the
port's recorders write).

    python -m horovod_tpu_torch.observability.doctor --dir /path/to/flight
    python -m horovod_tpu_torch.observability.doctor --kv host:port
    python -m horovod_tpu_torch.observability.doctor --dir D --json
    python -m horovod_tpu_torch.observability.doctor --dir D --trace out.json

Inputs are the artifacts `observability/flight.py` leaves behind:

* `<rank>.json` — a rank's full atomic dump (stall watchdog raise,
  divergence, SIGUSR1, interpreter exit),
* `kv-tail-rank-<r>.r<round>.json` — the compact tail the launcher
  persisted from its rendezvous KV at job end (survives worker
  SIGKILL),
* a live rendezvous KV (`--kv`) — scraped directly while the job (or
  its launcher) is still up.

Elastic resets REUSE rank numbers, so everything is analyzed per
`(elastic round, process set)`: a dump is attributed to the rank its
process held *in that round* (the recorder tracks the mapping), and
per-set call indices restart each round — cross-rank alignment is only
meaningful within one. The merged report names, per round and process
set (headline: the world set):

* the **last collective every rank agreed on** (same op signature and
  name at the same per-set call index on every participating rank),
* the **first point of divergence** — either ranks issuing *different*
  collectives at one call index, or ranks that *stopped* while peers
  continued (the silent-staller shape),
* **stragglers / missing ranks**, each with its last-known event and
  (from full dumps) the blocked thread stacks,
* per-process event tails, and optionally a Perfetto-compatible trace
  (`--trace`) with one track per process.

When perfscope step-time summaries are present (`perf-rank-<r>.json`
files persisted by the launcher, or the live `perf/` KV scope — see
profiler/perfscope.py), the report gains a **perf section**: per-rank
mean/p95 step time with its phase breakdown, and straggler attribution
by *local* time (wall minus peer-wait phases — in a synchronous job
every rank's wall time matches; only the split names the culprit), each
straggler tagged with its dominant phase (`input_wait`, `dispatch`,
`optimizer`, ...).

When hvdwatch anomaly records are present
(`watch-rank-<r>.r<round>.json` files, or the live `watch/` KV scope —
observability/watch.py), the report gains an **[anomalies] section**:
every online detection with its detector, z-score and trigger step,
correlated against the report's own straggler/divergence evidence — an
anomalous rank that is also a perf or collective straggler in the same
round is marked *corroborated*.

The JAX package's cross-round perfboard trajectory (``--rounds``) reads
that package's bench rounds; here ``--rounds`` exits 2 until the port's
benchmark writes records of its own (ROADMAP A13).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from horovod_tpu_torch.observability.flight import DUMP_VERSION, SCOPE

#: process_set_id of the world set (core/process_sets.py registers it
#: first) — the headline group of every report.
WORLD_GROUP = 0


def group_key(round_id: int, gid: int) -> str:
    """JSON key for one (elastic round, process set) analysis."""
    return f"r{round_id}-ps{gid}"


class RankDump:
    """One process's parsed dump (full or KV tail)."""

    def __init__(self, body: Dict[str, Any], source: str,
                 tail_only: bool) -> None:
        self.body = body
        self.source = source          # file path or kv key
        self.tail_only = tail_only    # compact KV tail, not a full dump
        self.rank: Optional[int] = body.get("rank")
        self.size: Optional[int] = body.get("size")
        self.trigger: str = body.get("trigger", "?")
        self.events: List[list] = body.get("events", [])
        self.stacks: Dict[str, List[str]] = body.get("stacks", {}) or {}
        rnd = body.get("round")
        if rnd is None:
            v = str(body.get("elastic_round", "") or "")
            rnd = int(v) if v.isdigit() else 0
        self.round: int = int(rnd)
        self.rounds: Dict[str, Any] = body.get("rounds", {}) or {}

    # --------------------------------------------------------- identity
    def process_id(self) -> Tuple:
        """Stable identity of the emitting PROCESS — ranks are reused
        across elastic rounds, (hostname, pid) is not."""
        host = self.body.get("hostname") or ""
        pid = self.body.get("pid")
        if host or pid:
            return (host, pid)
        return (f"rank{self.rank}", None)

    def rank_for_round(self, round_id: int) -> Optional[int]:
        """The rank this process held in `round_id` (recorder-tracked;
        falls back to the dump-time rank)."""
        v = self.rounds.get(str(round_id), self.rank)
        return None if v is None else int(v)

    def ranks_seen(self) -> List[int]:
        out = {int(v) for v in self.rounds.values() if v is not None}
        if self.rank is not None:
            out.add(self.rank)
        return sorted(out)

    # ------------------------------------------------------------ views
    def collectives(self) -> Dict[Tuple[int, int],
                                  Dict[int, Tuple[str, str, float]]]:
        """{(round, group_id): {call_idx: (desc, name, wall_time)}}."""
        out: Dict[Tuple[int, int], Dict[int, Tuple[str, str, float]]] = {}
        for ev in self.events:
            if len(ev) >= 7 and ev[2] == "collective":
                rnd = int(ev[7]) if len(ev) >= 8 else self.round
                out.setdefault((rnd, int(ev[5])), {})[int(ev[6])] = \
                    (str(ev[3]), str(ev[4]), float(ev[1]))
        return out

    def last_event(self) -> Optional[list]:
        return self.events[-1] if self.events else None

    def tail(self, n: int) -> List[list]:
        return self.events[-n:]


def _parse_dump(raw: bytes, source: str, tail_only: bool
                ) -> Optional[RankDump]:
    try:
        body = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(body, dict) or "events" not in body:
        return None
    if body.get("version", DUMP_VERSION) > DUMP_VERSION:
        print(f"doctor: {source}: dump version {body.get('version')} is "
              f"newer than this tool understands; skipping",
              file=sys.stderr)
        return None
    return RankDump(body, source, tail_only)


# ----------------------------------------------------------------- load

def load_dir(d: str) -> List[RankDump]:
    dumps: List[RankDump] = []
    try:
        names = sorted(os.listdir(d))
    except OSError as e:
        print(f"doctor: cannot read --dir {d}: {e}", file=sys.stderr)
        return dumps
    for name in names:
        if not name.endswith(".json") or ".tmp" in name:
            continue
        path = os.path.join(d, name)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            continue
        dump = _parse_dump(raw, path, tail_only=name.startswith("kv-tail-"))
        if dump is not None:
            dumps.append(dump)
    return dumps


def _scan_kv(addr: str, port: int, scope: str, parse_fn,
             max_ranks: int = 256, max_rounds: int = 64) -> List:
    """Probe `<scope>/rank-<r>.r<round>` keys on a live rendezvous
    server (shared by the flight-tail and perf-summary scrapes).

    Rounds 0..current (read from the driver's `elastic/round` key when
    present) are probed per rank with a consecutive-miss cutoff; once
    any record reveals the job size, exactly that rank range is
    covered. `parse_fn(raw, source)` returns a parsed record (with an
    optional `size` attribute/key) or None."""
    from horovod_tpu_torch.common.resilience import RetryPolicy
    from horovod_tpu_torch.runner.rendezvous import KVClient
    kv = KVClient(addr, port, retry_policy=RetryPolicy(max_attempts=1),
                  request_timeout=5.0)
    top_round = 0
    try:
        raw = kv.get("elastic", "round", timeout=0.0)
        if raw:
            top_round = min(int(raw.decode()), max_rounds)
    except Exception:
        pass
    out: List = []
    known_size: Optional[int] = None
    for rnd in range(top_round + 1):
        misses = 0
        r = 0
        while r < max_ranks:
            if known_size is not None and r >= known_size:
                break
            try:
                raw = kv.get(scope, f"rank-{r}.r{rnd}", timeout=0.0)
            except Exception as e:
                print(f"doctor: KV scrape failed at rank {r}: {e}",
                      file=sys.stderr)
                return out
            if raw is None:
                misses += 1
                if known_size is None and misses >= 8:
                    break
            else:
                misses = 0
                rec = parse_fn(raw, f"kv:{scope}/rank-{r}.r{rnd}")
                if rec is not None:
                    out.append(rec)
                    size = rec.size if hasattr(rec, "size") \
                        else rec.get("size")
                    if size and known_size is None:
                        known_size = size
            r += 1
        known_size = None  # sizes differ per round
    return out


def load_kv(addr: str, port: int, max_ranks: int = 256,
            max_rounds: int = 64) -> List[RankDump]:
    """Scrape `flight/rank-<r>.r<round>` tails from a live rendezvous
    server."""
    return _scan_kv(
        addr, port, SCOPE,
        lambda raw, src: _parse_dump(raw, src, tail_only=True),
        max_ranks=max_ranks, max_rounds=max_rounds)


def load_perf_dir(d: str) -> List[Dict[str, Any]]:
    """Parse the perfscope summaries the launcher persisted
    (`perf-rank-<r>.r<round>.json`, profiler/perfscope.py)."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return out
    for name in names:
        if not name.startswith("perf-") or not name.endswith(".json") \
                or ".tmp" in name:
            continue
        try:
            with open(os.path.join(d, name), "rb") as f:
                raw = f.read()
        except OSError:
            continue
        rec = _parse_perf(raw, name)
        if rec is not None:
            out.append(rec)
    return out


def _parse_perf(raw: bytes, source: str) -> Optional[Dict[str, Any]]:
    try:
        body = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    if not (isinstance(body, dict) and body.get("perfscope")
            and body.get("summary")):
        return None
    from horovod_tpu_torch.profiler.perfscope import SUMMARY_VERSION
    try:
        version = int(body["perfscope"])
    except (TypeError, ValueError):
        version = SUMMARY_VERSION + 1
    if version > SUMMARY_VERSION:
        # Same contract as _parse_dump: a newer schema's field shapes
        # are unknown — skipping beats crashing the whole analysis or
        # electing stragglers from misread fields.
        print(f"doctor: {source}: perf summary version "
              f"{body.get('perfscope')} is newer than this tool "
              f"understands; skipping", file=sys.stderr)
        return None
    return body


def load_perf_kv(addr: str, port: int, max_ranks: int = 256,
                 max_rounds: int = 64) -> List[Dict[str, Any]]:
    """Scrape `perf/rank-<r>.r<round>` summaries from a live rendezvous
    server (same probing shape as the flight-tail scrape)."""
    from horovod_tpu_torch.profiler.perfscope import SCOPE as PERF_SCOPE
    return _scan_kv(addr, port, PERF_SCOPE, _parse_perf,
                    max_ranks=max_ranks, max_rounds=max_rounds)


def _parse_watch(raw: bytes, source: str) -> Optional[Dict[str, Any]]:
    try:
        body = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    if not (isinstance(body, dict) and body.get("watch")
            and isinstance(body.get("anomalies"), list)):
        return None
    from horovod_tpu_torch.observability.watch import WATCH_VERSION
    try:
        version = int(body["watch"])
    except (TypeError, ValueError):
        version = WATCH_VERSION + 1
    if version > WATCH_VERSION:
        print(f"doctor: {source}: watch record version "
              f"{body.get('watch')} is newer than this tool "
              f"understands; skipping", file=sys.stderr)
        return None
    # Sanitize at the boundary (the parse_snapshot contract: one
    # truncated or hand-edited record must never cost the whole
    # report): ranks must be integers, anomaly entries must be dicts
    # with the numeric fields render() formats.
    try:
        body["rank"] = int(body["rank"])
    except (KeyError, TypeError, ValueError):
        body["rank"] = None
    try:
        body["round"] = int(body.get("round", 0) or 0)
    except (TypeError, ValueError):
        body["round"] = 0
    clean = []
    for a in body["anomalies"]:
        if not isinstance(a, dict):
            continue
        try:
            a["value"] = float(a.get("value", 0.0))
            a["median"] = float(a.get("median", 0.0))
        except (TypeError, ValueError):
            continue
        if a.get("z") is not None:
            try:
                a["z"] = float(a["z"])
            except (TypeError, ValueError):
                a["z"] = None
        clean.append(a)
    body["anomalies"] = clean
    if not isinstance(body.get("counts"), dict):
        body["counts"] = {}
    body["counts"] = {str(k): v for k, v in body["counts"].items()
                      if isinstance(v, (int, float))}
    return body


def load_watch_dir(d: str) -> List[Dict[str, Any]]:
    """Parse the hvdwatch anomaly records the launcher persisted
    (`watch-rank-<r>.r<round>.json`, observability/watch.py)."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return out
    for name in names:
        if not name.startswith("watch-") or not name.endswith(".json") \
                or ".tmp" in name:
            continue
        try:
            with open(os.path.join(d, name), "rb") as f:
                raw = f.read()
        except OSError:
            continue
        rec = _parse_watch(raw, name)
        if rec is not None:
            out.append(rec)
    return out


def load_watch_kv(addr: str, port: int, max_ranks: int = 256,
                  max_rounds: int = 64) -> List[Dict[str, Any]]:
    """Scrape `watch/rank-<r>.r<round>` anomaly records from a live
    rendezvous server."""
    from horovod_tpu_torch.observability.watch import SCOPE as WATCH_SCOPE
    return _scan_kv(addr, port, WATCH_SCOPE, _parse_watch,
                    max_ranks=max_ranks, max_rounds=max_rounds)


def _parse_trace(raw: bytes, source: str) -> Optional[Dict[str, Any]]:
    """Parse one hvdtrace fragment payload (observability/tracing.py):
    a local ``trace-*.json`` dump, a persisted ``trace-kv-*.json`` tail,
    or a live ``trace/`` KV record. Version-gated and sanitized at the
    boundary like every other doctor input."""
    try:
        body = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    if not (isinstance(body, dict)
            and isinstance(body.get("traces"), list)
            and body.get("version") is not None
            and "stats" in body):
        return None
    from horovod_tpu_torch.observability.tracing import TRACE_VERSION
    try:
        version = int(body["version"])
    except (TypeError, ValueError):
        version = TRACE_VERSION + 1
    if version > TRACE_VERSION:
        print(f"doctor: {source}: trace fragment version "
              f"{body.get('version')} is newer than this tool "
              f"understands; skipping", file=sys.stderr)
        return None
    clean = []
    for t in body["traces"]:
        if not isinstance(t, dict) or not t.get("tid") \
                or not isinstance(t.get("spans"), list):
            continue
        spans = []
        for sp in t["spans"]:
            if not isinstance(sp, dict) or not sp.get("tid") \
                    or not sp.get("sid"):
                continue
            try:
                sp["t0"] = float(sp.get("t0", 0.0))
                sp["dur"] = float(sp.get("dur", 0.0))
            except (TypeError, ValueError):
                continue
            if not isinstance(sp.get("attrs"), dict):
                sp["attrs"] = {}
            sp["status"] = str(sp.get("status", "ok"))
            spans.append(sp)
        if spans:
            clean.append({**t, "spans": spans})
    body["traces"] = clean
    return body


def load_trace_dir(d: str) -> List[Dict[str, Any]]:
    """Parse the hvdtrace fragments on disk: per-process atexit/exit
    dumps (``trace-<rank|pid>[.rN].json``) and the KV tails the
    launcher persisted (``trace-kv-*.json``)."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return out
    for name in names:
        if not name.startswith("trace-") or not name.endswith(".json") \
                or ".tmp" in name:
            continue
        try:
            with open(os.path.join(d, name), "rb") as f:
                raw = f.read()
        except OSError:
            continue
        rec = _parse_trace(raw, name)
        if rec is not None:
            out.append(rec)
    return out


def load_trace_kv(addr: str, port: int, max_ranks: int = 256,
                  max_rounds: int = 64) -> List[Dict[str, Any]]:
    """Scrape `trace/rank-<r>.r<round>` span tails from a live
    rendezvous server."""
    from horovod_tpu_torch.observability.tracing import SCOPE as TRACE_SCOPE
    return _scan_kv(addr, port, TRACE_SCOPE, _parse_trace,
                    max_ranks=max_ranks, max_rounds=max_rounds)


def dedupe_trace(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One fragment payload per (process, round) — keep the one
    carrying the most spans (payloads are cumulative snapshots of the
    same bounded store, so more spans = later/fuller)."""
    best: Dict[Tuple, Tuple[int, Dict[str, Any]]] = {}
    for r in records:
        key = (str(r.get("hostname") or ""), r.get("pid"),
               int(r.get("round", 0) or 0))
        n = sum(len(t["spans"]) for t in r.get("traces", []))
        cur = best.get(key)
        if cur is None or n > cur[0]:
            best[key] = (n, r)
    ranked = sorted(best.values(),
                    key=lambda p: (p[1].get("rank")
                                   if p[1].get("rank") is not None
                                   else 1 << 30,
                                   int(p[1].get("round", 0) or 0)))
    return [r for _, r in ranked]


def dedupe_watch(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One record per (rank, round) — keep the one carrying the most
    anomalies (records are cumulative, so more = later)."""
    best: Dict[Tuple, Dict[str, Any]] = {}
    for r in records:
        if r.get("rank") is None:
            continue
        key = (int(r["rank"]), int(r.get("round", 0) or 0))
        cur = best.get(key)
        if cur is None or (sum((r.get("counts") or {}).values())
                           > sum((cur.get("counts") or {}).values())):
            best[key] = r
    return [best[k] for k in sorted(best)]


def dedupe_perf(summaries: List[Dict[str, Any]]
                ) -> List[Dict[str, Any]]:
    """One summary per (rank, round) — keep the one covering the most
    steps (summaries are cumulative, so more steps = later)."""
    best: Dict[Tuple, Dict[str, Any]] = {}
    for s in summaries:
        if s.get("rank") is None:
            continue
        key = (int(s["rank"]), int(s.get("round", 0) or 0))
        cur = best.get(key)
        if cur is None or (s.get("summary", {}).get("steps", 0)
                           > cur.get("summary", {}).get("steps", 0)):
            best[key] = s
    return [best[k] for k in sorted(best)]


#: A rank is a perf straggler when its local step time exceeds the
#: cross-rank median by this factor (and by an absolute floor that
#: keeps microsecond-scale noise from electing one).
PERF_STRAGGLER_RATIO = 1.25
PERF_STRAGGLER_FLOOR_S = 0.005


def analyze_perf(summaries: List[Dict[str, Any]]
                 ) -> Optional[Dict[str, Any]]:
    """Cross-rank straggler attribution from perfscope summaries.

    Compares each rank's *local* mean step time (wall minus peer-wait
    phases): in a synchronous data-parallel job the wall time of every
    rank converges to the slowest one's — the fast ranks just park the
    difference in `comms` — so only local time separates the rank that
    *causes* the step time from the ranks that wait for it. Stragglers
    are named with their dominant local phase (the acceptance:
    a slow input pipeline comes out as `input_wait`)."""
    if not summaries:
        return None
    rounds: Dict[int, Dict[int, Dict[str, Any]]] = {}
    for s in summaries:
        rounds.setdefault(int(s.get("round", 0) or 0), {})[
            int(s["rank"])] = s
    out_rounds: Dict[str, Any] = {}
    stragglers: List[Dict[str, Any]] = []
    for rnd in sorted(rounds):
        ranks = rounds[rnd]
        per_rank: Dict[str, Any] = {}
        locals_: Dict[int, float] = {}
        for r in sorted(ranks):
            sm = ranks[r].get("summary", {})
            wall = sm.get("wall", {})
            local = float(sm.get("local_mean_s") or 0.0)
            locals_[r] = local
            per_rank[str(r)] = {
                "steps": sm.get("steps"),
                "mean_step_s": wall.get("mean_s"),
                "p95_step_s": wall.get("p95_s"),
                "local_mean_s": local,
                "dominant_phase": sm.get("dominant_phase"),
                "dominant_local_phase": sm.get("dominant_local_phase"),
                "phase_fractions": sm.get("phase_fractions", {}),
                "mfu": sm.get("mfu"),
                "mfu_source": sm.get("mfu_source"),
            }
        vals = sorted(locals_.values())
        # LOWER median: with 2 ranks the upper-middle element IS the
        # straggler's own value, which could never exceed itself.
        med = vals[(len(vals) - 1) // 2]
        rnd_stragglers = []
        if len(locals_) > 1:
            for r, local in sorted(locals_.items()):
                if local > med * PERF_STRAGGLER_RATIO \
                        and local - med > PERF_STRAGGLER_FLOOR_S:
                    entry = {
                        "round": rnd,
                        "rank": r,
                        "local_mean_s": local,
                        "slowdown_vs_median": (local / med) if med > 0
                        else None,
                        "dominant_phase":
                            per_rank[str(r)]["dominant_local_phase"],
                    }
                    rnd_stragglers.append(entry)
                    stragglers.append(entry)
        out_rounds[f"r{rnd}"] = {
            "round": rnd,
            "ranks": per_rank,
            "median_local_s": med,
            "stragglers": rnd_stragglers,
        }
    return {"rounds": out_rounds, "stragglers": stragglers}


def analyze_anomalies(records: List[Dict[str, Any]],
                      perf: Optional[Dict[str, Any]] = None,
                      groups: Optional[Dict[str, Dict[str, Any]]] = None
                      ) -> Optional[Dict[str, Any]]:
    """The hvdwatch [anomalies] section: every anomaly record the
    watchers pushed, correlated with the doctor's own straggler and
    divergence evidence — an anomalous rank that is ALSO a perf or
    collective straggler in the same round is corroborated, which is
    what separates "the detector fired" from "the detector fired on
    the rank the rest of the report blames"."""
    records = dedupe_watch(records)
    if not records:
        return None
    perf_stragglers: Dict[Tuple[int, int], str] = {}
    for s in (perf or {}).get("stragglers", []):
        perf_stragglers[(int(s["rank"]), int(s.get("round", 0)))] = \
            str(s.get("dominant_phase"))
    coll_stragglers: set = set()
    for g in (groups or {}).values():
        for r in g.get("stragglers", []):
            coll_stragglers.add((int(r), int(g.get("round", 0))))
    anomalies: List[Dict[str, Any]] = []
    per_rank: Dict[str, Any] = {}
    detectors: Dict[str, int] = {}
    for rec in records:
        rank = int(rec["rank"])
        rnd = int(rec.get("round", 0) or 0)
        key = f"{rank}@r{rnd}"
        per_rank[key] = {
            "rank": rank, "round": rnd,
            "counts": rec.get("counts") or {},
            "active": rec.get("active") or [],
        }
        for name, n in (rec.get("counts") or {}).items():
            detectors[name] = detectors.get(name, 0) + int(n)
        for a in rec.get("anomalies") or []:
            entry = dict(a)
            entry.setdefault("rank", rank)
            entry.setdefault("round", rnd)
            corroboration = []
            if (rank, rnd) in perf_stragglers:
                corroboration.append(
                    "perf straggler "
                    f"({perf_stragglers[(rank, rnd)]})")
            if (rank, rnd) in coll_stragglers:
                corroboration.append("collective straggler")
            entry["corroborated_by"] = corroboration
            anomalies.append(entry)
    anomalies.sort(key=lambda a: (a.get("wall_time") or 0,
                                  a.get("rank") or 0))
    return {
        "total": sum(detectors.values()),
        "detectors": detectors,
        "ranks": per_rank,
        "anomalies": anomalies,
    }


#: serve-event identity: "replica rank=<r> host=<h> pid=<p> ..." (both
#: the replica's own events and the pool's use this shape —
#: serve/replica.py, serve/pool.py).
_SERVE_RE = None


def _serve_fields(desc: str) -> Optional[Dict[str, Any]]:
    global _SERVE_RE
    import re
    if _SERVE_RE is None:
        _SERVE_RE = re.compile(
            r"replica rank=(\d+) host=(\S+) pid=(\d+)")
    m = _SERVE_RE.search(desc)
    if not m:
        return None
    out: Dict[str, Any] = {"rank": int(m.group(1)), "host": m.group(2),
                           "pid": int(m.group(3))}
    for k in ("batches", "requeued", "port", "round"):
        km = re.search(rf"\b{k}=(\d+)", desc)
        if km:
            out[k] = int(km.group(1))
    return out


def analyze_serve(dumps: List[RankDump]) -> Optional[Dict[str, Any]]:
    """Serving-tier analysis from flight `serve` events: replica
    lifecycle (UP/ADOPTED → DRAINED or DEAD) and, headline, every
    replica DEATH with how many in-flight requests were requeued — the
    'which replica died under load' question a serving postmortem
    starts with (docs/serving.md, docs/troubleshooting.md)."""
    replicas: Dict[Tuple, Dict[str, Any]] = {}
    deaths: List[Dict[str, Any]] = []
    other: List[str] = []
    # Supplemental requeue trail: when a stale-heartbeat eviction races
    # a failed submit, the DEAD event carries requeued=0 and the pool
    # records a separate "late requeue after eviction ... requeued=N"
    # event — folded into the death's total below so the headline never
    # under-reports. Deduped by (timestamp, desc): the same launcher
    # event can appear in both a full dump and a KV tail.
    late: Dict[Tuple, int] = {}
    late_seen: set = set()
    seen = False
    for d in dumps:
        for ev in d.events:
            if len(ev) < 4 or ev[2] != "serve":
                continue
            seen = True
            desc = str(ev[3])
            fields = _serve_fields(desc)
            if fields is None:
                if not any(desc == o for o in other):
                    other.append(desc)
                continue
            key = (fields["rank"], fields["host"], fields["pid"])
            info = replicas.setdefault(
                key, {"rank": fields["rank"], "host": fields["host"],
                      "pid": fields["pid"], "state": "up",
                      "batches": 0, "requeued": 0})
            if "batches" in fields:
                info["batches"] = max(info["batches"], fields["batches"])
            if "late requeue" in desc:
                evkey = (float(ev[1]), desc)
                if evkey not in late_seen:
                    late_seen.add(evkey)
                    late[key] = late.get(key, 0) \
                        + fields.get("requeued", 0)
                continue
            if " DEAD " in desc or desc.rstrip().endswith("DEAD"):
                info["state"] = "dead"
                info["requeued"] = fields.get("requeued", 0)
                death = {**info, "time": float(ev[1])}
                if not any(dd["pid"] == info["pid"]
                           and dd["rank"] == info["rank"]
                           for dd in deaths):
                    deaths.append(death)
            elif "DRAINED" in desc and info["state"] != "dead":
                info["state"] = "drained"
            elif "EVICTED" in desc and info["state"] != "dead":
                # The replica's own terminal event when it exits rc 1
                # on a pid-pinned die order (troubleshooting.md) — in a
                # tail-only merge this is the only record of the exit,
                # and rendering it as UP would misread a terminal exit
                # as a live replica.
                info["state"] = "evicted"
    if not seen:
        return None
    for key, n in late.items():
        if key in replicas:
            replicas[key]["requeued"] += n
        for dd in deaths:
            if (dd["rank"], dd["host"], dd["pid"]) == key:
                dd["requeued"] += n
    return {
        "replicas": [replicas[k] for k in sorted(replicas)],
        "deaths": sorted(deaths, key=lambda x: x["time"]),
        "other_events": other[:10],
    }


def analyze_traces(records: List[Dict[str, Any]],
                   perf: Optional[Dict[str, Any]] = None,
                   serve: Optional[Dict[str, Any]] = None,
                   slowest: int = 5) -> Optional[Dict[str, Any]]:
    """The [traces] section: join per-process hvdtrace fragments into
    whole causal traces (observability/tracing.py).

    Fragments are joined by trace id — the client's ``serve.client``
    span, the frontend's ``serve.request``/``serve.queue``, the pool's
    per-attempt ``serve.dispatch`` + shared ``serve.batch``, and the
    replica's ``replica.infer_batch``/``engine.execute`` all carry the
    same id. Each reconstructed request names its
    queue-vs-dispatch-vs-device split; a request that shared its batch
    with another trace resolves its device time through the batch span
    its dispatch named (the ``links`` stitch). Requests are
    cross-referenced against the report's own perf stragglers and
    [serve] replica deaths — a requeued request whose failed attempt
    hit a known-dead replica says so."""
    records = dedupe_trace(records)
    if not records:
        return None
    # Join fragments by trace id; dedupe spans by span id (the same
    # span can arrive via both a dump and a persisted KV tail).
    spans_by_trace: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for rec in records:
        for t in rec.get("traces", []):
            cur = spans_by_trace.setdefault(str(t["tid"]), {})
            for sp in t["spans"]:
                old = cur.get(sp["sid"])
                if old is None or sp["dur"] > old["dur"]:
                    cur[sp["sid"]] = sp
    # Device time per batch-execution span: engine.execute is a child
    # of replica.infer_batch, whose parent IS the serve.batch span id.
    device_by_batch: Dict[str, float] = {}
    for spans in spans_by_trace.values():
        for sp in spans.values():
            if sp.get("name") == "replica.infer_batch" and sp.get("psid"):
                dev = sp["dur"]
                for ch in spans.values():
                    if ch.get("psid") == sp["sid"] \
                            and ch.get("name") == "engine.execute":
                        dev = ch["dur"]
                        break
                device_by_batch[sp["psid"]] = max(
                    device_by_batch.get(sp["psid"], 0.0), dev)
    death_by_replica: Dict[str, Dict[str, Any]] = {}
    replica_rank: Dict[str, int] = {}
    for info in (serve or {}).get("replicas", []):
        replica_rank[f"{info['host']}:{info['pid']}"] = info["rank"]
    for dd in (serve or {}).get("deaths", []):
        death_by_replica[f"{dd['host']}:{dd['pid']}"] = dd
    straggler_phase: Dict[int, str] = {}
    for s in (perf or {}).get("stragglers", []):
        straggler_phase[int(s["rank"])] = str(s.get("dominant_phase"))
    requests: List[Dict[str, Any]] = []
    train_steps = 0
    for tid, spans in spans_by_trace.items():
        by_name: Dict[str, List[Dict[str, Any]]] = {}
        for sp in spans.values():
            by_name.setdefault(str(sp.get("name")), []).append(sp)
        if "train.step" in by_name:
            train_steps += 1
        roots = by_name.get("serve.request")
        if not roots:
            continue
        root = max(roots, key=lambda s: s["dur"])
        queue = by_name.get("serve.queue")
        attempts = sorted(by_name.get("serve.dispatch", []),
                          key=lambda s: s["t0"])
        device_s = None
        eng = by_name.get("engine.execute")
        if eng:
            # This trace is the batch's primary: the replica fragment
            # joined it directly.
            device_s = max(s["dur"] for s in eng)
        else:
            # Linked request: its device time lives under the primary's
            # trace — resolve through the batch id its dispatch named.
            for a in reversed(attempts):
                b = a["attrs"].get("batch")
                if b in device_by_batch:
                    device_s = device_by_batch[b]
                    break
        entry: Dict[str, Any] = {
            "trace_id": tid,
            "rid": root["attrs"].get("rid"),
            "status": root.get("status", "ok"),
            "requeues": int(root["attrs"].get("requeues", 0) or 0),
            "total_s": root["dur"],
            "queue_s": sum(s["dur"] for s in queue) if queue else None,
            "dispatch_s": sum(s["dur"] for s in attempts)
            if attempts else None,
            "device_s": device_s,
            "attempts": [{
                "replica": a["attrs"].get("replica"),
                "attempt": a["attrs"].get("attempt"),
                "status": a.get("status", "ok"),
                "dur_s": a["dur"],
            } for a in attempts],
            # The acceptance bar: every hop of the cross-process path
            # reconstructed — queue, at least one dispatch, device.
            "complete": bool(queue) and bool(attempts)
            and device_s is not None,
        }
        notes: List[str] = []
        for a in entry["attempts"]:
            repl = a.get("replica")
            if a.get("status") != "ok" and repl in death_by_replica:
                notes.append(
                    f"attempt {a.get('attempt')} hit replica death "
                    f"(rank {death_by_replica[repl]['rank']}, "
                    f"pid {death_by_replica[repl]['pid']})")
        served_by = next((a for a in reversed(entry["attempts"])
                          if a.get("status") == "ok"), None)
        if served_by is not None:
            r = replica_rank.get(served_by.get("replica"))
            if r in straggler_phase:
                notes.append(f"served by perf straggler rank {r} "
                             f"({straggler_phase[r]})")
        entry["corroborated_by"] = notes
        requests.append(entry)
    if not requests and not train_steps:
        return None
    requests.sort(key=lambda e: -(e["total_s"] or 0.0))
    return {
        "requests": len(requests),
        "train_steps": train_steps,
        "complete": sum(1 for e in requests if e["complete"]),
        "slowest": requests[:slowest],
        "errored": [e for e in requests
                    if e["status"] != "ok"][:slowest],
        "requeued": [e for e in requests
                     if e["requeues"] > 0][:slowest],
    }


def _ckpt_fields(desc: str) -> Dict[str, Any]:
    """Parse the key=value fields of a flight `ckpt` event desc
    (ckpt/async_ckpt.py formats them; first token is the verb)."""
    import re
    out: Dict[str, Any] = {"verb": desc.split(" ", 1)[0]}
    for k in ("step", "gen", "bytes", "rank", "round", "latest",
              "skipped"):
        m = re.search(rf"\b{k}=(-?\d+)", desc)
        if m:
            out[k] = int(m.group(1))
    m = re.search(r"\bseconds=([0-9.]+)", desc)
    if m:
        out["seconds"] = float(m.group(1))
    m = re.search(r"\bsource=(\S+)", desc)
    if m:
        out["source"] = m.group(1)
    m = re.search(r"\breason=(\S+)", desc)
    if m:
        out["reason"] = m.group(1)
    return out


def analyze_ckpt(dumps: List[RankDump]) -> Optional[Dict[str, Any]]:
    """The [ckpt] section (docs/checkpointing.md): per elastic round,
    the last COMMITTED checkpoint generation; every restore with its
    source (checkpoint vs memory) and generation — flagging any rank
    that restored a generation older than the newest one committed in
    its round (a stale restore: that rank trained from older weights
    than its peers could have); quarantines, back-pressure skips, and
    persist errors."""
    commits: Dict[int, Dict[str, Any]] = {}   # round -> newest commit
    commit_times: List[Tuple[float, int]] = []  # (wall time, generation)
    restores: List[Dict[str, Any]] = []
    quarantines: List[Dict[str, Any]] = []
    skipped: Dict[int, int] = {}              # rank -> max skip count
    errors: List[str] = []
    rearm = 0
    seen = False
    seen_keys: set = set()  # (ts, desc): full dump + KV tail dedupe
    for d in dumps:
        for ev in d.events:
            if len(ev) < 4 or ev[2] != "ckpt":
                continue
            key = (float(ev[1]), str(ev[3]))
            if key in seen_keys:
                continue
            seen_keys.add(key)
            seen = True
            desc = str(ev[3])
            f = _ckpt_fields(desc)
            rnd = f.get("round", 0)
            verb = f["verb"]
            if verb == "commit":
                cur = commits.get(rnd)
                if cur is None or f.get("gen", -1) > cur["generation"]:
                    commits[rnd] = {"generation": f.get("gen"),
                                    "step": f.get("step"),
                                    "rank": f.get("rank")}
                if f.get("gen") is not None:
                    commit_times.append((float(ev[1]), f["gen"]))
            elif verb == "restore":
                restores.append({
                    "rank": f.get("rank"), "round": rnd,
                    "generation": f.get("gen"), "step": f.get("step"),
                    "source": f.get("source", "?"),
                    "seconds": f.get("seconds"), "time": float(ev[1])})
            elif verb == "restore-stale":
                # An ANNOTATION of the restore the same rank just
                # recorded (resume.py emits both for one restore) —
                # fold it into that entry rather than duplicating it.
                match = next(
                    (r for r in reversed(restores)
                     if r["rank"] == f.get("rank")
                     and r["round"] == rnd
                     and r.get("generation") == f.get("gen")
                     and "stale_vs" not in r), None)
                if match is not None:
                    match["stale_vs"] = f.get("latest")
                else:
                    restores.append({
                        "rank": f.get("rank"), "round": rnd,
                        "generation": f.get("gen"),
                        "step": f.get("step"),
                        "source": "checkpoint",
                        "stale_vs": f.get("latest"),
                        "time": float(ev[1])})
            elif verb == "quarantine":
                quarantines.append({
                    "rank": f.get("rank"), "round": rnd,
                    "step": f.get("step"),
                    "reason": f.get("reason", desc)})
            elif verb == "skip":
                r = f.get("rank", -1)
                skipped[r] = max(skipped.get(r, 0),
                                 f.get("skipped", 1))
            elif verb in ("persist-error", "commit-abort"):
                errors.append(desc)
            elif verb == "stall" or desc.startswith("stall deadline"):
                rearm += 1
    if not seen:
        return None
    stale: List[Dict[str, Any]] = []
    for r in restores:
        if r.get("source") != "checkpoint":
            continue
        newest = r.get("stale_vs")
        if newest is None:
            # A restore is stale relative to what was committed BEFORE
            # it happened — a commit made later in the same round (by
            # the resumed training itself) is not evidence of
            # staleness, so the comparison is time-ordered.
            before = [g for t, g in commit_times if t <= r["time"]]
            newest = max(before) if before else None
        if newest is not None and r.get("generation") is not None \
                and r["generation"] < newest:
            stale.append({**r, "stale_vs": newest})
    return {
        "rounds": {str(k): v for k, v in sorted(commits.items())},
        "restores": sorted(restores, key=lambda x: x["time"]),
        "stale_restores": stale,
        "quarantines": quarantines,
        "skipped": {str(k): v for k, v in sorted(skipped.items())},
        "errors": errors[:10],
        "stall_rearms": rearm,
    }


def analyze_control_plane(
        dumps: List[RankDump]) -> Optional[Dict[str, Any]]:
    """The [control-plane] section (docs/resilience.md): the replicated
    rendezvous lifecycle from the launcher's flight `kv-failover` events
    (runner/kv_ha.py) — replica count, every replica death, and every
    failover with old/new primary, the epoch bump and the catch-up lag
    the promoted primary started from. None when the job ran the plain
    single-server control plane (HOROVOD_KV_REPLICAS=1 emits nothing)."""
    import re
    replicas: Optional[int] = None
    epoch: Optional[int] = None
    deaths: List[Dict[str, Any]] = []
    failovers: List[Dict[str, Any]] = []
    errors: List[str] = []
    seen = False
    seen_keys: set = set()  # (ts, desc): full dump + KV tail dedupe
    for d in dumps:
        for ev in d.events:
            if len(ev) < 4 or ev[2] != "kv-failover":
                continue
            key = (float(ev[1]), str(ev[3]))
            if key in seen_keys:
                continue
            seen_keys.add(key)
            seen = True
            desc = str(ev[3])
            m = re.match(r"control-plane up replicas=(\d+) "
                         r"primary=r(\d+) epoch=(\d+)", desc)
            if m:
                replicas = int(m.group(1))
                epoch = max(epoch or 0, int(m.group(3)))
                continue
            m = re.match(r"replica r(\d+) died(?: rc=(-?\d+))?"
                         r"( \(primary\))?", desc)
            if m:
                deaths.append({
                    "replica": int(m.group(1)),
                    "rc": int(m.group(2)) if m.group(2) else None,
                    "primary": bool(m.group(3)),
                    "time": float(ev[1])})
                continue
            m = re.match(r"failover: primary r(\d+) -> r(\d+) "
                         r"epoch (\d+)->(\d+) lag=(\d+)", desc)
            if m:
                failovers.append({
                    "old_primary": int(m.group(1)),
                    "new_primary": int(m.group(2)),
                    "old_epoch": int(m.group(3)),
                    "epoch": int(m.group(4)),
                    "lag": int(m.group(5)),
                    "time": float(ev[1])})
                epoch = max(epoch or 0, int(m.group(4)))
                continue
            m = re.match(r"control-plane down epoch=(\d+)", desc)
            if m:
                epoch = max(epoch or 0, int(m.group(1)))
                continue
            if "FAILED" in desc:
                errors.append(desc)
    if not seen:
        return None
    return {"replicas": replicas, "epoch": epoch,
            "deaths": sorted(deaths, key=lambda x: x["time"]),
            "failovers": sorted(failovers, key=lambda x: x["time"]),
            "errors": errors[:10]}


def dedupe(dumps: List[RankDump]) -> List[RankDump]:
    """Collapse redundant dumps, keeping non-overlapping evidence.

    Full dumps: one per PROCESS — the biggest (a full atexit dump is a
    superset of the same process's earlier full dumps). KV tails: one
    per (process, round), and a tail is dropped against a full dump
    only when that dump actually retains collectives from the tail's
    round — a 64-event tail from an earlier round is NOT covered by a
    later round's dump whose ring moved on."""
    fulls: Dict[Tuple, RankDump] = {}
    tails: Dict[Tuple, RankDump] = {}
    for d in dumps:
        if d.rank is None and not d.events:
            continue
        if d.tail_only:
            key = d.process_id() + (d.round,)
            cur = tails.get(key)
            if cur is None or len(d.events) > len(cur.events):
                tails[key] = d
        else:
            key = d.process_id()
            cur = fulls.get(key)
            if cur is None or len(d.events) > len(cur.events):
                fulls[key] = d
    kept: List[RankDump] = list(fulls.values())
    for d in tails.values():
        full = fulls.get(d.process_id())
        if full is not None and any(rnd == d.round
                                    for rnd, _ in full.collectives()):
            continue  # the full dump still covers this round
        kept.append(d)
    return sorted(kept,
                  key=lambda d: (d.rank if d.rank is not None else 1 << 30,
                                 d.round))


# ---------------------------------------------------------------- merge

def analyze_group(round_id: int, gid: int, dumps: List[RankDump]
                  ) -> Optional[Dict[str, Any]]:
    """Cross-rank agreement analysis for one (round, process set)."""
    calls: Dict[int, Dict[int, Tuple[str, str, float]]] = {}
    for d in dumps:
        c = d.collectives().get((round_id, gid))
        if not c:
            continue
        label = d.rank_for_round(round_id)
        if label is None:
            continue
        # Same (round, rank) from two processes should not survive
        # dedupe; if it does, keep the fuller record.
        if label not in calls or len(c) > len(calls[label]):
            calls[label] = c
    if not calls:
        return None
    last = {r: max(c) for r, c in calls.items()}
    first = {r: min(c) for r, c in calls.items()}
    # Only indices retained on EVERY member can be compared (the ring
    # may have dropped older calls on busier ranks).
    lo = max(first.values())
    hi = min(last.values())
    last_agreed: Optional[Tuple[int, str, str]] = None
    divergence: Optional[Dict[str, Any]] = None
    for i in range(lo, hi + 1):
        entries = {r: c.get(i) for r, c in calls.items()}
        if any(v is None for v in entries.values()):
            continue  # a gap (pruned slot) — not comparable, not a lie
        values = {(v[0], v[1]) for v in entries.values()}
        if len(values) == 1:
            desc, name = next(iter(values))
            last_agreed = (i, desc, name)
        else:
            clusters: Dict[Tuple[str, str], List[int]] = {}
            for r, v in entries.items():
                clusters.setdefault((v[0], v[1]), []).append(r)
            divergence = {
                "call": i,
                "issued": [{"ranks": sorted(rs), "desc": d_, "name": n_}
                           for (d_, n_), rs in sorted(clusters.items())],
            }
            break
    max_last = max(last.values())
    stragglers = sorted(r for r, v in last.items() if v < max_last)
    # Ranks the round should have had but which left no events at all.
    sizes = [d.size for d in dumps
             if d.size and d.round == round_id]
    expected = max(sizes) if sizes else None
    missing = sorted(set(range(expected)) - set(calls)) \
        if expected is not None else []
    return {
        "round": round_id,
        "group": gid,
        "members": sorted(calls),
        "calls_per_rank": {str(r): last[r] + 1 for r in sorted(last)},
        "last_agreed": None if last_agreed is None else {
            "call": last_agreed[0], "desc": last_agreed[1],
            "name": last_agreed[2]},
        "divergence": divergence,
        "stragglers": stragglers,
        "behind_by": {str(r): max_last - last[r] for r in stragglers},
        "missing": missing,
    }


def merge(dumps: List[RankDump], tail: int = 8,
          perf: Optional[List[Dict[str, Any]]] = None,
          watch: Optional[List[Dict[str, Any]]] = None,
          traces: Optional[List[Dict[str, Any]]] = None
          ) -> Dict[str, Any]:
    size = max((d.size for d in dumps if d.size), default=None)
    seen_ranks: set = set()
    for d in dumps:
        seen_ranks.update(d.ranks_seen())
    expected = size if size is not None else (max(seen_ranks) + 1
                                              if seen_ranks else 0)
    missing = sorted(set(range(expected)) - seen_ranks)
    keys = set()
    for d in dumps:
        keys.update(d.collectives())
    groups: Dict[str, Dict[str, Any]] = {}
    for rnd, gid in sorted(keys):
        res = analyze_group(rnd, gid, dumps)
        if res is not None:
            groups[group_key(rnd, gid)] = res
    straggler_set = set()
    for g in groups.values():
        straggler_set.update(g["stragglers"])
    report: Dict[str, Any] = {
        "ranks_expected": expected,
        "ranks_dumped": sorted(seen_ranks),
        "tail_only_ranks": sorted(
            {r for d in dumps if d.tail_only for r in d.ranks_seen()}),
        "missing_ranks": missing,
        "triggers": {f"{d.rank}@r{d.round}": d.trigger for d in dumps},
        "groups": groups,
        "perf": analyze_perf(dedupe_perf(perf)) if perf else None,
        "serve": analyze_serve(dumps),
        "ckpt": analyze_ckpt(dumps),
        "control_plane": analyze_control_plane(dumps),
        "per_rank": {},
    }
    report["anomalies"] = analyze_anomalies(
        watch or [], perf=report["perf"], groups=groups)
    report["traces"] = analyze_traces(
        traces or [], perf=report["perf"],
        serve=report["serve"]) if traces else None
    for d in dumps:
        info: Dict[str, Any] = {
            "rank": d.rank,
            "round": d.round,
            "source": d.source,
            "tail_only": d.tail_only,
            "trigger": d.trigger,
            "events_retained": len(d.events),
            "events_dropped": d.body.get("dropped", 0),
            "last_event": d.last_event(),
            "tail": d.tail(tail),
        }
        # Bucket-scheduler evidence (ops/collectives.bucketed_allreduce):
        # profiled buckets that ran far past their call's median are
        # recorded as SLOW `bucket` events — surface the most recent so a
        # perf postmortem names the slow bucket, not just the slow step.
        slow = [ev for ev in d.events
                if len(ev) >= 4 and ev[2] == "bucket"
                and str(ev[3]).startswith("SLOW")]
        if slow:
            info["slow_buckets"] = slow[-3:]
        if (set(d.ranks_seen()) & straggler_set) \
                or d.trigger not in ("atexit", "tick"):
            # The interesting processes keep their stacks in the report.
            info["stacks"] = d.stacks
        key = f"{d.rank}@r{d.round}"
        while key in report["per_rank"]:
            key += "'"
        report["per_rank"][key] = info
    return report


# --------------------------------------------------------------- render

def _fmt_event(ev: list) -> str:
    ts = time.strftime("%H:%M:%S", time.localtime(ev[1])) + \
        f".{int((ev[1] % 1) * 1000):03d}"
    if len(ev) >= 7 and ev[2] == "collective":
        name = f" name={ev[4]}" if ev[4] else ""
        return f"{ts} collective ps{ev[5]}#{ev[6]} {ev[3]}{name}"
    return f"{ts} {ev[2]} {ev[3]}"


def _group_label(g: Dict[str, Any]) -> str:
    base = "world" if g["group"] == WORLD_GROUP \
        else f"process set {g['group']}"
    return base if g["round"] == 0 else f"round {g['round']} · {base}"


def _trace_split(e: Dict[str, Any]) -> str:
    """'queue X ms, dispatch Y ms, device Z ms' with '?' for hops the
    joined fragments did not cover."""
    def ms(v: Optional[float]) -> str:
        return "?" if v is None else f"{v * 1e3:.1f} ms"
    return (f"queue {ms(e.get('queue_s'))}, "
            f"dispatch {ms(e.get('dispatch_s'))}, "
            f"device {ms(e.get('device_s'))}")


def render(report: Dict[str, Any], tail: int = 8) -> str:
    out: List[str] = []
    add = out.append
    add("hvddoctor: cross-rank flight-recorder postmortem")
    add(f"  ranks: {report['ranks_expected']} expected, "
        f"{len(report['per_rank'])} dump(s) loaded "
        f"({len(report['tail_only_ranks'])} KV-tail-only)")
    if report["missing_ranks"]:
        add(f"  MISSING ranks (no dump, no tail — killed before any "
            f"flush?): {report['missing_ranks']}")
    trig = ", ".join(f"rank {k}: {t}"
                     for k, t in report["triggers"].items())
    add(f"  dump triggers: {trig}")
    add("")
    for _, g in sorted(report["groups"].items(),
                       key=lambda kv: (kv[1]["round"], kv[1]["group"])):
        add(f"[{_group_label(g)}] collective agreement "
            f"(ranks {g['members']}, calls per rank "
            f"{g['calls_per_rank']})")
        la = g["last_agreed"]
        if la is not None:
            name = f" name={la['name']}" if la["name"] else ""
            add(f"  last collective all ranks agreed on: call "
                f"#{la['call']}: {la['desc']}{name}")
        else:
            add("  no call index was comparable across every rank "
                "(windows did not overlap)")
        if g["divergence"] is not None:
            dv = g["divergence"]
            add(f"  FIRST DIVERGENCE at call #{dv['call']}:")
            for c in dv["issued"]:
                name = f" name={c['name']}" if c["name"] else ""
                add(f"    rank(s) {c['ranks']} issued {c['desc']}{name}")
        if g["stragglers"]:
            for r in g["stragglers"]:
                add(f"  STRAGGLER rank {r}: stopped "
                    f"{g['behind_by'][str(r)]} call(s) behind its peers")
        if g["missing"]:
            add(f"  rank(s) {g['missing']} recorded NO collectives in "
                f"this round")
        if g["divergence"] is None and not g["stragglers"] \
                and not g["missing"]:
            add("  all ranks in step at the end of the recorded window")
        add("")
    anomalies = report.get("anomalies")
    if anomalies:
        add("[anomalies] hvdwatch online detections "
            "(observability/watch.py; docs/observability.md)")
        det = ", ".join(f"{k}: {v}" for k, v in
                        sorted(anomalies["detectors"].items()))
        add(f"  {anomalies['total']} anomaly(ies) total ({det})")
        for a in anomalies["anomalies"]:
            rnd = "" if not a.get("round") else f" round {a['round']}"
            z = f" z={a['z']:.1f}" if a.get("z") is not None else ""
            line = (f"  ANOMALY rank {a.get('rank')}{rnd}: "
                    f"detector {a.get('detector')} value "
                    f"{a.get('value'):.6g} (baseline "
                    f"{a.get('median'):.6g}){z} at step {a.get('step')}")
            if a.get("corroborated_by"):
                line += " — corroborated by " \
                    + " + ".join(a["corroborated_by"])
            add(line)
        for key, info in sorted(anomalies["ranks"].items()):
            if info["active"]:
                add(f"  rank {info['rank']} round {info['round']}: "
                    f"still ACTIVE at last push: "
                    f"{', '.join(info['active'])}")
        add("")
    cp = report.get("control_plane")
    if cp:
        add("[control-plane] replicated rendezvous (flight "
            "`kv-failover` events; docs/resilience.md)")
        if cp["replicas"] is not None:
            add(f"  {cp['replicas']} replica(s), final epoch "
                f"{cp['epoch']}")
        for dd in cp["deaths"]:
            role = " (PRIMARY)" if dd["primary"] else ""
            rc = f" rc={dd['rc']}" if dd.get("rc") is not None else ""
            add(f"  replica r{dd['replica']} died{rc}{role}")
        for fo in cp["failovers"]:
            add(f"  FAILOVER: primary r{fo['old_primary']} -> "
                f"r{fo['new_primary']}, epoch {fo['old_epoch']}->"
                f"{fo['epoch']}, catch-up lag {fo['lag']} entr(ies)")
        if not cp["failovers"]:
            add("  no failover recorded")
        for e in cp["errors"]:
            add(f"  CONTROL-PLANE ERROR: {e}")
        add("")
    serve = report.get("serve")
    if serve:
        add("[serve] replica pool (flight `serve` events; "
            "docs/serving.md)")
        for info in serve["replicas"]:
            state = info["state"].upper()
            line = (f"  replica rank {info['rank']} "
                    f"(host {info['host']}, pid {info['pid']}): {state}")
            if info["batches"]:
                line += f", {info['batches']} batch(es) served"
            add(line)
        for dd in serve["deaths"]:
            add(f"  SERVE REPLICA DEATH: rank {dd['rank']} "
                f"(host {dd['host']}, pid {dd['pid']}) — "
                f"{dd['requeued']} in-flight request(s) requeued onto "
                f"survivors")
        if not serve["deaths"]:
            add("  no replica deaths recorded")
        add("")
    traces = report.get("traces")
    if traces:
        add("[traces] hvdtrace request/step causality "
            "(observability/tracing.py; docs/observability.md)")
        add(f"  {traces['requests']} request trace(s) joined "
            f"({traces['complete']} complete cross-process), "
            f"{traces['train_steps']} train-step trace(s)")
        for e in traces["slowest"]:
            add(f"  SLOWEST request rid={e['rid']} "
                f"trace={e['trace_id']}: "
                f"{(e['total_s'] or 0) * 1e3:.1f} ms total "
                f"({_trace_split(e)})")
            for n in e.get("corroborated_by", []):
                add(f"    — {n}")
        for e in traces["requeued"]:
            add(f"  REQUEUED request rid={e['rid']} "
                f"trace={e['trace_id']}: {len(e['attempts'])} dispatch "
                f"attempt(s) across replicas")
            for a in e["attempts"]:
                add(f"    attempt {a.get('attempt')} -> replica "
                    f"{a.get('replica')}: {a.get('status')} "
                    f"({(a.get('dur_s') or 0) * 1e3:.1f} ms)")
            for n in e.get("corroborated_by", []):
                add(f"    — {n}")
        for e in traces["errored"]:
            if e["requeues"] > 0:
                continue  # already rendered above
            add(f"  {e['status'].upper()} request rid={e['rid']} "
                f"trace={e['trace_id']}: "
                f"{(e['total_s'] or 0) * 1e3:.1f} ms "
                f"({_trace_split(e)})")
        add("")
    ck = report.get("ckpt")
    if ck:
        add("[ckpt] checkpointing (flight `ckpt` events; "
            "docs/checkpointing.md)")
        for rnd, c in sorted(ck["rounds"].items(),
                             key=lambda kv: int(kv[0])):
            tag = "" if int(rnd) == 0 else f"round {rnd}: "
            add(f"  {tag}last committed generation "
                f"{c['generation']} (step {c['step']}, written by "
                f"rank {c['rank']})")
        if not ck["rounds"]:
            add("  no commit recorded in any retained window")
        for r in ck["restores"]:
            rnd = "" if not r.get("round") else f" round {r['round']}"
            if r["source"] == "memory":
                add(f"  rank {r['rank']}{rnd}: resumed from MEMORY at "
                    f"step {r['step']} (survivor — disk not needed)")
            else:
                secs = f" in {r['seconds']:.2f}s" \
                    if r.get("seconds") is not None else ""
                add(f"  rank {r['rank']}{rnd}: restored generation "
                    f"{r['generation']} (step {r['step']}) from "
                    f"checkpoint{secs}")
        for s in ck["stale_restores"]:
            rnd = "" if not s.get("round") else f" round {s['round']}"
            add(f"  STALE RESTORE rank {s['rank']}{rnd}: restored "
                f"generation {s['generation']} but generation "
                f"{s['stale_vs']} was committed — this rank trained "
                f"from older weights than its peers could have")
        for q in ck["quarantines"]:
            add(f"  QUARANTINED step {q['step']}: {q['reason']} "
                f"(rank {q['rank']})")
        for r, n in sorted(ck["skipped"].items()):
            add(f"  rank {r}: {n} save(s) skipped by back-pressure "
                f"(writer busy — checkpoint freshness lost, step time "
                f"preserved)")
        for e in ck["errors"]:
            add(f"  PERSIST ERROR: {e}")
        if ck.get("stall_rearms"):
            add(f"  stall deadline re-armed {ck['stall_rearms']} "
                f"time(s) while a peer restored")
        add("")
    perf = report.get("perf")
    if perf:
        add("[perf] step-time summaries (perfscope; local = wall minus "
            "peer-wait phases)")
        for _, rd in sorted(perf["rounds"].items(),
                            key=lambda kv: kv[1]["round"]):
            rnd = "" if rd["round"] == 0 else f" round {rd['round']}"
            for r, info in sorted(rd["ranks"].items(),
                                  key=lambda kv: int(kv[0])):
                mean = info.get("mean_step_s")
                p95 = info.get("p95_step_s")
                mfu = info.get("mfu")
                line = (f"  rank {r}{rnd}: "
                        f"{(mean or 0) * 1e3:.1f} ms/step mean "
                        f"(p95 {(p95 or 0) * 1e3:.1f} ms), local "
                        f"{info['local_mean_s'] * 1e3:.1f} ms, dominant "
                        f"phase {info.get('dominant_phase')}")
                if mfu is not None:
                    line += (f", mfu {mfu:.3f} "
                             f"({info.get('mfu_source')})")
                add(line)
            for s in rd["stragglers"]:
                ratio = s["slowdown_vs_median"]
                # None when the median local time is 0 (degenerate
                # summaries) — the straggler is still worth naming.
                by = f"{ratio:.2f}x the median local step time" \
                    if ratio is not None else \
                    "the only rank with local step time"
                add(f"  PERF STRAGGLER rank {s['rank']}{rnd}: {by}; "
                    f"dominant phase: {s['dominant_phase']}")
            if not rd["stragglers"] and len(rd["ranks"]) > 1:
                add(f"  no perf straggler{rnd}: local step times within "
                    f"{PERF_STRAGGLER_RATIO}x of the median")
        add("")
    for key, info in report["per_rank"].items():
        kind = "KV tail" if info["tail_only"] else "full dump"
        rnd = "" if info["round"] == 0 else f" @ round {info['round']}"
        add(f"rank {info['rank']}{rnd} ({kind}, "
            f"trigger={info['trigger']}, "
            f"{info['events_retained']} event(s) retained, "
            f"{info['events_dropped']} dropped): {info['source']}")
        last = info["last_event"]
        if last:
            add(f"  last event: {_fmt_event(last)}")
        for ev in info.get("slow_buckets", []):
            add(f"  SLOW BUCKET: {_fmt_event(ev)}")
        for ev in info["tail"][-tail:]:
            add(f"    {_fmt_event(ev)}")
        stacks = info.get("stacks") or {}
        for tname, frames in sorted(stacks.items()):
            if "MainThread" in tname or len(stacks) <= 2:
                add(f"  stack [{tname}]:")
                for ln in frames[-6:]:
                    for piece in ln.splitlines():
                        add(f"    {piece}")
        add("")
    return "\n".join(out)


# ---------------------------------------------------------------- trace

def export_trace(dumps: List[RankDump], path: str,
                 traces: Optional[List[Dict[str, Any]]] = None) -> None:
    """Perfetto/about:tracing export: one track (pid) per process —
    every flight event as an instant at its wall-clock time, and (when
    hvdtrace fragments are present) every span as a duration slice.
    Span nesting gets DISTINCT thread tracks (tid = nesting depth, with
    thread_name metadata) instead of one flat track, and cross-process
    flow events (``ph:"s"``/``"f"``) stitch each request's dispatch
    slice into the batch-execution slice it shared on the replica."""
    events: List[dict] = []
    for i, d in enumerate(dumps):
        # One track per PROCESS: rank numbers are reused across elastic
        # rounds, so the track id must be unique per dump, not per rank.
        track = i
        label = f"rank {d.rank}" if d.rank is not None else d.source
        if d.round:
            label += f" (round {d.round})"
        events.append({"ph": "M", "pid": track, "name": "process_name",
                       "args": {"name": label}})
        for ev in d.events:
            name = (f"{ev[3]}" if len(ev) < 7
                    else f"ps{ev[5]}#{ev[6]} {ev[3]}")
            events.append({
                "ph": "i", "s": "t", "pid": track, "tid": 0,
                "ts": ev[1] * 1e6,  # epoch seconds -> us
                "name": name,
                "cat": ev[2],
                "args": {"seq": ev[0]},
            })
    # hvdtrace span fragments: pid tracks continue after the dump ones.
    emitted: List[Dict[str, Any]] = []
    pid = len(dumps)
    for rec in dedupe_trace(traces or []):
        spans: List[Dict[str, Any]] = []
        seen_sids: set = set()
        for t in rec.get("traces", []):
            for sp in t["spans"]:
                if sp["sid"] in seen_sids:
                    continue
                seen_sids.add(sp["sid"])
                spans.append(sp)
        if not spans:
            continue
        label = (f"hvdtrace rank {rec['rank']}"
                 if rec.get("rank") is not None
                 else f"hvdtrace pid {rec.get('pid')}")
        if rec.get("round"):
            label += f" (round {rec['round']})"
        if rec.get("hostname"):
            label += f" @ {rec['hostname']}"
        events.append({"ph": "M", "pid": pid, "name": "process_name",
                       "args": {"name": label}})
        # tid = nesting depth within this process's fragments, so
        # parent and child slices land on separate thread tracks.
        by_sid = {sp["sid"]: sp for sp in spans}

        def depth_of(sp: Dict[str, Any]) -> int:
            d_, cur, hops = 0, sp, 0
            while cur.get("psid") in by_sid and hops < 64:
                nxt = by_sid[cur["psid"]]
                if nxt is cur:
                    break
                d_, cur, hops = d_ + 1, nxt, hops + 1
            return d_
        depths_used: set = set()
        for sp in spans:
            depth = depth_of(sp)
            depths_used.add(depth)
            events.append({
                "ph": "X", "pid": pid, "tid": depth,
                "ts": sp["t0"] * 1e6, "dur": max(1.0, sp["dur"] * 1e6),
                "name": str(sp.get("name")),
                "cat": "hvdtrace",
                "args": {"trace": sp["tid"], "span": sp["sid"],
                         "status": sp.get("status", "ok"),
                         **sp.get("attrs", {})},
            })
            emitted.append({**sp, "_pid": pid, "_tid": depth})
        for depth in sorted(depths_used):
            events.append({"ph": "M", "pid": pid, "tid": depth,
                           "name": "thread_name",
                           "args": {"name": f"span depth {depth}"}})
        pid += 1
    # Flow events: one arrow per (batch, request trace) pair, from the
    # request's dispatch slice to the replica's batch-execution slice
    # (falling back to the pool's serve.batch slice when the replica
    # fragment never arrived). Ids are per-pair so N requests sharing
    # one batch each get their own stitch.
    targets: Dict[str, Dict[str, Any]] = {}
    by_sid_all: Dict[str, Dict[str, Any]] = {}
    for sp in emitted:
        by_sid_all.setdefault(sp["sid"], sp)
        if sp.get("name") == "replica.infer_batch" and sp.get("psid"):
            targets.setdefault(sp["psid"], sp)
    for sp in emitted:
        if sp.get("name") != "serve.dispatch":
            continue
        batch = sp.get("attrs", {}).get("batch")
        tgt = targets.get(batch) or by_sid_all.get(batch)
        if tgt is None or tgt is sp:
            continue
        fid = f"{batch}:{sp['tid']}"
        common = {"name": "batch", "cat": "hvdtrace.flow", "id": fid}
        events.append({**common, "ph": "s", "pid": sp["_pid"],
                       "tid": sp["_tid"],
                       "ts": (sp["t0"] + sp["dur"] / 2) * 1e6})
        events.append({**common, "ph": "f", "bp": "e",
                       "pid": tgt["_pid"], "tid": tgt["_tid"],
                       "ts": (tgt["t0"] + tgt["dur"] / 2) * 1e6})
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"displayTimeUnit": "ms", "traceEvents": events}, f)
    os.replace(tmp, path)


# ------------------------------------------------------------------ cli

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.observability.doctor",
        description="Merge per-rank flight-recorder dumps "
                    "(HOROVOD_FLIGHT_DIR and/or the rendezvous KV) into "
                    "one cross-rank postmortem report.")
    p.add_argument("--dir", default=os.environ.get("HOROVOD_FLIGHT_DIR", ""),
                   help="directory of per-rank dumps (<rank>.json) and "
                        "persisted KV tails (default: $HOROVOD_FLIGHT_DIR)")
    p.add_argument("--kv", default="", metavar="HOST:PORT[,HOST:PORT...]",
                   help="scrape flight tails from a live rendezvous "
                        "server (HOROVOD_SECRET_KEY honored from env); "
                        "a comma list names every replica of a "
                        "replicated control plane")
    p.add_argument("--json", action="store_true",
                   help="emit the machine-readable report instead of text")
    p.add_argument("--trace", default="", metavar="PATH",
                   help="also write a Perfetto-compatible trace of every "
                        "merged event (one track per process)")
    p.add_argument("--tail", type=int, default=8,
                   help="events shown per rank in the text report")
    p.add_argument("--max-ranks", type=int, default=256,
                   help="KV scrape probe ceiling when no dump names the "
                        "job size")
    p.add_argument("--rounds", default="", metavar="DIR",
                   help="the perfboard trajectory of benchmark rounds: "
                        "not in the port yet (exits 2; ROADMAP A13)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.rounds:
        print("doctor: --rounds (the perfboard trajectory) waits for the "
              "port's benchmark records: ROADMAP A13, the port's "
              "benchmark PR", file=sys.stderr)
        return 2
    loaded: List[RankDump] = []
    perf: List[Dict[str, Any]] = []
    watch: List[Dict[str, Any]] = []
    traces: List[Dict[str, Any]] = []
    if args.dir:
        loaded.extend(load_dir(args.dir))
        perf.extend(load_perf_dir(args.dir))
        watch.extend(load_watch_dir(args.dir))
        traces.extend(load_trace_dir(args.dir))
    if args.kv:
        from horovod_tpu_torch.runner.rendezvous import (
                                                         HOROVOD_RENDEZVOUS_ADDRS, parse_endpoints)
        try:
            eps = parse_endpoints(args.kv)
        except ValueError:
            eps = []
        if not eps:
            print(f"doctor: bad --kv '{args.kv}' "
                  f"(want HOST:PORT[,HOST:PORT...])", file=sys.stderr)
            return 2
        addr, port = eps[0]
        if len(eps) > 1:
            # Every KVClient built below folds the extra endpoints in
            # (multi-endpoint failover, runner/rendezvous.py): reads
            # against a replicated control plane ride failover too.
            os.environ[HOROVOD_RENDEZVOUS_ADDRS] = \
                ",".join(f"{h}:{p}" for h, p in eps)
        loaded.extend(load_kv(addr, port, max_ranks=args.max_ranks))
        perf.extend(load_perf_kv(addr, port, max_ranks=args.max_ranks))
        watch.extend(load_watch_kv(addr, port, max_ranks=args.max_ranks))
        traces.extend(load_trace_kv(addr, port, max_ranks=args.max_ranks))
    if not args.dir and not args.kv:
        build_parser().print_help(sys.stderr)
        return 2
    dumps = dedupe(loaded)
    if not dumps and not perf and not watch and not traces:
        print("doctor: no flight dumps found (is HOROVOD_FLIGHT_DIR set "
              "on the job, or the rendezvous server still up?)",
              file=sys.stderr)
        return 2
    report = merge(dumps, tail=args.tail, perf=perf, watch=watch,
                   traces=traces)
    if args.trace:
        export_trace(dumps, args.trace, traces=traces)
        print(f"doctor: wrote merged trace to {args.trace}",
              file=sys.stderr)
    if args.json:
        json.dump(report, sys.stdout, indent=2)
        print()
    else:
        print(render(report, tail=args.tail))
    return 0


if __name__ == "__main__":
    sys.exit(main())
