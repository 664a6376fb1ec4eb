"""``hvdtop``: live operator view of a running job (counterpart of
horovod_tpu/observability/top.py: the same parsing, snapshot and
screen).

    python -m horovod_tpu_torch.observability.top --addr HOST:PORT
    python -m horovod_tpu_torch.observability.top --addr HOST:PORT --once --json

One screen answers "is the fleet healthy right now": per-rank step
time, phase split, MFU, serve queue depth, elastic round, and the
anomalies hvdwatch has active — refreshed every ``--interval`` seconds
(the metrics-exporter cadence is the natural floor).

Data comes from the two surfaces a live job already exposes on its
rendezvous server (no new worker-side machinery):

* the read-only ``GET /metrics`` Prometheus route — job-wide
  gauges/counters with a ``rank`` label per series,
* the ``perf`` / ``flight`` / ``watch`` / ``trace`` KV scopes —
  per-rank perfscope summaries (wall percentiles, phase split, MFU),
  flight-recorder tails (elastic round, last event), hvdwatch anomaly
  records and hvdtrace span tails (sampled request/step traces with
  the slowest trace's duration), scraped with the same round-bounded
  probing ``hvddoctor --kv`` uses.

``--once --json`` emits the merged snapshot as machine-readable JSON
for scripting (the watch-smoke e2e drives it this way). KV reads are
HMAC-signed from ``HOROVOD_SECRET_KEY`` when set — launch the job with
the key pre-set (the launchers honor it) to point hvdtop at it from
another shell. The ``/metrics`` route needs no key.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

#: One parsed Prometheus page: {metric name: [(labels, value), ...]}.
MetricsDoc = Dict[str, List[Tuple[Dict[str, str], float]]]

_SERIES_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)\s*$')
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_metrics_text(text: str) -> MetricsDoc:
    """Parse Prometheus exposition text (the subset render_snapshots
    emits: no timestamps, no exemplars) into a name -> series map."""
    out: MetricsDoc = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SERIES_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = {k: v.replace('\\"', '"').replace("\\\\", "\\")
                  for k, v in _LABEL_RE.findall(m.group("labels") or "")}
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


def series_by_rank(doc: MetricsDoc, name: str,
                   **want: str) -> Dict[int, float]:
    """{rank: value} for one metric, optionally filtered on other
    labels (series without a rank label are skipped)."""
    out: Dict[int, float] = {}
    for labels, value in doc.get(name, []):
        if any(labels.get(k) != v for k, v in want.items()):
            continue
        r = labels.get("rank", "")
        if r.isdigit():
            out[int(r)] = value
    return out


def fetch_metrics(addr: str, port: int, timeout: float = 5.0
                  ) -> MetricsDoc:
    import urllib.request
    with urllib.request.urlopen(
            f"http://{addr}:{port}/metrics", timeout=timeout) as resp:
        return parse_metrics_text(resp.read().decode("utf-8", "replace"))


# ------------------------------------------------------------- snapshot

def snapshot(addr: str, port: int, max_ranks: int = 256) -> Dict[str, Any]:
    """One merged view of the live job. Every source is best-effort:
    a job mid-reset (or a scrape racing shutdown) yields a partial
    snapshot, never an exception."""
    from horovod_tpu_torch.observability import doctor
    snap: Dict[str, Any] = {"time": time.time(),
                            "addr": f"{addr}:{port}",
                            "errors": []}
    try:
        metrics = fetch_metrics(addr, port)
    except Exception as e:
        metrics = {}
        snap["errors"].append(f"/metrics: {e}")
    try:
        perf = doctor.dedupe_perf(
            doctor.load_perf_kv(addr, port, max_ranks=max_ranks))
    except Exception as e:
        perf = []
        snap["errors"].append(f"perf scope: {e}")
    try:
        watch = doctor.dedupe_watch(
            doctor.load_watch_kv(addr, port, max_ranks=max_ranks))
    except Exception as e:
        watch = []
        snap["errors"].append(f"watch scope: {e}")
    try:
        tails = doctor.dedupe(
            doctor.load_kv(addr, port, max_ranks=max_ranks))
    except Exception as e:
        tails = []
        snap["errors"].append(f"flight scope: {e}")
    try:
        traces = doctor.dedupe_trace(
            doctor.load_trace_kv(addr, port, max_ranks=max_ranks))
    except Exception as e:
        traces = []
        snap["errors"].append(f"trace scope: {e}")

    ranks: Dict[int, Dict[str, Any]] = {}

    def row(rank: int) -> Dict[str, Any]:
        return ranks.setdefault(rank, {"rank": rank, "round": 0})

    # The current round per rank is the highest any source reports —
    # earlier rounds' records are history, not state.
    latest: Dict[int, int] = {}
    for rec in perf + watch + traces:
        if rec.get("rank") is None:
            continue
        r, rnd = int(rec["rank"]), int(rec.get("round", 0) or 0)
        latest[r] = max(latest.get(r, 0), rnd)
    for d in tails:
        if d.rank is not None:
            latest[d.rank] = max(latest.get(d.rank, 0), d.round)

    for rec in perf:
        if rec.get("rank") is None \
                or int(rec.get("round", 0) or 0) \
                != latest.get(int(rec["rank"]), 0):
            continue
        s = rec.get("summary") or {}
        wall = s.get("wall") or {}
        info = row(int(rec["rank"]))
        info.update({
            "round": int(rec.get("round", 0) or 0),
            "steps": s.get("steps"),
            "step_ms": {
                "mean": (wall.get("mean_s") or 0) * 1e3,
                "p50": (wall.get("p50_s") or 0) * 1e3,
                "p95": (wall.get("p95_s") or 0) * 1e3,
            },
            "local_ms": (s.get("local_mean_s") or 0) * 1e3,
            "mfu": s.get("mfu"),
            "mfu_source": s.get("mfu_source"),
            "dominant_phase": s.get("dominant_phase"),
            "phase_fractions": s.get("phase_fractions") or {},
        })
    for rec in watch:
        if rec.get("rank") is None \
                or int(rec.get("round", 0) or 0) \
                != latest.get(int(rec["rank"]), 0):
            continue
        info = row(int(rec["rank"]))
        info["anomalies"] = rec.get("counts") or {}
        info["active_anomalies"] = rec.get("active") or []
    for rec in traces:
        if rec.get("rank") is None \
                or int(rec.get("round", 0) or 0) \
                != latest.get(int(rec["rank"]), 0):
            continue
        info = row(int(rec["rank"]))
        ts_list = rec.get("traces") or []
        done = [t for t in ts_list if t.get("done")]
        slowest = max((float(t.get("dur") or 0.0) for t in done),
                      default=None)
        errored = sum(1 for t in ts_list
                      for sp in t.get("spans", [])
                      if sp.get("status") != "ok")
        info["traces"] = {
            "sampled": len(ts_list),
            "done": len(done),
            "errored_spans": errored,
            "slowest_ms": (slowest * 1e3
                           if slowest is not None else None),
        }
    for d in tails:
        if d.rank is None or d.round != latest.get(d.rank, 0):
            continue
        info = row(d.rank)
        info["round"] = max(info.get("round", 0), d.round)
        last = d.last_event()
        if last:
            info["last_event"] = doctor._fmt_event(last)
    # Gauges from the Prometheus page fill anything the KV scopes did
    # not cover (and serve-tier depth, which only lives here).
    for r, v in series_by_rank(metrics, "horovod_mfu").items():
        row(r).setdefault("mfu", v)
    for r, v in series_by_rank(metrics,
                               "horovod_serve_queue_depth").items():
        row(r)["queue_depth"] = v
    # Job-level queue depth (the serve frontend runs in the launcher
    # process, whose series carries no rank label).
    for labels, v in metrics.get("horovod_serve_queue_depth", []):
        if "rank" not in labels:
            snap["queue_depth"] = v

    active_all: List[str] = []
    total = 0
    for info in ranks.values():
        total += sum((info.get("anomalies") or {}).values())
        for a in info.get("active_anomalies") or []:
            active_all.append(f"rank{info['rank']}:{a}")
    snap["ranks"] = {str(r): ranks[r] for r in sorted(ranks)}
    snap["job"] = {
        "size": len(ranks),
        "round": max(latest.values()) if latest else 0,
        "anomalies_total": total,
        "active_anomalies": sorted(active_all),
    }
    return snap


# --------------------------------------------------------------- render

def _fmt_ms(v: Optional[float]) -> str:
    return f"{v:8.1f}" if isinstance(v, (int, float)) else "       -"


def render(snap: Dict[str, Any]) -> str:
    job = snap.get("job") or {}
    out: List[str] = []
    add = out.append
    ts = time.strftime("%H:%M:%S", time.localtime(snap.get("time", 0)))
    anom = job.get("anomalies_total", 0)
    health = "OK" if not job.get("active_anomalies") else \
        "ANOMALY: " + ", ".join(job["active_anomalies"])
    add(f"hvdtop — {snap.get('addr')} at {ts} · "
        f"{job.get('size', 0)} rank(s) · round {job.get('round', 0)} · "
        f"{anom} anomaly(ies) · {health}")
    if snap.get("queue_depth") is not None:
        add(f"serve queue depth: {snap['queue_depth']:.0f}")
    add("")
    add(f"{'RANK':>4} {'RD':>3} {'STEPS':>7} {'STEP ms':>8} "
        f"{'P95 ms':>8} {'LOCAL ms':>8} {'MFU':>6} "
        f"{'DOMINANT':>14} {'QUEUE':>5}  ANOMALIES")
    for _, info in sorted(snap.get("ranks", {}).items(),
                          key=lambda kv: int(kv[0])):
        step = info.get("step_ms") or {}
        mfu = info.get("mfu")
        active = info.get("active_anomalies") or []
        counts = info.get("anomalies") or {}
        ann = ",".join(f"{k}!" for k in active) or \
            (",".join(f"{k}:{v}" for k, v in sorted(counts.items()))
             if counts else "-")
        q = info.get("queue_depth")
        add(f"{info['rank']:>4} {info.get('round', 0):>3} "
            f"{str(info.get('steps', '-')):>7} "
            f"{_fmt_ms(step.get('mean'))} {_fmt_ms(step.get('p95'))} "
            f"{_fmt_ms(info.get('local_ms'))} "
            f"{(f'{mfu:.3f}' if isinstance(mfu, (int, float)) else '-'):>6} "
            f"{str(info.get('dominant_phase') or '-'):>14} "
            f"{(f'{q:.0f}' if isinstance(q, (int, float)) else '-'):>5}  "
            f"{ann}")
        frac = info.get("phase_fractions") or {}
        if frac:
            split = " ".join(f"{k}={v:.0%}" for k, v in
                             sorted(frac.items(), key=lambda kv: -kv[1])
                             if v >= 0.01)
            add(f"{'':>9}{split}")
        tr = info.get("traces") or {}
        if tr.get("sampled"):
            slow = tr.get("slowest_ms")
            line = (f"{'':>9}traces: {tr['sampled']} sampled "
                    f"({tr.get('done', 0)} done)")
            if isinstance(slow, (int, float)):
                line += f", slowest {slow:.1f} ms"
            if tr.get("errored_spans"):
                line += f", {tr['errored_spans']} errored span(s)"
            add(line)
        if info.get("last_event"):
            add(f"{'':>9}last: {info['last_event']}")
    for e in snap.get("errors") or []:
        add(f"! {e}")
    return "\n".join(out)


# ------------------------------------------------------------------ cli

def _default_addr() -> str:
    from horovod_tpu_torch.common import config as C
    addr = os.environ.get(C.HOROVOD_RENDEZVOUS_ADDR, "")
    port = os.environ.get(C.HOROVOD_RENDEZVOUS_PORT, "")
    if addr and port:
        return f"{addr}:{port}"
    path = os.environ.get("HOROVOD_RENDEZVOUS_PORT_FILE", "")
    if path:
        from horovod_tpu_torch.runner.rendezvous import read_endpoints
        try:
            # Either announcement format: legacy bare port, or the
            # "host:port[,host:port...]" replica list (runner/kv_ha.py);
            # the primary is announced first.
            eps = read_endpoints(path)
            if eps:
                return ",".join(f"{h}:{p}" for h, p in eps)
        except (OSError, ValueError):
            pass
    return ""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.observability.top",
        description="Live per-rank fleet view of a running job "
                    "(step time, phase split, MFU, queue depth, "
                    "elastic round, active hvdwatch anomalies).")
    p.add_argument("--addr", default=_default_addr(),
                   metavar="HOST:PORT[,HOST:PORT...]",
                   help="rendezvous server (default: "
                        "$HOROVOD_GLOO_RENDEZVOUS_ADDR:PORT, or "
                        "$HOROVOD_RENDEZVOUS_PORT_FILE); a comma list "
                        "names every replica of a replicated control "
                        "plane")
    p.add_argument("--once", action="store_true",
                   help="render one snapshot and exit")
    p.add_argument("--json", action="store_true",
                   help="emit the snapshot as JSON (implies one-shot "
                        "semantics per refresh)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh interval in seconds (live mode)")
    p.add_argument("--max-ranks", type=int, default=256,
                   help="KV scrape probe ceiling")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.addr:
        print("hvdtop: no --addr and no rendezvous env/port-file to "
              "discover one from", file=sys.stderr)
        return 2
    from horovod_tpu_torch.runner.rendezvous import (HOROVOD_RENDEZVOUS_ADDRS,
                                                     parse_endpoints)
    try:
        eps = parse_endpoints(args.addr)
    except ValueError:
        eps = []
    if not eps:
        print(f"hvdtop: bad --addr '{args.addr}' "
              f"(want HOST:PORT[,HOST:PORT...])", file=sys.stderr)
        return 2
    addr, port = eps[0]
    if len(eps) > 1:
        # The KVClients built inside snapshot() fold the extra
        # endpoints in (multi-endpoint failover, runner/rendezvous.py).
        os.environ[HOROVOD_RENDEZVOUS_ADDRS] = \
            ",".join(f"{h}:{p}" for h, p in eps)
    while True:
        snap = snapshot(addr, int(port), max_ranks=args.max_ranks)
        if args.json:
            json.dump(snap, sys.stdout)
            print()
        else:
            if not args.once:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print(render(snap))
        if args.once or args.json:
            return 0 if snap.get("ranks") else 1
        try:
            time.sleep(max(args.interval, 0.2))
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
