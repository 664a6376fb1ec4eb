"""Deterministic fault injection for the control plane (counterpart of
horovod_tpu/testing/faults.py).

The chaos half of the resilience layer (common/resilience.py): production
code carries tiny `faults.inject("<site>")` hooks at its failure points;
this module decides — from a seeded RNG and a declarative spec — whether a
given hit of a site actually faults. With no spec configured the injector
is inert: `inject` is a single attribute check, so the same code paths run
in production untouched.

Spec format (HOROVOD_FAULT_SPEC): rules separated by ';', fields by ',':

    site=kv.request,kind=connect_refused,p=0.3,count=2
    site=kv.request,kind=http_5xx,p=1.0,after=1,count=3
    site=kv.request,kind=latency,ms=50,p=0.5
    site=discovery.poll,kind=flap,p=0.25
    site=worker.step,kind=crash,after=4,count=1

Fields: `site` (required) names the hook point; `kind` (required) is one of
  connect_refused — raise URLError(ConnectionRefusedError)
  http_5xx        — raise HTTPError(code, default 503)
  latency         — sleep `ms` milliseconds, then continue
  crash           — os._exit(`code`, default 7): a hard worker kill
  flap            — raise FaultInjectedError (e.g. a discovery blink)
  host_kill       — SIGKILL this process's whole PROCESS GROUP: the
                    host-level failure mode (kernel panic, OOM-killer
                    rampage, preemption) that takes the KV replica AND
                    every helper it spawned down together
  partition       — raise URLError(OSError EHOSTUNREACH): a network
                    partition as seen from the caller — transient to
                    RetryPolicy, so it retries/fails over rather than
                    aborting (unlike flap)
`p` is the per-hit probability (default 1.0), `after` skips the first N
hits of the site, `count` caps total injections for the rule, `ms`/`code`
parameterize latency/http_5xx/crash. `match` restricts a rule to hits
whose `context` string (passed by the hook site, e.g. the peer endpoint a
partition should cut) contains the given substring.

Determinism: the RNG is seeded from HOROVOD_FAULT_SEED (default 0), and
each rule draws from its own stream, so the same (spec, seed) replays the
same fault schedule regardless of unrelated sites' traffic.

Hook sites wired in the port: kv.request (runner/rendezvous.py),
discovery.poll (elastic/discovery.py), data.feed.produce
(data/data_loader.py DeviceFeed), kv_ha.put.r<id> and
kv_ha.replicate.r<id> (runner/kv_ha.py: per-replica-id sites, so a
host_kill rule can target exactly the initial primary), and
collective.dispatch (ops/collectives.py `dispatch`, with the context
"rank<r>:<name>", so `match=rank1:bucketed_allreduce` delays one rank's
gradient reduction). Adding one is one line:
`from horovod_tpu_torch.testing import faults; faults.inject("my.site")`.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.common.exceptions import (FaultInjectedError,
                                           HorovodError)

FAULT_SPEC_ENV = "HOROVOD_FAULT_SPEC"
FAULT_SEED_ENV = "HOROVOD_FAULT_SEED"

KINDS = ("connect_refused", "http_5xx", "latency", "crash", "flap",
         "host_kill", "partition")


@dataclasses.dataclass
class FaultRule:
    site: str
    kind: str
    p: float = 1.0
    after: int = 0
    count: Optional[int] = None
    ms: float = 0.0
    code: int = 0
    match: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise HorovodError(
                f"unknown fault kind '{self.kind}' (one of {KINDS})")


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse the HOROVOD_FAULT_SPEC rule list (see module docstring)."""
    rules: List[FaultRule] = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        fields: Dict[str, str] = {}
        for part in chunk.split(","):
            if "=" not in part:
                raise HorovodError(
                    f"bad fault rule field '{part}' in '{chunk}' "
                    f"(expected key=value)")
            k, v = part.split("=", 1)
            fields[k.strip()] = v.strip()
        if "site" not in fields or "kind" not in fields:
            raise HorovodError(
                f"fault rule '{chunk}' needs site= and kind=")
        rules.append(FaultRule(
            site=fields["site"], kind=fields["kind"],
            p=float(fields.get("p", "1.0")),
            after=int(fields.get("after", "0")),
            count=int(fields["count"]) if "count" in fields else None,
            ms=float(fields.get("ms", "0")),
            code=int(fields.get("code", "0")),
            match=fields.get("match", "")))
    return rules


class FaultInjector:
    """Seeded, rule-driven fault source.

    Each rule gets an independent RNG stream derived from (seed, rule
    index), so adding a rule never perturbs another rule's schedule.
    Counters (`hits`, `injected`) are public for test assertions.
    """

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        # Per-rule streams from an integer mix (tuple seeding is deprecated
        # and str hashing would be PYTHONHASHSEED-dependent).
        self._rngs = [random.Random(seed * 2654435761 + i)
                      for i in range(len(rules))]
        self._lock = threading.Lock()
        self.hits: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}
        self._fired: List[int] = [0] * len(rules)

    @staticmethod
    def from_env() -> Optional["FaultInjector"]:
        spec = os.environ.get(FAULT_SPEC_ENV, "").strip()
        if not spec:
            return None
        seed = int(os.environ.get(FAULT_SEED_ENV, "0") or 0)
        return FaultInjector(parse_spec(spec), seed=seed)

    def _pick(self, site: str,
              context: Optional[str] = None) -> Optional[FaultRule]:
        """Decide (under the lock) which rule, if any, fires for this hit."""
        with self._lock:
            hit_no = self.hits.get(site, 0)
            self.hits[site] = hit_no + 1
            for i, r in enumerate(self.rules):
                if r.site != site:
                    continue
                if r.match and r.match not in (context or ""):
                    continue
                if hit_no < r.after:
                    continue
                if r.count is not None and self._fired[i] >= r.count:
                    continue
                if self._rngs[i].random() >= r.p:
                    continue
                self._fired[i] += 1
                self.injected[site] = self.injected.get(site, 0) + 1
                return r
            return None

    def fire(self, site: str, context: Optional[str] = None) -> None:
        r = self._pick(site, context)
        if r is None:
            return
        if r.kind == "latency":
            time.sleep(r.ms / 1000.0)
            return
        if r.kind == "connect_refused":
            import urllib.error
            raise urllib.error.URLError(
                ConnectionRefusedError(
                    f"[fault-injected] connection refused at {site}"))
        if r.kind == "http_5xx":
            import email.message
            import urllib.error
            code = r.code or 503
            raise urllib.error.HTTPError(
                f"fault://{site}", code, "[fault-injected] server error",
                email.message.Message(), None)
        if r.kind == "flap":
            raise FaultInjectedError(f"[fault-injected] flap at {site}")
        if r.kind == "crash":
            os._exit(r.code or 7)
        if r.kind == "partition":
            import urllib.error
            raise urllib.error.URLError(
                OSError(113,  # EHOSTUNREACH: transient to RetryPolicy
                        f"[fault-injected] partition at {site}"
                        + (f" ({context})" if context else "")))
        if r.kind == "host_kill":
            import signal
            # The whole process GROUP, exactly what `kill -9 -PID` at a
            # dying host does: the replica, its HTTP threads, and any
            # children all vanish without cleanup handlers running.
            os.killpg(os.getpgrp(), signal.SIGKILL)


# Process-wide injector: parsed from env once at import (workers launched
# with HOROVOD_FAULT_SPEC in their env pick it up automatically); tests
# swap it in-process via install()/uninstall().
_injector: Optional[FaultInjector] = FaultInjector.from_env()


def get() -> Optional[FaultInjector]:
    return _injector


def install(injector: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Set the process-wide injector; returns the previous one."""
    global _injector
    prev, _injector = _injector, injector
    return prev


def uninstall() -> None:
    install(None)


def inject(site: str, context: Optional[str] = None) -> None:
    """Production hook: no-op (one attribute check) unless an injector is
    active. `context` lets `match=` rules target a specific hit — e.g.
    the peer endpoint a partition rule should cut."""
    if _injector is not None:
        _injector.fire(site, context)
