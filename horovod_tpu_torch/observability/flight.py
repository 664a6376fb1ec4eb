"""Always-on cross-rank flight recorder, HOROVOD_FLIGHT (counterpart of
horovod_tpu/observability/flight.py; the dump format is the JAX
package's).

Every rank keeps a fixed-size ring of structured runtime events, one
append per event, covering:
* every collective dispatch (per-process-set call index, descriptor,
  name; recorded at the collectives' dispatch choke point,
  ops/collectives.py `dispatch`);
* elastic rounds and worker exits, checkpoint saves and restores, the
  tuners' threshold moves;
* meaningful rendezvous-KV operations (runner/rendezvous.py;
  zero-timeout background polls are not recorded);
* retry, circuit-breaker and stall events.

Dumps fire on the failure paths that end a run (the stall watchdog's
shutdown raise, a CollectiveDivergenceError, a fatal
HorovodInternalError), on SIGUSR1 and at interpreter exit. Each rank
writes an atomic local dump to ``HOROVOD_FLIGHT_DIR/<rank>.json`` and
pushes a compact tail to the launcher's rendezvous KV (scope
``flight``), which the launcher persists at the job's end
(`persist_kv_tails`), so a SIGKILL'd worker still leaves its last tail.
The exporter thread refreshes the tail on its cadence. hvddoctor
(observability/doctor.py) merges the dumps and tails offline into one
story of the job.

Knobs: ``HOROVOD_FLIGHT=0`` disables (a no-op shell, as
``HOROVOD_METRICS=0``); ``HOROVOD_FLIGHT_DIR`` is where dumps land;
``HOROVOD_FLIGHT_CAPACITY`` sizes the ring; ``HOROVOD_FLIGHT_KV_TAIL``
sizes the pushed tail.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

FLIGHT_ENV = "HOROVOD_FLIGHT"
FLIGHT_DIR_ENV = "HOROVOD_FLIGHT_DIR"
FLIGHT_CAPACITY_ENV = "HOROVOD_FLIGHT_CAPACITY"
FLIGHT_KV_TAIL_ENV = "HOROVOD_FLIGHT_KV_TAIL"

#: Rendezvous-KV scope the compact tails are pushed under.
SCOPE = "flight"

DEFAULT_CAPACITY = 4096
DEFAULT_KV_TAIL = 64

#: Schema tag written into every dump so the doctor can reject files it
#: does not understand instead of mis-merging them.
DUMP_VERSION = 1

# Reentrancy guard: the KV tail push itself goes through KVClient, whose
# instrumentation would otherwise record the push as a "kv" event (and a
# failing push could recurse through the resilience hooks).
_tls = threading.local()


def suppressed() -> bool:
    """True while this thread is inside a dump/push — instrumentation
    hooks must not record their own flush traffic."""
    return getattr(_tls, "busy", False)


class _Suppress:
    def __enter__(self):
        _tls.busy = True
        return self

    def __exit__(self, *exc):
        _tls.busy = False
        return False


from horovod_tpu_torch.common.config import _env_on  # one copy of the gate parse


class FlightRecorder:
    """Bounded ring of structured runtime events + dump machinery.

    ``record``/``record_collective`` are the hot path: one slot write
    and a counter bump under a short lock. Everything slow — JSON
    encoding, file IO, the KV push, stack capture — happens only at
    dump time, outside the ring lock (HVD103: never block under it).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 kv_tail: int = DEFAULT_KV_TAIL) -> None:
        self.capacity = max(16, capacity)
        self.kv_tail = max(1, kv_tail)
        self._lock = threading.Lock()
        self._events: List[Optional[tuple]] = \
            [None] * self.capacity  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        # per-process-set collective call counters (the doctor aligns
        # ranks by this index, immune to ring wraparound). Reset at
        # every elastic round adoption: ranks are reassigned across
        # rounds, so call indices are only comparable WITHIN one.
        self._coll_counts: Dict[int, int] = {}  # guarded-by: _lock
        # Current elastic round + the rank this process held in each
        # round it lived through — what lets the doctor attribute a
        # multi-round dump's events to the right rank per round.
        v = os.environ.get("HOROVOD_ELASTIC_ROUND", "")
        self._round = int(v) if v.strip().isdigit() else 0  # guarded-by: _lock
        self._round_ranks: Dict[int, Optional[int]] = {}  # guarded-by: _lock
        self._kv = None
        self._kv_dead = False
        self.last_dump_path: Optional[str] = None
        self.last_trigger: Optional[str] = None
        self.last_dump_monotonic: Optional[float] = None

    # ------------------------------------------------------------ record
    def record(self, kind: str, desc: str) -> None:
        """Append one generic event: (seq, wall-time, kind, desc)."""
        t = time.time()
        with self._lock:
            self._events[self._seq % self.capacity] = \
                (self._seq, t, kind, desc)
            self._seq += 1

    def record_collective(self, group_id: int, desc: str,
                          name: str = "") -> None:
        """Append one collective dispatch with its per-group call index
        and the elastic round it happened in.

        `desc` is the already-formatted op signature the dispatch choke
        point built for the consistency/fingerprint checkers — no extra
        formatting happens here.
        """
        t = time.time()
        with self._lock:
            idx = self._coll_counts.get(group_id, 0)
            self._coll_counts[group_id] = idx + 1
            self._events[self._seq % self.capacity] = \
                (self._seq, t, "collective", desc, name, group_id, idx,
                 self._round)
            self._seq += 1

    def set_round(self, round_id: int, rank: Optional[int] = None) -> None:
        """Adopt a new elastic round: fresh per-group call indices (rank
        assignments changed, so cross-rank alignment restarts) and the
        round→rank mapping for the doctor."""
        with self._lock:
            self._round = round_id
            self._coll_counts = {}
            self._round_ranks[round_id] = rank

    # ---------------------------------------------------------- snapshot
    def snapshot(self, tail: Optional[int] = None) -> List[tuple]:
        """Retained events, oldest first (optionally only the last
        `tail`)."""
        with self._lock:
            seq = self._seq
            lo = max(0, seq - self.capacity)
            if tail is not None:
                lo = max(lo, seq - tail)
            return [self._events[i % self.capacity] for i in range(lo, seq)]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            seq = self._seq
            return {"recorded": seq,
                    "dropped": max(0, seq - self.capacity),
                    "collective_calls": sum(self._coll_counts.values())}

    # -------------------------------------------------------------- dump
    @staticmethod
    def dump_dir() -> str:
        return os.environ.get(FLIGHT_DIR_ENV, "")

    def _identity(self) -> Dict[str, Any]:
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
        return {
            "rank": rank,
            "size": size,
            "elastic_round": os.environ.get("HOROVOD_ELASTIC_ROUND", ""),
            "hostname": os.environ.get("HOROVOD_HOSTNAME", ""),
            "pid": os.getpid(),
        }

    @staticmethod
    def _thread_stacks() -> Dict[str, List[str]]:
        """Formatted stack per live thread — who was blocked where."""
        names = {t.ident: t.name for t in threading.enumerate()}
        stacks: Dict[str, List[str]] = {}
        for ident, frame in sys._current_frames().items():
            tag = f"{names.get(ident, '?')}-{ident}"
            stacks[tag] = [ln.rstrip()
                           for ln in traceback.format_stack(frame)]
        return stacks

    def payload(self, trigger: str,
                tail: Optional[int] = None,
                stacks: bool = True) -> Dict[str, Any]:
        body = self._identity()
        with self._lock:
            round_id = self._round
            # The current round's rank is whatever identity resolved
            # NOW — persist it, so a LATER dump (after an elastic reset
            # reassigned this process a new rank) can still attribute
            # this round's events to the rank held back then.
            if body.get("rank") is not None:
                self._round_ranks[round_id] = body.get("rank")
            rounds = dict(self._round_ranks)
        rounds.setdefault(round_id, body.get("rank"))
        body.update(self.stats())
        body.update({
            "version": DUMP_VERSION,
            "trigger": trigger,
            "wall_time": time.time(),
            "round": round_id,
            "rounds": {str(r): rk for r, rk in rounds.items()},
            "events": [list(e) for e in self.snapshot(tail)
                       if e is not None],
        })
        if stacks:
            try:
                body["stacks"] = self._thread_stacks()
            except Exception:
                body["stacks"] = {}
        return body

    def dump(self, trigger: str, push_kv: bool = True) -> Optional[str]:
        """Write the atomic local dump (when HOROVOD_FLIGHT_DIR is set)
        and best-effort push the compact KV tail. Never raises: the
        recorder rides failure paths that must stay failable."""
        if suppressed():
            return self.last_dump_path
        with _Suppress():
            self.last_trigger = trigger
            self.last_dump_monotonic = time.monotonic()
            path = None
            d = self.dump_dir()
            if d:
                body = self.payload(trigger)
                ident = body.get("rank")
                # Static jobs: the spec'd <rank>.json. Elastic rounds
                # get a .r<round> suffix — rank numbers are REUSED
                # across rounds, and a later process's clean atexit
                # dump must never overwrite a dead rank's failure
                # evidence (same aliasing the KV tails round-key for).
                stem = f"{ident if ident is not None else os.getpid()}"
                if body.get("round"):
                    stem += f".r{body['round']}"
                path = os.path.join(d, f"{stem}.json")
                try:
                    os.makedirs(d, exist_ok=True)
                    tmp = f"{path}.tmp.{os.getpid()}"
                    with open(tmp, "w") as f:
                        json.dump(body, f)
                    os.replace(tmp, path)
                    self.last_dump_path = path
                except OSError:
                    path = None
            if push_kv:
                self._push_tail_locked_out(trigger)
            return path

    def dump_hint(self) -> str:
        """One-line pointer appended to watchdog/verifier errors so the
        operator knows where the evidence went ('' when there is no
        local dump to point at)."""
        p = self.last_dump_path
        if not p:
            return ""
        return (f"; flight recorder dump: {p} (merge with "
                f"`python -m horovod_tpu_torch.observability.doctor --dir "
                f"{os.path.dirname(p)}`)")

    # ---------------------------------------------------------- KV tail
    def _kv_client(self):
        if self._kv is None and not self._kv_dead:
            try:
                from horovod_tpu_torch.common import config as C
                from horovod_tpu_torch.common.resilience import RetryPolicy
                from horovod_tpu_torch.runner.rendezvous import KVClient
                addr = os.environ.get(C.HOROVOD_RENDEZVOUS_ADDR, "")
                port = os.environ.get(C.HOROVOD_RENDEZVOUS_PORT, "")
                if not addr or not port:
                    self._kv_dead = True
                    return None
                # Single-attempt, tightly bounded: the tail push rides
                # failure paths and the exporter tick — a rendezvous
                # blip must cost ~2s once, not a retry schedule.
                self._kv = KVClient(addr, int(port),
                                    retry_policy=RetryPolicy(max_attempts=1),
                                    request_timeout=2.0)
            except Exception:
                self._kv_dead = True
        return self._kv

    def _push_tail_locked_out(self, trigger: str) -> bool:
        kv = self._kv_client()
        if kv is None:
            return False
        body = self.payload(trigger, tail=self.kv_tail, stacks=False)
        if body.get("rank") is None:
            return False  # mid-reset: an unkeyable tail would linger
        # Keyed by (rank, round): elastic resets REUSE rank numbers, so
        # a flat rank key would let a surviving worker's next-round tail
        # clobber the dead rank's last evidence — the one artifact the
        # whole KV-tail path exists to preserve.
        try:
            kv.put(SCOPE, f"rank-{body['rank']}.r{body['round']}",
                   json.dumps(body).encode("utf-8"))
            return True
        except Exception:
            return False

    def push_tail(self, trigger: str = "tick") -> bool:
        """Best-effort compact-tail push (exporter cadence + dump
        triggers). Returns True when the put landed."""
        if suppressed():
            return False
        with _Suppress():
            return self._push_tail_locked_out(trigger)


class _NoopRecorder:
    """HOROVOD_FLIGHT=0 shell: every hook is a cheap no-op."""

    capacity = 0
    last_dump_path = None
    last_trigger = None

    def record(self, kind: str, desc: str) -> None:
        pass

    def record_collective(self, group_id: int, desc: str,
                          name: str = "") -> None:
        pass

    def set_round(self, round_id: int, rank: Optional[int] = None) -> None:
        pass

    def snapshot(self, tail: Optional[int] = None) -> List[tuple]:
        return []

    def stats(self) -> Dict[str, int]:
        return {"recorded": 0, "dropped": 0, "collective_calls": 0}

    def dump(self, trigger: str, push_kv: bool = True) -> Optional[str]:
        return None

    def dump_hint(self) -> str:
        return ""

    def push_tail(self, trigger: str = "tick") -> bool:
        return False


NOOP = _NoopRecorder()

_recorder: Optional[object] = None
_recorder_lock = threading.Lock()
_atexit_installed = False
_sigusr1_installed = False


def enabled() -> bool:
    return _env_on(FLIGHT_ENV, True)


def _install_process_hooks() -> None:
    """SIGUSR1 + interpreter-exit triggers.

    atexit installs from any thread, once. signal.signal only works on
    the MAIN thread — and the first flight event can come from a
    background one (exporter tick, stall watcher, launcher round loop)
    — so the SIGUSR1 install is retried from get() until a main-thread
    call lands it, instead of being lost forever on the first miss.
    """
    global _atexit_installed, _sigusr1_installed
    if not _atexit_installed:
        _atexit_installed = True

        def _atexit_dump() -> None:
            r = _recorder
            if isinstance(r, FlightRecorder) and r.dump_dir():
                # No KV push at exit: the rendezvous server may already
                # be gone and the 2s transport cap would tax every
                # clean exit.
                r.dump("atexit", push_kv=False)

        atexit.register(_atexit_dump)
    if not _sigusr1_installed:
        try:
            import signal

            prev = signal.getsignal(signal.SIGUSR1)

            def _on_sigusr1(signum, frame):
                r = _recorder
                if isinstance(r, FlightRecorder):
                    r.dump("sigusr1")
                # A handler installed before this one (another package's
                # recorder in the same process) still gets the signal.
                if callable(prev):
                    prev(signum, frame)

            signal.signal(signal.SIGUSR1, _on_sigusr1)
            _sigusr1_installed = True
        except (ValueError, AttributeError, OSError):
            pass  # non-main thread / platform without SIGUSR1: retry


def get():
    """The process-wide recorder (NOOP shell under HOROVOD_FLIGHT=0)."""
    global _recorder
    r = _recorder
    if r is not None:
        if not _sigusr1_installed and r is not NOOP \
                and threading.current_thread() is threading.main_thread():
            _install_process_hooks()
        return r
    with _recorder_lock:
        if _recorder is None:
            if not enabled():
                _recorder = NOOP
            else:
                cap = DEFAULT_CAPACITY
                tail = DEFAULT_KV_TAIL
                try:
                    cap = int(os.environ.get(FLIGHT_CAPACITY_ENV, "")
                              or cap)
                    tail = int(os.environ.get(FLIGHT_KV_TAIL_ENV, "")
                               or tail)
                except ValueError:
                    pass
                _install_process_hooks()
                _recorder = FlightRecorder(capacity=cap, kv_tail=tail)
        return _recorder


def record(kind: str, desc: str) -> None:
    """Module-level hot-path hook: one append (no-op when disabled or
    while a dump is flushing on this thread)."""
    if suppressed():
        return
    get().record(kind, desc)


def record_collective(group_id: int, desc: str, name: str = "") -> None:
    if suppressed():
        return
    get().record_collective(group_id, desc, name)


def set_round(round_id: int, rank: Optional[int] = None) -> None:
    """Adopt a new elastic round (called from the elastic reset path)."""
    get().set_round(round_id, rank)


def dump(trigger: str, push_kv: bool = True) -> Optional[str]:
    return get().dump(trigger, push_kv=push_kv)


def dump_if_stale(trigger: str, max_age: float = 10.0) -> Optional[str]:
    """Dump unless one happened within `max_age` seconds.

    For catch-all handlers (the elastic retry loop) sitting downstream
    of raising sites that already dumped with a more specific trigger
    (stall watchdog, comm failure): re-dumping would overwrite that
    trigger and pay a second file write + KV push per recovery, while
    an error that arrived WITHOUT a site dump still gets captured.
    """
    r = get()
    last = getattr(r, "last_dump_monotonic", None)
    if last is not None and time.monotonic() - last < max_age:
        return r.last_dump_path
    return r.dump(trigger)


def dump_hint() -> str:
    return get().dump_hint()


def push_tail(trigger: str = "tick") -> bool:
    return get().push_tail(trigger)


def reset_for_tests() -> None:
    """Drop the process-wide recorder so the next get() re-reads env.
    The atexit/SIGUSR1 hooks stay installed (they re-resolve the
    current recorder at fire time)."""
    global _recorder
    with _recorder_lock:
        _recorder = None


def persist_kv_tails(store, out_dir: Optional[str] = None) -> List[str]:
    """Launcher-side: write every pushed `flight/` tail the rendezvous
    server is holding to `out_dir` as `kv-tail-rank-<r>.json`, so tails
    from SIGKILL'd workers survive the server's shutdown and the doctor
    can merge them offline. `store` is the RendezvousServer (or any
    object with `scope_items(scope) -> Dict[str, bytes]`)."""
    out_dir = out_dir or os.environ.get(FLIGHT_DIR_ENV, "")
    if not out_dir:
        return []
    try:
        items = store.scope_items(SCOPE)
    except Exception:
        return []
    written: List[str] = []
    for key, raw in sorted(items.items()):
        # key is "rank-<r>.r<round>" (round-keyed — see
        # _push_tail_locked_out)
        safe = key.replace("/", "_")
        path = os.path.join(out_dir, f"kv-tail-{safe}.json")
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
