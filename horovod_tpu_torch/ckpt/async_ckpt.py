"""Two-phase async checkpointer (counterpart of
horovod_tpu/ckpt/async_ckpt.py): host snapshot on the step boundary,
serialization and atomic commit on a background writer thread.

The CheckFreq split (FAST '21): phase 1 (``snapshot``) is the only part
on the training critical path, a device-to-host copy of the tree
(ckpt/sharded.py) attributed to perfscope's ``checkpoint`` phase, so
its cost is measured per step. Phase 2 (``persist`` + ``commit``) runs
on a daemon writer thread: `.npy` shard files, `objects.pkl`, the
manifest, and last the atomic ``ckpt-<step>.done`` commit marker
(ckpt/manifest.py owns the crash-consistency protocol).

Back-pressure is skip-and-count, never stall: the writer queue is
bounded (HOROVOD_CKPT_QUEUE, default 1: at most one save in flight); a
save arriving while the writer is busy is dropped and counted in
``skipped``. A slow persist tier costs checkpoint freshness, never step
time.

After each commit the writer publishes a ``ckpt/latest`` pointer to the
rendezvous KV (scope ``ckpt``), so elastic ranks can see the newest
generation without scanning a shared filesystem.

Multi-writer saves: every writer persists its own shards (its
`Fragment` leaves, and the replicated leaves on the primary only);
non-primary writers publish their manifest fragment under ``ckpt`` key
``writer/<step>/<rank>`` and the primary merges all fragments and
checks that they cover every leaf before it writes the manifest and
the marker, so the commit has exactly one author. The primary aborts
the commit (leaving a marker-less dir that the stale sweep later
quarantines) if a fragment does not arrive within
HOROVOD_CKPT_COMMIT_TIMEOUT.

Every save, skip, persist, commit and error is counted in the metrics
registry (`horovod_ckpt_*`, the JAX package's families) and recorded
as a flight-recorder `ckpt` event tagged with the rank and round
(observability/); ckpt/resume.py counts the restores and quarantines.
"""

from __future__ import annotations

import collections
import copy
import json
import os
import pickle
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from horovod_tpu_torch.common.config import _env_int
from horovod_tpu_torch.ckpt import manifest as mf
from horovod_tpu_torch.ckpt import sharded

HOROVOD_CKPT_KEEP = "HOROVOD_CKPT_KEEP"
HOROVOD_CKPT_QUEUE = "HOROVOD_CKPT_QUEUE"
HOROVOD_CKPT_COMMIT_TIMEOUT = "HOROVOD_CKPT_COMMIT_TIMEOUT"

KV_SCOPE = "ckpt"
KV_LATEST_KEY = "latest"


def kv_from_env() -> Optional[Any]:
    """Single-attempt, tightly bounded KV client from the launcher env:
    a rendezvous blip costs ~2 s once, on background paths, never a
    step. None outside a launched job."""
    from horovod_tpu_torch.common import config as C
    from horovod_tpu_torch.common.resilience import RetryPolicy
    from horovod_tpu_torch.runner.rendezvous import KVClient
    addr = os.environ.get(C.HOROVOD_RENDEZVOUS_ADDR, "")
    port = os.environ.get(C.HOROVOD_RENDEZVOUS_PORT, "")
    if not addr or not port:
        return None
    try:
        return KVClient(addr, int(port),
                        retry_policy=RetryPolicy(max_attempts=1),
                        request_timeout=2.0)
    except Exception:
        return None


_mx_cache = None


def _mx():
    global _mx_cache
    from horovod_tpu_torch.observability import metrics as m
    reg = m.registry()
    if _mx_cache is None or _mx_cache[0] is not reg:
        _mx_cache = (reg, {
            "saves": reg.counter("horovod_ckpt_saves_total",
                                 "Checkpoint saves accepted (snapshot "
                                 "taken and enqueued)"),
            "skipped": reg.counter(
                "horovod_ckpt_skipped_total",
                "Checkpoint saves dropped by back-pressure (writer "
                "queue full; freshness lost, step time preserved)"),
            "commits": reg.counter("horovod_ckpt_commits_total",
                                   "Checkpoint generations committed"),
            "errors": reg.counter("horovod_ckpt_errors_total",
                                  "Background persist/commit failures"),
            "restores": reg.counter("horovod_ckpt_restores_total",
                                    "Checkpoint restores completed"),
            "quarantined": reg.counter(
                "horovod_ckpt_quarantined_total",
                "Corrupt/partial checkpoint dirs quarantined"),
            "bytes": reg.counter("horovod_ckpt_bytes_total",
                                 "Checkpoint payload bytes written"),
            "phase": reg.gauge(
                "horovod_ckpt_phase_seconds",
                "Last save's wall seconds split by phase "
                "(snapshot = critical path, persist/commit = "
                "background)", labelnames=("phase",)),
            "save_hist": reg.histogram(
                "horovod_ckpt_save_seconds",
                "Save phase durations (labeled by phase)",
                labelnames=("phase",)),
            "generation": reg.gauge(
                "horovod_ckpt_generation",
                "Newest committed checkpoint generation"),
            "restore_s": reg.gauge("horovod_ckpt_restore_seconds",
                                   "Last restore wall seconds"),
        })
    return _mx_cache[1]


def flight_event(desc: str) -> None:
    """A flight `ckpt` event, tagged with this process's rank and round
    (generic flight events carry no rank)."""
    from horovod_tpu_torch.observability import flight
    f = ident_fields()
    flight.record("ckpt", f"{desc} rank={f['rank']} round={f['round']}")


def _rank() -> Optional[int]:
    from horovod_tpu_torch.core import topology
    return topology.rank_or_none()


def ident_fields() -> Dict[str, int]:
    """This process's (rank, round) identity for ckpt records."""
    rank = _rank()
    if rank is None:
        v = os.environ.get("HOROVOD_RANK", "")
        rank = int(v) if v.strip().isdigit() else -1
    rd = os.environ.get("HOROVOD_ELASTIC_ROUND", "")
    return {"rank": rank,
            "round": int(rd) if rd.strip().isdigit() else 0}


@dataclass
class Restored:
    step: int
    generation: int
    tree: Any
    objects: Dict[str, Any]


class _Job:
    __slots__ = ("step", "generation", "snaps", "nbytes", "objects",
                 "snapshot_seconds")

    def __init__(self, step, generation, snaps, nbytes, objects,
                 snapshot_seconds):
        self.step = step
        self.generation = generation
        self.snaps = snaps
        self.nbytes = nbytes
        self.objects = objects
        self.snapshot_seconds = snapshot_seconds


class AsyncCheckpointer:
    """Preemption-proof training checkpoints.

    ``save(step, tree, objects=...)`` never blocks longer than the host
    snapshot; ``restore_latest(like=...)`` walks committed generations
    newest-first, quarantining corrupt ones.

    `writers` > 1 enables the multi-writer protocol (every rank persists
    its fragments, rank `primary_rank` merges the others' manifest
    fragments from the KV and commits); the default single-writer mode
    makes non-primary ranks' ``save`` a cheap no-op, the reference's
    rank-0-save convention.

    After a save: ``last_phase_seconds`` holds the last snapshot,
    persist and commit seconds, and ``history`` one record per accepted
    save ({step, generation, bytes, snapshot_s, persist_s, commit_s};
    the last 64).
    """

    def __init__(self, root: str, keep: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 writers: int = 1, primary_rank: int = 0,
                 kv: Optional[Any] = None, scope: Optional[Any] = None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.keep = keep if keep is not None else \
            max(1, _env_int(HOROVOD_CKPT_KEEP, 2))
        self.writers = max(1, int(writers))
        self.primary_rank = int(primary_rank)
        self.commit_timeout = float(
            _env_int(HOROVOD_CKPT_COMMIT_TIMEOUT, 120))
        self._kv = kv
        self._kv_dead = False
        self._scope = scope  # injectable perfscope (tests)
        depth = queue_depth if queue_depth is not None else \
            max(1, _env_int(HOROVOD_CKPT_QUEUE, 1))
        self._q: "queue.Queue[_Job]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        latest = mf.latest_committed(self.root)
        # generation numbering continues across process lives
        self._gen = latest[0] if latest else 0      # guarded-by: _lock
        self._last_committed = latest               # guarded-by: _lock
        self._inflight = 0                          # guarded-by: _lock
        self.skipped = 0                            # guarded-by: _lock
        self._last_error: Optional[str] = None      # guarded-by: _lock
        self.last_phase_seconds: Dict[str, float] = {}  # guarded-by: _lock
        self.history: "collections.deque" = collections.deque(
            maxlen=64)                              # guarded-by: _lock

    # ------------------------------------------------------------ identity
    @staticmethod
    def _rank() -> Optional[int]:
        return _rank()

    def _is_writer(self) -> bool:
        r = self._rank()
        if r is None or self.writers > 1:
            return True
        return r == self.primary_rank

    def _is_primary(self) -> bool:
        r = self._rank()
        return r is None or r == self.primary_rank

    # ------------------------------------------------------------------ kv
    def _kv_client(self):
        if self._kv is None and not self._kv_dead:
            self._kv = kv_from_env()
            if self._kv is None:
                self._kv_dead = True
        return self._kv

    def _kv_put(self, key: str, value: Dict[str, Any]) -> None:
        kv = self._kv_client()
        if kv is None:
            return
        try:
            kv.put(KV_SCOPE, key, json.dumps(value).encode())
        except Exception:
            pass  # KV outage degrades the pointer, never the save

    def _kv_get(self, key: str) -> Optional[Dict[str, Any]]:
        kv = self._kv_client()
        if kv is None:
            return None
        try:
            data = kv.get(KV_SCOPE, key, timeout=0.0)
        except Exception:
            return None
        if not data:
            return None
        try:
            return json.loads(data.decode())
        except ValueError:
            return None

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any,
             objects: Optional[Dict[str, Any]] = None,
             block: bool = False) -> bool:
        """Two-phase save at a step boundary. Returns True when the save
        was accepted (snapshot taken and enqueued), False when it was
        skipped (back-pressure) or this rank is not a writer.
        ``block=True`` also waits for the commit (end of job, or before a
        preemption) and then returns whether THIS save's generation
        committed: a disk-full persist or a wait timeout is a loud False,
        never a silent success (on a non-primary multi-writer rank, block
        covers only the local persist: the commit is the primary's)."""
        if not self._is_writer():
            return False
        with self._lock:
            skip = self._inflight >= self._q.maxsize
            if skip:
                # never >queue_depth in flight: skip-and-count
                self.skipped += 1
                skip_count = self.skipped
            else:
                self._inflight += 1
                # claim the generation in the same critical section as
                # the slot: two in-flight saves never share a number (a
                # failed save leaves a harmless gap: monotonicity is the
                # invariant, not density)
                self._gen += 1
                gen = self._gen
        if skip:
            _mx()["skipped"].inc()
            flight_event(f"skip step={int(step)} skipped={skip_count} "
                    f"(writer busy)")
            return False
        try:
            scope = self._scope
            if scope is None:
                from horovod_tpu_torch.profiler import perfscope
                scope = perfscope.get()
            t0 = time.perf_counter()
            with scope.phase("checkpoint"):
                snaps, nbytes = sharded.snapshot_tree(
                    tree, keep_replicated=self._is_primary())
                obj_copy = copy.deepcopy(objects) if objects else {}
            dt = time.perf_counter() - t0
            with self._lock:
                self.last_phase_seconds["snapshot"] = dt
            _mx()["saves"].inc()
            _mx()["phase"].labels(phase="snapshot").set(dt)
            _mx()["save_hist"].labels(phase="snapshot").observe(dt)
            flight_event(f"snapshot step={int(step)} gen={gen} "
                    f"bytes={nbytes} seconds={dt:.3f}")
            job = _Job(int(step), gen, snaps, nbytes, obj_copy, dt)
            with self._lock:
                self.history.append({"step": int(step), "generation": gen,
                                     "bytes": nbytes, "snapshot_s": dt})
            self._ensure_thread()
            # the depth accounting above guarantees room; a foreign
            # producer misusing the queue must surface, not deadlock
            self._q.put(job, timeout=5.0)
        except BaseException:
            # the slot was reserved but no job reached the writer: give
            # it back, or one snapshot failure would wedge every later
            # save into the skip branch
            with self._lock:
                self._inflight -= 1
            raise
        if block:
            if not self.wait():
                return False
            if self._is_primary():
                with self._lock:
                    done = self._last_committed
                return done is not None and done[0] >= gen
        return True

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._writer_loop, name="hvd-ckpt-writer",
                    daemon=True)
                self._thread.start()

    def wait(self, timeout: float = 60.0) -> bool:
        """Block until every accepted save has been persisted (or the
        deadline passes)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    return True
            time.sleep(0.01)
        return False

    def close(self, timeout: float = 60.0) -> bool:
        ok = self.wait(timeout)
        self._stop.set()
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        return ok

    # ------------------------------------------------------------- writer
    def _writer_loop(self) -> None:
        while not self._stop.is_set():
            try:
                job = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._persist(job)
            except Exception as e:  # never kill training: record it
                _mx()["errors"].inc()
                with self._lock:
                    self._last_error = f"{type(e).__name__}: {e}"
                flight_event(f"persist-error step={job.step} gen="
                        f"{job.generation} err={type(e).__name__}: {e}")
            finally:
                # drop the job before the next wait: its snapshot holds
                # the pinned host copies
                job = None
                with self._lock:
                    self._inflight -= 1

    def _persist(self, job: _Job) -> None:
        dirpath = os.path.join(self.root, mf.dirname_for(job.step))
        t0 = time.perf_counter()
        written = sharded.write_snapshots(dirpath, job.snaps)
        rank = self._rank()
        if job.objects and (rank is None or rank == self.primary_rank):
            with open(os.path.join(dirpath, mf.OBJECTS_NAME), "wb") as f:
                pickle.dump(job.objects, f)
        persist_s = time.perf_counter() - t0
        _mx()["bytes"].inc(written)
        _mx()["phase"].labels(phase="persist").set(persist_s)
        _mx()["save_hist"].labels(phase="persist").observe(persist_s)
        with self._lock:
            self.last_phase_seconds["persist"] = persist_s
            self._record(job.generation, persist_s=persist_s)
        flight_event(f"persist step={job.step} gen={job.generation} "
                f"bytes={written} seconds={persist_s:.3f}")
        entries = [s.entry for s in job.snaps]
        if self.writers > 1 and not self._is_primary():
            # Fragments are keyed by STEP, the id every rank agreed on at
            # the save call, not the local generation counter: per-rank
            # back-pressure skips would desync the counters.
            self._kv_put(f"writer/{job.step}/{rank}",
                         {"leaves": [e.to_json() for e in entries],
                          "bytes": written})
            return
        if self.writers > 1:
            peers = self._collect_fragments(job.step)
            if peers is None:
                flight_event(f"commit-abort step={job.step} "
                        f"gen={job.generation} (missing writer "
                        f"fragments after {self.commit_timeout:.0f}s)")
                _mx()["errors"].inc()
                with self._lock:
                    self._last_error = (
                        f"commit of step {job.step} aborted: writer "
                        f"fragments missing after "
                        f"{self.commit_timeout:.0f} s")
                return
            entries = self._merge_fragments(entries, peers)
        gap = self._coverage_gap(entries)
        if gap is not None:
            # A marker over a checkpoint that can never restore would be
            # found only at the preemption that needed it: fail at save
            # time instead (the single-writer-on-a-sharded-job mistake).
            flight_event(f"commit-abort step={job.step} gen={job.generation} "
                    f"(leaf {gap[0]!r} covers only {gap[1]}/{gap[2]} "
                    f"elements)")
            _mx()["errors"].inc()
            with self._lock:
                self._last_error = (
                    f"incomplete shard coverage for {gap[0]!r} "
                    f"({gap[1]}/{gap[2]} elements): set writers= on "
                    f"AsyncCheckpointer for multi-process sharded saves")
            return
        t1 = time.perf_counter()
        man = mf.Manifest(
            step=job.step, generation=job.generation, leaves=entries,
            mesh_axes=None, world_size=self._world_size(),
            has_objects=bool(job.objects))
        mf.write_manifest(dirpath, man)
        mf.write_marker(self.root, job.step, job.generation)
        commit_s = time.perf_counter() - t1
        _mx()["commits"].inc()
        _mx()["generation"].set(job.generation)
        _mx()["phase"].labels(phase="commit").set(commit_s)
        _mx()["save_hist"].labels(phase="commit").observe(commit_s)
        flight_event(f"commit step={job.step} gen={job.generation}")
        with self._lock:
            self._last_committed = (job.generation, job.step)
            self.last_phase_seconds["commit"] = commit_s
            self._record(job.generation, commit_s=commit_s)
        self._kv_put(KV_LATEST_KEY,
                     {"step": job.step, "generation": job.generation,
                      "root": self.root, "time": time.time()})
        mf.gc(self.root, self.keep)

    def _record(self, generation: int, **fields) -> None:
        """Add `fields` to the history record of `generation` (the
        caller holds _lock)."""
        for rec in reversed(self.history):
            if rec["generation"] == generation:
                rec.update(fields)
                return

    def _collect_fragments(self, step: int
                           ) -> Optional[List[Dict[str, Any]]]:
        """Primary-side wait for the other writers' manifest fragments
        of this STEP (bounded by commit_timeout; None = abort the
        commit, e.g. a peer skipped this save under back-pressure)."""
        need = [r for r in range(self.writers) if r != self.primary_rank]
        got: Dict[int, Dict[str, Any]] = {}
        deadline = time.monotonic() + self.commit_timeout
        while time.monotonic() < deadline and len(got) < len(need):
            for r in need:
                if r in got:
                    continue
                frag = self._kv_get(f"writer/{step}/{r}")
                if frag is not None:
                    got[r] = frag
            if len(got) < len(need):
                time.sleep(0.05)
        if len(got) < len(need):
            return None
        return [got[r] for r in need]

    @staticmethod
    def _coverage_gap(entries: List[mf.LeafEntry]) -> Optional[tuple]:
        """First leaf whose shard files do not cover its global shape,
        as (path, covered, total); None when every leaf is whole."""
        for e in entries:
            total = 1
            for d in e.shape:
                total *= int(d)
            covered = 0
            for f in e.files:
                n = 1
                for a, b in zip(f["start"], f["stop"]):
                    n *= max(0, int(b) - int(a))
                covered += n
            if covered < total:
                return (e.path, covered, total)
        return None

    @staticmethod
    def _merge_fragments(entries: List[mf.LeafEntry],
                         peers: List[Dict[str, Any]]
                         ) -> List[mf.LeafEntry]:
        by_path = {e.path: e for e in entries}
        for frag in peers:
            for raw in frag.get("leaves", []):
                e = mf.LeafEntry.from_json(raw)
                mine = by_path.get(e.path)
                if mine is None:
                    by_path[e.path] = e
                else:
                    seen = {f["file"] for f in mine.files}
                    mine.files.extend(
                        f for f in e.files if f["file"] not in seen)
        return list(by_path.values())

    @staticmethod
    def _world_size() -> Optional[int]:
        from horovod_tpu_torch.core import topology
        return topology.size() if topology.is_initialized() else None

    # ------------------------------------------------------------ restore
    @property
    def last_committed(self) -> Optional[Tuple[int, int]]:
        """(generation, step) of the newest commit this process knows of
        (local writes or the construction-time disk scan)."""
        with self._lock:
            return self._last_committed

    @property
    def last_error(self) -> Optional[str]:
        with self._lock:
            return self._last_error

    def restore_latest(self, like: Optional[Any] = None,
                       mesh: Optional[Any] = None,
                       specs: Optional[Any] = None
                       ) -> Optional[Restored]:
        """Restore the newest committed checkpoint, quarantining corrupt
        or partial generations and falling back to older ones (None when
        no committed checkpoint survives). With `mesh` and `specs` each
        rank gets its own block of every leaf under those specs
        (sharded.reshard), which may be another mesh's than the save's.
        The checkpointer's own KV client rides along for the restore
        heartbeat."""
        from horovod_tpu_torch.ckpt import resume
        return resume.restore_latest(
            self.root, like=like, mesh=mesh, specs=specs,
            kv=self._kv_client())
