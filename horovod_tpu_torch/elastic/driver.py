"""Elastic driver: worker lifecycle across host changes (counterpart of
horovod_tpu/elastic/driver.py).

Reference: horovod/runner/elastic/driver.py ElasticDriver —
`_discover_hosts` poll thread (:188), `_update_host_assignments` (:240 —
recompute rank assignments PRESERVING running workers' host/local_rank
slots), `_start_worker_process` (:289), `_handle_worker_exit` (:304),
`wait_for_available_slots` (:153).

A surviving worker keeps its process and its in-memory state: it leaves
the old torch.distributed world and joins the round's new one in place
(elastic/__init__.py _reset); only new slots spawn workers. The
launcher hosts each round's TCPStore (RoundPublisher), so the death of
any worker, rank 0 included, leaves the store the survivors meet
through.

The driver counts its rounds, resets, spawns, failures, blacklists and
discovery failures into the launcher's metrics registry (served by the
rendezvous server's `GET /metrics`), records its rounds and worker exits
in the flight recorder, and at the job's end persists the workers'
flight tails, perfscope summaries, trace spans and hvdwatch records
into HOROVOD_FLIGHT_DIR (runner/launch.py persist_job_records).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from horovod_tpu_torch.common.exceptions import (HorovodError,
                                                 ResetLimitExceededError)
from horovod_tpu_torch.common.resilience import (RetryPolicy,
                                                 discovery_retry_policy)
from horovod_tpu_torch.elastic.discovery import HostManager
from horovod_tpu_torch.elastic.registration import WorkerStateRegistry
from horovod_tpu_torch.observability import flight
from horovod_tpu_torch.runner.hosts import (HostInfo, SlotInfo,
                                            get_host_assignments)

_mx_cache = None


def _mx():
    """Launcher-side elastic telemetry (observability/metrics.py)."""
    global _mx_cache
    from horovod_tpu_torch.observability import metrics as m
    reg = m.registry()
    if _mx_cache is None or _mx_cache[0] is not reg:
        _mx_cache = (reg, {
            "rounds": reg.counter("horovod_elastic_rounds_total",
                                  "Rendezvous rounds started"),
            "resets": reg.counter("horovod_elastic_resets_total",
                                  "Host-change resets processed"),
            "spawned": reg.counter("horovod_elastic_workers_spawned_total",
                                   "Worker processes spawned"),
            "failures": reg.counter(
                "horovod_elastic_worker_failures_total",
                "Worker exits with non-zero status"),
            "blacklists": reg.counter(
                "horovod_elastic_host_blacklists_total",
                "Hosts blacklisted after a failure"),
            "disc_fail": reg.counter(
                "horovod_elastic_discovery_failures_total",
                "Host-discovery poll failures"),
            "world": reg.gauge("horovod_elastic_world_size",
                               "Workers in the current round"),
        })
    return _mx_cache[1]


@dataclasses.dataclass
class _Worker:
    slot: SlotInfo
    handle: object  # launcher-provided process handle
    round_id: int


class ElasticDriver:
    """Drives discovery → assignment → worker (re)start rounds.

    `spawn_fn(slot, round_id) -> handle` and `stop_fn(handle)` are injected
    so unit tests can drive the driver with mocks (reference test strategy:
    test/single/test_elastic_driver.py uses mock worker clients).
    """

    def __init__(self,
                 host_manager: HostManager,
                 spawn_fn: Callable[[SlotInfo, int], object],
                 stop_fn: Callable[[object], None],
                 min_num_proc: int = 1,
                 max_num_proc: Optional[int] = None,
                 discovery_interval: float = 1.0,
                 reset_limit: Optional[int] = None,
                 publish_fn: Optional[Callable[[List[SlotInfo], int],
                                               None]] = None,
                 discovery_retry: Optional[RetryPolicy] = None):
        self.hosts = host_manager
        self.spawn_fn = spawn_fn
        self.stop_fn = stop_fn
        # Publishes (slots, round_id) to the rendezvous KV BEFORE workers
        # are notified of the round bump, so survivors can read their new
        # assignment (reference: the rendezvous handler's rank_and_size
        # scope, runner/elastic/rendezvous.py:22-45).
        self.publish_fn = publish_fn
        self.min_num_proc = min_num_proc
        self.max_num_proc = max_num_proc
        self.discovery_interval = discovery_interval
        self.reset_limit = reset_limit
        # Backoff schedule for discovery-poll failures (env prefix
        # HOROVOD_DISCOVERY_RETRY). The poll loop is perpetual, so the
        # policy bounds each failure BURST, not the loop: exhaustion is
        # surfaced via `discovery_failures` and the loop keeps probing at
        # the capped cadence (a dead discovery script must not kill a
        # healthy running job — but it must be loudly visible).
        self.discovery_retry = discovery_retry if discovery_retry is not None \
            else discovery_retry_policy()
        self.discovery_failures = 0   # consecutive; 0 once healthy
        self.registry = WorkerStateRegistry()

        self._workers: Dict[int, _Worker] = {}   # rank -> worker; guarded-by: _lock
        # Workers removed by a resize leave COOPERATIVELY: they observe the
        # round bump, leave the world with the survivors, see no
        # assignment, and exit 0; they are force-stopped only after a
        # grace period. (leaving_deadline, worker) pairs.
        self._leaving: List[tuple] = []  # guarded-by: _lock
        self.leave_grace_seconds = 60.0
        self._round = 0  # guarded-by: _lock
        self._resets = 0  # guarded-by: _lock
        # Per-round outcome tracking (reference: WorkerStateRegistry ends
        # the job when the last worker exits and none succeeded,
        # runner/elastic/registration.py:150-165). Without this, a
        # deterministic user-code failure loops forever: blacklist cooldown
        # (≤300s) re-admits the host before elastic_timeout can fire.
        self._round_spawned = 0    # guarded-by: _lock
        self._round_failed = 0     # guarded-by: _lock
        self._round_succeeded = 0  # guarded-by: _lock
        self.consecutive_failed_rounds = 0  # guarded-by: _lock
        self._shutdown = threading.Event()
        self._host_change = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()

    # ---------------------------------------------------------------- hosts
    def wait_for_available_slots(self, min_np: int,
                                 timeout: float = 600.0) -> None:
        """Block until discovery finds ≥ min_np slots (reference :153).

        Discovery hiccups while waiting do not abort the wait — they are
        absorbed (and logged) until the caller's timeout, which stays the
        single bound on this wait.
        """
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                self.hosts.update_available_hosts()
            except Exception as e:
                print(f"elastic: discovery error while waiting for slots: "
                      f"{e}", file=sys.stderr)
            if self.hosts.available_slots() >= min_np:
                return
            time.sleep(self.discovery_interval)
        raise HorovodError(
            f"timed out waiting for {min_np} slots "
            f"(have {self.hosts.available_slots()})")

    def _discover_loop(self) -> None:
        """Discovery poll with policy-bounded failure backoff.

        Healthy polls tick at `discovery_interval`. On failure the wait
        follows `discovery_retry`'s backoff schedule; when the schedule is
        exhausted the burst is surfaced (stderr + `discovery_failures`)
        and polling continues at the policy's capped delay — recovery
        re-arms the schedule.
        """
        backoff = None
        while not self._shutdown.is_set():
            try:
                if self.hosts.update_available_hosts():
                    self._host_change.set()
                self.discovery_failures = 0
                backoff = None
                wait = self.discovery_interval
            except Exception as e:
                self.discovery_failures += 1
                _mx()["disc_fail"].inc()
                if backoff is None:
                    backoff = self.discovery_retry.delays()
                try:
                    wait = next(backoff)
                    print(f"elastic: discovery error "
                          f"(attempt {self.discovery_failures}, retry in "
                          f"{wait:.2f}s): {e}", file=sys.stderr)
                except StopIteration:
                    wait = self.discovery_retry.max_delay
                    print(f"elastic: discovery failing persistently "
                          f"({self.discovery_failures} consecutive "
                          f"errors; HOROVOD_DISCOVERY_RETRY_* bounds "
                          f"exhausted, probing every {wait:.1f}s): {e}",
                          file=sys.stderr)
            self._shutdown.wait(wait)

    # ---------------------------------------------------------- assignments
    def compute_assignments(self) -> List[SlotInfo]:
        hosts = self.hosts.current_hosts
        total = sum(h.slots for h in hosts)
        np = min(total, self.max_num_proc) if self.max_num_proc else total
        if np < self.min_num_proc:
            raise HorovodError(
                f"available slots {np} < min_num_proc {self.min_num_proc}")
        # Preserve running workers' placement: order hosts so that hosts
        # currently running workers come first, in their existing order
        # (reference :240 — existing workers keep their slots; new hosts
        # append).
        with self._lock:
            running_hosts = []
            for w in sorted(self._workers.values(),
                            key=lambda w: w.slot.rank):
                if w.slot.hostname not in running_hosts:
                    running_hosts.append(w.slot.hostname)
        by_name = {h.hostname: h for h in hosts}
        ordered: List[HostInfo] = [by_name[h] for h in running_hosts
                                   if h in by_name]
        ordered += [h for h in hosts if h.hostname not in running_hosts]
        return get_host_assignments(ordered, np)

    # -------------------------------------------------------------- workers
    @staticmethod
    def _alive(w: _Worker) -> bool:
        poll = getattr(w.handle, "poll", None)
        return poll is None or poll() is None

    def _start_round(self) -> None:
        """Start a new rendezvous round, PRESERVING surviving workers.

        Reference: _update_host_assignments (runner/elastic/driver.py:240)
        keeps running workers on their (host, slot) so rank 0's in-memory
        state survives a resize; only removed/dead slots are stopped and
        only new slots are spawned. Survivors learn their new rank/size by
        reading the published assignment after observing the round bump
        (elastic/worker.py), then join the new world in-process.
        """
        slots = self.compute_assignments()
        with self._lock:
            self._round += 1
            round_id = self._round
            # survives worker-exit pops and stop(): the final round's
            # assignments are what post-run result mapping needs
            # (spark/elastic.py host-keyed results)
            self.last_round_slots = list(slots)
            self.registry.reset(len(slots))
            keep = {(s.hostname, s.local_rank): s for s in slots}
            survivors: Dict[tuple, _Worker] = {}
            for rank, w in list(self._workers.items()):
                key = (w.slot.hostname, w.slot.local_rank)
                if key in keep and self._alive(w):
                    survivors[key] = w
                elif self._alive(w):
                    # Removed by the resize: let it exit on its own (see
                    # _leaving above); force-stop only after the grace.
                    self._leaving.append(
                        (time.monotonic() + self.leave_grace_seconds, w))
                else:
                    self.stop_fn(w.handle)
            # Assignments must be readable before any worker can observe
            # the round bump — publish_fn writes them then bumps "round".
            print(f"elastic: round {round_id}: slots="
                  f"{[(s.hostname, s.local_rank, s.rank) for s in slots]} "
                  f"survivors={len(survivors)}", file=sys.stderr)
            flight.record("elastic",
                          f"launcher: round {round_id} with "
                          f"{len(slots)} slot(s), {len(survivors)} "
                          f"survivor(s)")
            if self.publish_fn is not None:
                self.publish_fn(slots, round_id)
            self._workers = {}
            self._round_spawned = len(slots)
            self._round_failed = 0
            self._round_succeeded = 0
            mx = _mx()
            for slot in slots:
                key = (slot.hostname, slot.local_rank)
                if key in survivors:
                    w = survivors[key]
                    w.slot = slot
                    w.round_id = round_id
                    self._workers[slot.rank] = w
                else:
                    handle = self.spawn_fn(slot, round_id)
                    self._workers[slot.rank] = _Worker(slot, handle, round_id)
                    mx["spawned"].inc()
            mx["rounds"].inc()
            mx["world"].set(len(slots))

    def reap_leaving(self) -> None:
        """Drop leaving workers that exited; force-stop stragglers past the
        grace deadline."""
        with self._lock:
            still = []
            for deadline, w in self._leaving:
                if not self._alive(w):
                    continue
                if time.monotonic() > deadline:
                    self.stop_fn(w.handle)
                else:
                    still.append((deadline, w))
            self._leaving = still

    def handle_worker_exit(self, rank: int, exit_code: int,
                           host_failure: bool = False) -> None:
        """Reference :304 — non-zero exit blacklists the host and triggers
        a reset round."""
        with self._lock:
            w = self._workers.pop(rank, None)
        if w is None:
            return
        flight.record("elastic",
                      f"launcher: worker rank={rank} "
                      f"({w.slot.hostname}) exited code={exit_code}")
        if exit_code == 0:
            self.registry.record_success(rank)
            with self._lock:
                self._round_succeeded += 1
                self.consecutive_failed_rounds = 0
            return
        self.registry.record_failure(rank)
        _mx()["failures"].inc()
        with self._lock:
            self._round_failed += 1
            if (self._round_succeeded == 0
                    and self._round_failed >= self._round_spawned > 0):
                self.consecutive_failed_rounds += 1
        if host_failure:
            self.hosts.blacklist(w.slot.hostname)
            _mx()["blacklists"].inc()
        self._host_change.set()

    # ------------------------------------------------------------------ run
    def start(self, start_timeout: float = 600.0) -> None:
        self.wait_for_available_slots(self.min_num_proc,
                                      timeout=start_timeout)
        self._start_round()
        self._thread = threading.Thread(target=self._discover_loop,
                                        daemon=True)
        self._thread.start()

    def maybe_reset(self) -> bool:
        """Process a pending host change; returns True if a reset happened.

        If the usable host set dropped below min_num_proc (e.g. the only
        host was just blacklisted), the reset stays PENDING: the flag is
        re-armed and the caller keeps polling until discovery finds slots
        again or its elastic timeout expires (reference:
        wait_for_available_slots gating each rendezvous round).
        """
        if not self._host_change.is_set():
            return False
        self._host_change.clear()
        with self._lock:
            self._resets += 1
            resets = self._resets
        _mx()["resets"].inc()
        if self.reset_limit is not None and resets > self.reset_limit:
            raise ResetLimitExceededError(
                f"elastic reset limit {self.reset_limit} exceeded after "
                f"{resets - 1} reset(s) (reference: launch.py "
                f"--reset-limit)")
        try:
            self._start_round()
        except HorovodError:
            with self._lock:
                self._resets -= 1
            self._host_change.set()
            return False
        return True

    def stop(self) -> None:
        self._shutdown.set()
        with self._lock:
            for w in self._workers.values():
                self.stop_fn(w.handle)
            for _, w in self._leaving:
                self.stop_fn(w.handle)
            self._workers = {}
            self._leaving = []
        if self._thread:
            self._thread.join(timeout=5)

    @property
    def world_size(self) -> int:
        with self._lock:
            return len(self._workers)

    def current_slots(self) -> List[SlotInfo]:
        with self._lock:
            return [w.slot for w in sorted(self._workers.values(),
                                           key=lambda w: w.slot.rank)]


class RoundPublisher:
    """Per-round torch.distributed store + assignment publication.

    The store of each round runs in the LAUNCHER (a TCPStore server,
    one per round), never inside rank 0, so a worker crash cannot take
    it down: that is what makes the death of a peer survivable for the
    others (the JAX package runs its coordination service here for the
    same reason). Old stores are retired two rounds later, after their
    clients are gone.
    """

    def __init__(self, rdv, ip: str):
        self.rdv = rdv
        self.ip = ip
        self._services: Dict[int, object] = {}
        self.round_coords: Dict[int, str] = {}

    def _make_service(self, round_id: int, n: int) -> str:
        from horovod_tpu_torch.core import topology
        addr, store = topology._bind_store(n)
        self._services[round_id] = store
        self.round_coords[round_id] = addr
        for rid in [r for r in self._services if r <= round_id - 2]:
            self._services.pop(rid)  # the server stops with its object
            self.round_coords.pop(rid, None)
        return addr

    def publish(self, slots: List[SlotInfo], round_id: int) -> None:
        # Store first (workers connect to it), then assignments, round
        # bump LAST: a worker that observes the bump must already be able
        # to read its assignment, with the round's store address, or
        # conclude it was removed. See elastic/worker.py.
        import dataclasses as _dc
        import json as _json

        coord = self._make_service(round_id, len(slots))
        # Clear a previous round's checkpoint-restore signal before
        # workers can observe the bump: a rank that died mid-restore must
        # not leak its grace into this round (ckpt/resume.py).
        from horovod_tpu_torch.ckpt import resume as _ckpt_resume
        self.rdv.put(_ckpt_resume.KV_SCOPE, _ckpt_resume.KV_RESTORING_KEY,
                     b"")
        for s in slots:
            record = _dc.asdict(s)
            record["coord"] = coord
            self.rdv.put("elastic",
                         f"assign/{round_id}/{s.hostname}/{s.local_rank}",
                         _json.dumps(record).encode())
        self.rdv.put("elastic", "round", str(round_id).encode())

    def close(self) -> None:
        self._services.clear()


def drive_elastic_loop(driver: "ElasticDriver", elastic_timeout: float,
                       failed_round_limit: Optional[int] = None) -> int:
    """The elastic main loop: poll workers, reap exits, detect job
    success/death. Shared by CLI and orchestrator entries; the driver's
    spawn/stop fns carry all placement specifics."""
    import os

    if failed_round_limit is None:
        # Stop once this many consecutive rounds ended with every worker
        # failing — a deterministic user-code failure, not a host event
        # (reference analog: registration.py:150-165 fails the job when
        # the last worker exits and none succeeded; we allow a couple of
        # retries to survive whole-pod preemptions).
        failed_round_limit = int(
            os.environ.get("HOROVOD_ELASTIC_FAILED_ROUND_LIMIT", "3"))
    idle_since = None
    try:
        while True:
            try:
                driver.maybe_reset()
            except ResetLimitExceededError as e:
                print(f"elastic: {e}", file=sys.stderr)
                return 1
            driver.reap_leaving()
            with driver._lock:
                workers = dict(driver._workers)
            done = {r: w.handle.poll() for r, w in workers.items()}
            exited = {r: c for r, c in done.items() if c is not None}
            for r, c in exited.items():
                print(f"elastic: worker rank={r} "
                      f"({workers[r].slot.hostname}) exited code={c}",
                      file=sys.stderr)
                driver.handle_worker_exit(r, c, host_failure=(c != 0))
            with driver._lock:
                failed_rounds = driver.consecutive_failed_rounds
            if failed_rounds >= failed_round_limit:
                print(f"elastic: {failed_rounds} "
                      "consecutive rounds failed on every worker; "
                      "giving up", file=sys.stderr)
                return 1
            if workers and all(c == 0 for c in done.values()
                               if c is not None) \
                    and all(c is not None for c in done.values()):
                return 0
            if driver.world_size == 0:
                # No workers: either a reset is pending (waiting for hosts
                # to clear cooldown / reappear) or the job is dead. Bounded
                # by --elastic-timeout (reference: launch.py:689 settings).
                if not driver._host_change.is_set():
                    return 1
                if idle_since is None:
                    idle_since = time.monotonic()
                elif time.monotonic() - idle_since > elastic_timeout:
                    print("elastic: timed out waiting for hosts",
                          file=sys.stderr)
                    return 1
            else:
                idle_since = None
            time.sleep(0.5)
    finally:
        driver.stop()


def run_elastic(args, command: List[str], extra_env: Dict[str, str]) -> int:
    """CLI entry for elastic mode (reference: launch.py:689 _run_elastic +
    gloo_run.py:303 launch_gloo_elastic)."""
    from horovod_tpu_torch.common import config as C
    from horovod_tpu_torch.elastic.discovery import HostDiscoveryScript
    from horovod_tpu_torch.runner import safe_exec
    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.kv_ha import start_control_plane
    from horovod_tpu_torch.runner.launch import (CONTROLLER, _local_ip,
                                                 make_worker_cmd)

    cooldown = getattr(args, "blacklist_cooldown_range", None)
    hm = HostManager(
        HostDiscoveryScript(args.host_discovery_script,
                            default_slots=args.slots_per_host or 1),
        cooldown_range=tuple(cooldown) if cooldown else None)
    # A pre-set HOROVOD_SECRET_KEY is honored (job_secret_key).
    job_secret = secret_mod.job_secret_key()
    rdv = start_control_plane(job_secret.encode())
    ip = _local_ip()
    publisher = RoundPublisher(rdv, ip)

    def spawn(slot: SlotInfo, round_id: int):
        env = dict(extra_env)
        env.update(rdv.worker_env(ip))
        env.update({
            C.HOROVOD_CONTROLLER: CONTROLLER,
            secret_mod.SECRET_ENV: job_secret,
            C.HOROVOD_ELASTIC: "1",
            C.HOROVOD_ELASTIC_ROUND: str(round_id),
            C.HOROVOD_ELASTIC_TIMEOUT: str(args.elastic_timeout),
            C.HOROVOD_COORDINATOR_ADDR: publisher.round_coords[round_id],
        })
        cmd, full_env = make_worker_cmd(
            slot, command, env,
            ssh_port=getattr(args, "ssh_port", None),
            ssh_identity_file=getattr(args, "ssh_identity_file", None))
        logfile = None
        out_dir = getattr(args, "output_filename", None)
        if out_dir:
            d = os.path.join(out_dir, f"rank.{slot.rank}")
            os.makedirs(d, exist_ok=True)
            # elastic respawns reuse rank slots: suffix by round so a
            # later round never clobbers the crashed round's log
            logfile = os.path.join(d, f"stdout.r{round_id}")
        return safe_exec.WorkerProcess(
            slot.rank, cmd, full_env, logfile=logfile,
            timestamp=getattr(args, "prefix_timestamp", False))

    driver = ElasticDriver(
        hm, spawn, lambda h: h.terminate(),
        min_num_proc=args.min_num_proc or 1,
        max_num_proc=args.max_num_proc,
        reset_limit=args.reset_limit,
        publish_fn=publisher.publish)
    rc = 1
    try:
        driver.start(start_timeout=args.start_timeout)
        rc = drive_elastic_loop(driver, args.elastic_timeout)
        return rc
    finally:
        # What the workers pushed lives only in this KV: write it out
        # before it goes (HOROVOD_FLIGHT_DIR, when set), then point the
        # operator at the doctor when the job failed.
        from horovod_tpu_torch.runner.launch import (persist_job_records,
                                                     print_doctor_hint)
        tails = persist_job_records(rdv)
        if rc != 0:
            print_doctor_hint("elastic", tails)
        publisher.close()
        rdv.stop()
