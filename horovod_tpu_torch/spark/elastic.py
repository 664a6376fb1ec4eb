"""Elastic training on Spark (counterpart of horovod_tpu/spark/elastic.py;
reference: spark/runner.py:312 run_elastic — elastic Horovod where each
Spark task hosts one worker).

Control is inverted versus the CLI elastic launcher: the launcher can
ssh-spawn worker processes, but a Spark driver cannot start individual
tasks — tasks are where the compute already lives. So each Spark task
runs a long-lived AGENT that places worker subprocesses on command:

  agent/<i>                       heartbeat {host, machine, ts}
  fn                              pickled (fn, args, kwargs) call
  launch/<round>/<host>           worker env for a fresh slot
  kill/<host>                     stop this agent's worker of that round
                                  or earlier (the value is the round)
  status/<round>/<host>/<slot>    worker exit code (agent → driver)
  result/<host>                   pickled fn() result (agent → driver)
  stopall                         job over; agents exit

where <host> is the agent's own name, agent<i> (all keys in the job
rendezvous KV, scope "spark_elastic", HMAC-signed like every
control-plane write). The driver side reuses the port's
ElasticDriver/RoundPublisher/drive_elastic_loop, as the CLI path does:
discovery reads agent heartbeats instead of a discovery script, and
spawn/stop write KV commands instead of starting processes. Each round's
TCPStore lives in the driver (RoundPublisher), so survivors keep their
process and re-join in place.

The driver's hosts are MACHINES (the `machine` an agent reports, its
hostname), each with one slot per fresh agent on it, as the reference
groups Spark tasks by host hash: the workers of the agents on one
machine get local ranks 0..n-1 and so take cards cuda:0..n-1. The driver
remembers which agent runs each slot (machine, local rank), so a
survivor stays with its agent from round to round; a worker whose agent
stops beating counts as failed.

A worker runs `horovod_tpu_torch.runner.task_runner`; the function it
runs calls `hvd.init()`, which takes the card (NCCL) unless the caller
asked for the host with HOROVOD_WORKER_PLATFORM=cpu in `extra_env`
(spark.backend.worker_device). The function ships as a
`functools.partial`, which pickles without cloudpickle when the function
is module-level.

The agent protocol is Spark-agnostic (it only needs a KV client), which
is also how it is tested and run on a GPU host with no Spark:
`run_elastic(..., _agent_runner=thread_agent_runner())` runs the agents
in threads of the driver's process, placing real worker subprocesses.
"""

from __future__ import annotations

import functools
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

_SCOPE = "spark_elastic"
HEARTBEAT_SECONDS = 2.0
STALE_AFTER_SECONDS = 15.0
KV_DEAD_SECONDS = 60.0  # an agent whose KV stays unreachable this long exits


# ----------------------------------------------------------------------
# agent (runs inside each Spark task)
# ----------------------------------------------------------------------

def _stop_worker(proc: subprocess.Popen) -> None:
    """Terminate, then kill, a worker; an unreapable one (D-state) is
    abandoned rather than crashing the agent and losing the host's
    capacity for good."""
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def agent_main(kv, index: int, stop_event: Optional[threading.Event] = None,
               poll_interval: float = 0.2) -> None:
    """One placement agent. `kv` is a KVClient bound to the job
    rendezvous; `index` is the agent's stable id (its Spark task index).
    Returns when the driver writes `stopall`."""
    from horovod_tpu_torch.common.resilience import RetryError
    from horovod_tpu_torch.runner.launch import _worker_pythonpath

    kv_errors = (OSError, RetryError)  # transport failures, after retries
    host = f"agent{index}"
    machine = socket.gethostname()
    stop_event = stop_event or threading.Event()
    proc: Optional[subprocess.Popen] = None
    proc_round = -1
    proc_rank = 0
    proc_dir = ""
    fn_path: Optional[str] = None

    def beat():
        while not stop_event.is_set():
            try:
                kv.put(_SCOPE, f"agent/{index}",
                       json.dumps({"host": host, "machine": machine,
                                   "ts": time.time()}).encode())
            except kv_errors:
                pass  # the KV is away; the main loop judges how long
            stop_event.wait(HEARTBEAT_SECONDS)

    hb = threading.Thread(target=beat, daemon=True)
    hb.start()
    proc_dirs: List[str] = []
    last_kv_ok = time.monotonic()
    try:
        while not stop_event.is_set():
            try:
                if kv.get(_SCOPE, "stopall", timeout=0) is not None:
                    break
                raw_round = kv.get(_SCOPE, "round_hint", timeout=0)
                last_kv_ok = time.monotonic()
            except kv_errors:
                # A transient KV outage must not kill the agent (its
                # capacity would vanish for good), but a dead rendezvous
                # (the job torn down) must not leave it spinning either.
                if time.monotonic() - last_kv_ok > KV_DEAD_SECONDS:
                    break
                stop_event.wait(poll_interval)
                continue
            cur_round = int(raw_round) if raw_round else 0
            # launch command for this host at the current (or next —
            # publish precedes the hint bump) round
            for rid in (cur_round, cur_round + 1):
                raw = kv.get(_SCOPE, f"launch/{rid}/{host}", timeout=0)
                if raw is None:
                    continue
                rec = json.loads(raw)
                if rec["round"] <= proc_round:
                    continue
                if proc is not None and proc.poll() is None:
                    # A running worker with NO newer launch record is a
                    # survivor (it re-joins in-process; the driver writes
                    # launch only for slots it spawns). A newer launch
                    # record for this host means the driver replaced the
                    # worker: if the kill command was swallowed by
                    # spawn()'s stale-key cleanup before the agent read
                    # it, the old process would live on and stall the
                    # host. The launch record IS the authoritative kill.
                    _stop_worker(proc)
                if fn_path is None:
                    with tempfile.NamedTemporaryFile(
                            "wb", suffix=".pkl", delete=False) as f:
                        f.write(kv.get(_SCOPE, "fn"))
                        fn_path = f.name
                out_dir = tempfile.mkdtemp(prefix=f"hvd_spark_el_{index}_")
                proc_dirs.append(out_dir)
                env = dict(os.environ)
                env.update(rec["env"])
                env["PYTHONPATH"] = _worker_pythonpath(env.get("PYTHONPATH"))
                env["HOROVOD_RUN_FUNC_FILE"] = fn_path
                env["HOROVOD_RUN_RESULT_DIR"] = out_dir
                proc = subprocess.Popen(
                    [sys.executable, "-m",
                     "horovod_tpu_torch.runner.task_runner"], env=env)
                proc_round, proc_rank, proc_dir = \
                    rec["round"], rec["rank"], out_dir
            raw_kill = kv.get(_SCOPE, f"kill/{host}", timeout=0)
            if raw_kill is not None:
                # A kill names the round of the worker it is meant for: a
                # late one for a worker this agent has since replaced
                # must not stop the replacement.
                if proc is not None and proc.poll() is None \
                        and proc_round <= int(raw_kill):
                    proc.terminate()
                # consume the command: a lingering kill key would
                # murder every future worker on this agent
                kv.delete(_SCOPE, f"kill/{host}")
            if proc is not None:
                code = proc.poll()
                if code is not None:
                    if code == 0:
                        # rank_<n>.pkl is named by the SPAWN-time rank
                        # env (task_runner), which is proc_rank even if
                        # the worker re-ranked as a survivor — results
                        # are therefore published HOST-keyed and the
                        # driver maps host -> final rank.
                        res = os.path.join(proc_dir,
                                           f"rank_{proc_rank}.pkl")
                        try:
                            with open(res, "rb") as f:
                                kv.put(_SCOPE, f"result/{host}", f.read())
                        except OSError:
                            code = 1
                    kv.put(_SCOPE, f"status/{proc_round}/{host}/0",
                           str(code).encode())
                    proc = None
            time.sleep(poll_interval)
    finally:
        stop_event.set()
        if proc is not None and proc.poll() is None:
            _stop_worker(proc)
        hb.join(timeout=2)
        if fn_path:
            try:
                os.unlink(fn_path)
            except OSError:
                pass
        for d in proc_dirs:
            shutil.rmtree(d, ignore_errors=True)


# ----------------------------------------------------------------------
# driver side
# ----------------------------------------------------------------------

class KVAgentDiscovery:
    """HostDiscovery over agent heartbeats (duck-typed for HostManager):
    each machine with as many slots as it has fresh agents. Agents
    register under fixed indices, so discovery polls
    agent/0..max_agents-1 — the KV has no key listing by design.
    `agents` maps each machine to its fresh agents' names, by index.

    Staleness is judged by when the heartbeat VALUE last changed on the
    DRIVER's clock — executor clocks can be skewed arbitrarily, so the
    remote "ts" field is treated as an opaque nonce."""

    def __init__(self, kv, max_agents: int):
        self.kv = kv
        self.max_agents = max_agents
        self._last_seen: Dict[int, tuple] = {}
        self.agents: Dict[str, List[str]] = {}

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        now = time.monotonic()
        agents: Dict[str, List[str]] = {}
        for i in range(self.max_agents):
            raw = self.kv.get(_SCOPE, f"agent/{i}", timeout=0)
            if raw is None:
                continue
            prev = self._last_seen.get(i)
            if prev is None or prev[0] != raw:
                self._last_seen[i] = (raw, now)
            if now - self._last_seen[i][1] <= STALE_AFTER_SECONDS:
                rec = json.loads(raw)
                agents.setdefault(rec["machine"], []).append(rec["host"])
        self.agents = agents
        return {m: len(names) for m, names in agents.items()}

    def is_fresh(self, agent: str) -> bool:
        return any(agent in names for names in self.agents.values())


class _AgentHandle:
    """Worker handle whose liveness is the agent-reported status key; a
    worker whose agent is no longer `alive()` counts as failed."""

    def __init__(self, kv, round_id: int, host: str, alive=lambda: True):
        self.kv = kv
        self.round_id = round_id
        self.host = host
        self.alive = alive
        self._killed = False

    def poll(self) -> Optional[int]:
        raw = self.kv.get(_SCOPE, f"status/{self.round_id}/{self.host}/0",
                          timeout=0)
        if raw is not None:
            return int(raw)
        if self._killed:
            return 143
        if not self.alive():
            return 1
        return None

    def terminate(self) -> None:
        self._killed = True
        self.kv.put(_SCOPE, f"kill/{self.host}", str(self.round_id).encode())


class _Placement:
    """Which agent runs each slot (machine, local rank). A slot keeps its
    agent while that agent is fresh and runs no other slot of the round;
    else it takes the first such agent of its machine, by index."""

    def __init__(self, discovery: KVAgentDiscovery):
        self.discovery = discovery
        self.owner: Dict[Tuple[str, int], str] = {}
        self._round_slots: Dict[int, Set[Tuple[str, int]]] = {}

    def publish(self, slots, round_id: int) -> None:
        self._round_slots[round_id] = {(s.hostname, s.local_rank)
                                       for s in slots}

    def place(self, slot, round_id: int) -> Optional[str]:
        """The agent for `slot` in `round_id`, or None where its machine
        has no agent to spare (it lost one since the round was planned)."""
        key = (slot.hostname, slot.local_rank)
        busy = {self.owner[k] for k in self._round_slots[round_id]
                if k != key and k in self.owner}
        free = [a for a in self.discovery.agents.get(slot.hostname, [])
                if a not in busy]
        if not free:
            return None
        agent = self.owner.get(key)
        if agent not in free:
            agent = free[0]
        self.owner[key] = agent
        return agent


def run_elastic(fn, args=(), kwargs=None,
                num_proc: Optional[int] = None,
                min_num_proc: int = 1,
                max_num_proc: Optional[int] = None,
                start_timeout: float = 600.0,
                elastic_timeout: float = 600.0,
                reset_limit: Optional[int] = None,
                extra_env: Optional[dict] = None,
                verbose: int = 1,
                _agent_runner=None) -> List[Any]:
    """Elastic run over Spark tasks (reference: spark/runner.py:312);
    returns the final world's results in rank order.

    `_agent_runner(n_agents, max_agents, kv_factory)` places the agents
    (`kv_factory()` is a new KV client of this job) and returns an object
    with `join(timeout)`, or None; the default submits a Spark job with
    n long-lived agent tasks, and `thread_agent_runner()` runs them in
    threads of this process.
    """
    from horovod_tpu_torch.common import config as C
    from horovod_tpu_torch.elastic.discovery import HostManager
    from horovod_tpu_torch.elastic.driver import (ElasticDriver,
                                                  RoundPublisher,
                                                  drive_elastic_loop)
    from horovod_tpu_torch.runner import _dumps
    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.launch import _local_ip
    from horovod_tpu_torch.runner.rendezvous import KVClient, RendezvousServer

    job_secret = secret_mod.make_secret_key()
    rdv = RendezvousServer(secret=job_secret.encode())
    rdv_port = rdv.start()
    ip = _local_ip()
    kv = KVClient(ip, rdv_port, secret=job_secret.encode())
    kv.put(_SCOPE, "fn",
           _dumps(functools.partial(fn, *args, **(kwargs or {}))))

    n_agents = num_proc or max_num_proc or min_num_proc
    max_agents = max_num_proc or n_agents

    if _agent_runner is None:
        _agent_runner = _spark_agent_runner(ip, rdv_port, job_secret)
    agent_job = _agent_runner(
        n_agents, max_agents,
        lambda: KVClient(ip, rdv_port, secret=job_secret.encode()))

    publisher = RoundPublisher(rdv, ip)
    base_env = dict(extra_env or {})
    base_env.update(rdv.worker_env(ip))
    base_env.update({
        secret_mod.SECRET_ENV: job_secret,
        C.HOROVOD_ELASTIC: "1",
        C.HOROVOD_ELASTIC_TIMEOUT: str(elastic_timeout),
    })

    discovery = KVAgentDiscovery(kv, max_agents)
    placement = _Placement(discovery)

    def publish(slots, round_id: int) -> None:
        placement.publish(slots, round_id)
        publisher.publish(slots, round_id)

    def spawn(slot, round_id: int):
        agent = placement.place(slot, round_id)
        if agent is None:
            return _AgentHandle(kv, round_id, "", alive=lambda: False)
        env = dict(base_env)
        env.update(slot.to_env())
        env.update({
            C.HOROVOD_ELASTIC_ROUND: str(round_id),
            C.HOROVOD_COORDINATOR_ADDR: publisher.round_coords[round_id],
        })
        # Clear the result of this agent's previous worker (a lingering
        # kill names an older round, which the agent ignores).
        kv.delete(_SCOPE, f"result/{agent}")
        kv.put(_SCOPE, f"launch/{round_id}/{agent}",
               json.dumps({"round": round_id, "rank": slot.rank,
                           "env": env}).encode())
        kv.put(_SCOPE, "round_hint", str(round_id).encode())
        return _AgentHandle(kv, round_id, agent,
                            alive=lambda: discovery.is_fresh(agent))

    hm = HostManager(discovery)
    driver = ElasticDriver(
        hm, spawn, lambda h: h.terminate(),
        min_num_proc=min_num_proc,
        max_num_proc=max_num_proc,
        reset_limit=reset_limit,
        publish_fn=publish)

    deadline = time.monotonic() + start_timeout

    def _poll_agents() -> bool:
        # update_available_hosts may raise (discovery hiccup, injected
        # flap): absorb until start_timeout — the deadline below stays
        # the single bound on this wait, like wait_for_available_slots.
        try:
            return bool(hm.update_available_hosts())
        except Exception as e:  # noqa: BLE001 — retried until the deadline
            print(f"elastic spark: discovery error while waiting for "
                  f"agents: {e}", file=sys.stderr)
            return False

    while not (_poll_agents() or hm.current_hosts):
        if time.monotonic() > deadline:
            kv.put(_SCOPE, "stopall", b"1")
            rdv.stop()
            raise TimeoutError(
                "no Spark agent registered before start_timeout")
        time.sleep(0.2)

    remaining = max(0.0, deadline - time.monotonic())
    driver.start(start_timeout=max(remaining, 1.0))
    try:
        rc = drive_elastic_loop(driver, elastic_timeout)
        if rc != 0:
            raise RuntimeError(f"elastic spark job failed (rc={rc})")
        # Results are AGENT-keyed (survivors' spawn-time ranks go stale
        # on resize); the driver owns the final slot -> rank mapping
        # (snapshotted by driver.stop()) and the placement the slot ->
        # agent one.
        slots = getattr(driver, "last_round_slots", None) or \
            driver.current_slots()
        results: List[Any] = [None] * len(slots)
        for slot in slots:
            agent = placement.owner.get((slot.hostname, slot.local_rank))
            raw = None if agent is None else \
                kv.get(_SCOPE, f"result/{agent}", timeout=30.0)
            if raw is not None:  # task_runner's (ok, result); ok here
                results[slot.rank] = pickle.loads(raw)[1]
        return results
    finally:
        kv.put(_SCOPE, "stopall", b"1")
        publisher.close()
        if agent_job is not None:
            agent_job.join(timeout=10)
        rdv.stop()


class _ThreadAgents:
    """The agents of `thread_agent_runner`; `join` stops them."""

    def __init__(self, stops: List[threading.Event],
                 threads: List[threading.Thread]):
        self.stops, self.threads = stops, threads

    def join(self, timeout: Optional[float] = None) -> None:
        for ev in self.stops:
            ev.set()
        for t in self.threads:
            t.join(timeout=timeout)


def thread_agent_runner():
    """Agent placement without Spark: each agent is a daemon thread of
    the driver's process (its workers are still subprocesses), all on
    this machine, so their workers take local ranks 0..n-1."""

    def runner(n_agents: int, max_agents: int, kv_factory):
        stops, threads = [], []
        for i in range(n_agents):
            ev = threading.Event()
            t = threading.Thread(
                target=agent_main, args=(kv_factory(), i),
                kwargs={"stop_event": ev}, daemon=True)
            t.start()
            stops.append(ev)
            threads.append(t)
        return _ThreadAgents(stops, threads)

    return runner


def _spark_agent_runner(ip: str, port: int, job_secret: str):
    """Default agent placement: one long-lived Spark task per agent
    (each task makes its own KV client from the address and secret)."""

    def runner(n_agents: int, max_agents: int, kv_factory):
        import pyspark

        sc = pyspark.SparkContext._active_spark_context
        if sc is None:
            raise RuntimeError("no active SparkContext; create a "
                               "SparkSession first")

        def task(index, _it):
            from horovod_tpu_torch.runner.rendezvous import KVClient as _KV
            from horovod_tpu_torch.spark.elastic import agent_main
            agent_main(_KV(ip, port, secret=job_secret.encode()), index)
            yield index

        t = threading.Thread(
            target=lambda: (sc.parallelize(range(n_agents), n_agents)
                            .mapPartitionsWithIndex(task).collect()),
            daemon=True)
        t.start()
        return t

    return runner
