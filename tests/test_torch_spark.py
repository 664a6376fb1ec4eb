"""The port's Spark orchestration (horovod_tpu_torch/spark/__init__.py
`run`, spark/elastic.py `run_elastic`, the agents and their discovery)
held against the JAX package's (horovod_tpu/spark/).

* `spark.run` under the JAX tests' stub pyspark (tests/
  test_spark_runner.py), given Spark's barrier stage: per-task
  environment and per-rank results in rank order, the same in both
  packages on one machine; a task's error names its rank; no active
  context is refused. Where the executors sit on two machines, each
  machine's tasks take consecutive ranks and local ranks 0..n-1, as the
  launcher's host assignments give them (runner/hosts.py).
* Spark elastic without Spark, as the JAX tests run it: agents in
  threads place real worker subprocesses (horovod_tpu_torch.runner.
  task_runner) over the port's rendezvous KV, driven by the port's
  ElasticDriver. Two workers with the CPU request form one gloo world
  (each rank's allreduce sum is 1 + 2) with local ranks 0 and 1 on this
  one machine; a job proceeds with fewer agents than asked for; no agent
  times out; a newer launch record replaces a live worker, and a late
  kill for the replaced one spares its replacement. The discovery's
  staleness rule and the agent handle are held against the JAX
  package's on the same KV records; the port's discovery counts a
  machine's agents as its slots, and a slot keeps its agent.
* Without the CPU request a worker asks for the card: on this host its
  hvd.init raises naming the missing card and the job fails.
* The function ships as a functools.partial, which pickles with the
  standard pickle when cloudpickle is absent.

Every launched world runs on gloo with HOROVOD_WORKER_PLATFORM=cpu; the
workers' functions are closures, which cloudpickle sends by value.
"""

import concurrent.futures
import functools
import itertools
import json
import os
import pickle
import sys
import threading
import time
import types
import unittest.mock as mock

import pytest

import horovod_tpu.spark as jspark
import horovod_tpu.spark.elastic as jspe
import horovod_tpu_torch.spark as tspark
import horovod_tpu_torch.spark.elastic as spe
from horovod_tpu_torch.runner import secret as secret_mod
from horovod_tpu_torch.runner.rendezvous import KVClient, RendezvousServer
from horovod_tpu_torch.runner.results import RemoteJobError
from horovod_tpu_torch.runner.hosts import HostInfo, get_host_assignments
from test_spark_runner import (_StubRDD, _StubSparkContext,  # noqa: F401
                               stub_pyspark)

CPU = {"HOROVOD_WORKER_PLATFORM": "cpu"}


# ----------------------------------------------------------------------
# spark.run under the stub pyspark
# ----------------------------------------------------------------------

@pytest.fixture()
def barrier_pyspark(stub_pyspark, monkeypatch):
    """The JAX tests' stub pyspark with Spark's barrier stage (the JAX
    package's run does not use it): every task's BarrierTaskContext
    lists the executor addresses in the returned list, one machine's
    three by default; a test may replace them."""
    addresses = ["host0:7001", "host0:7002", "host0:7003"]
    ctx = types.SimpleNamespace(getTaskInfos=lambda: [
        types.SimpleNamespace(address=a) for a in addresses])
    monkeypatch.setattr(_StubRDD, "barrier", lambda self: self,
                        raising=False)
    sys.modules["pyspark"].BarrierTaskContext = types.SimpleNamespace(
        get=lambda: ctx)
    return addresses


def _env_probe(tag):
    return (tag, os.environ["HOROVOD_RANK"], os.environ["HOROVOD_SIZE"],
            "HOROVOD_SECRET_KEY" in os.environ,
            "HOROVOD_GLOO_RENDEZVOUS_PORT" in os.environ)


def test_spark_run_per_rank_results_match_jax(barrier_pyspark):
    got = tspark.run(_env_probe, args=("x",))
    want = jspark.run(_env_probe, args=("x",))
    assert got == want
    assert [r[1] for r in got] == ["0", "1", "2"]
    assert all(r[0] == "x" and r[2] == "3" and r[3] and r[4] for r in got)


def _slot_probe():
    return tuple(os.environ[f"HOROVOD_{k}"] for k in (
        "HOSTNAME", "RANK", "SIZE", "LOCAL_RANK", "LOCAL_SIZE",
        "CROSS_RANK", "CROSS_SIZE"))


def test_spark_run_gives_each_machine_local_ranks(barrier_pyspark):
    """Tasks 0 and 2 on hostA, 1 and 3 on hostB: hostA's take ranks 0-1
    and hostB's 2-3, each machine's local ranks 0 and 1 (so each task
    its own card), results in rank order."""
    barrier_pyspark[:] = ["hostA:1", "hostB:1", "hostA:2", "hostB:2"]
    got = tspark.run(_slot_probe, num_proc=4)
    assert got == [("hostA", "0", "4", "0", "2", "0", "2"),
                   ("hostA", "1", "4", "1", "2", "0", "2"),
                   ("hostB", "2", "4", "0", "2", "1", "2"),
                   ("hostB", "3", "4", "1", "2", "1", "2")]


@pytest.mark.parametrize("machines", [
    "AAAA", "ABAB", "AAAB", "BAAA", "ABCA"])
def test_task_slot_matches_host_assignments(machines):
    """Each task's slot is the launcher's assignment of its machine's
    next slot, machines in the order of their first task."""
    addresses = [f"{m}:{i}" for i, m in enumerate(machines)]
    order = list(dict.fromkeys(machines))
    want = get_host_assignments(
        [HostInfo(m, machines.count(m)) for m in order], len(machines))
    got = [tspark.task_slot(i, addresses) for i in range(len(machines))]
    assert sorted(got, key=lambda s: s.rank) == want
    for i, slot in enumerate(got):
        assert slot.hostname == machines[i]
        assert slot.local_rank == machines[:i].count(machines[i])


def test_spark_run_surfaces_task_error(barrier_pyspark):
    def fn():
        if os.environ["HOROVOD_RANK"] == "1":
            raise RuntimeError("task one exploded")
        return "ok"

    with pytest.raises(RemoteJobError) as ei:
        tspark.run(fn)
    assert "rank 1 failed" in str(ei.value)
    assert "task one exploded" in str(ei.value)


def test_spark_run_requires_active_context(barrier_pyspark):
    _StubSparkContext._active_spark_context = None
    with pytest.raises(RuntimeError, match="SparkContext"):
        tspark.run(lambda: 1)


def test_spark_run_requires_pyspark(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyspark", None)
    with pytest.raises(ImportError, match="requires pyspark"):
        tspark.run(lambda: 1)


# ----------------------------------------------------------------------
# The agents and their discovery
# ----------------------------------------------------------------------

def _beat(kv, mod, i, ts, machine="m0"):
    kv.put(mod._SCOPE, f"agent/{i}", json.dumps(
        {"host": f"agent{i}", "machine": machine, "ts": ts}).encode())


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_kv_agent_discovery_and_handle(pkg):
    """The same heartbeat records: the JAX discovery gives each agent a
    host of one slot, the port's each machine a slot per agent on it;
    both drop an agent whose heartbeat stops changing for longer than
    STALE_AFTER_SECONDS on the driver's clock. The handles agree on the
    status and kill keys; the port's kill names the round it is for, and
    its handle reports a worker whose agent is gone as failed."""
    mod = spe if pkg == "port" else jspe
    key = secret_mod.make_secret_key()
    rdv = RendezvousServer(secret=key.encode())
    port = rdv.start()
    try:
        kv = KVClient("127.0.0.1", port, secret=key.encode())
        _beat(kv, mod, 0, 1)
        _beat(kv, mod, 1, 2)
        _beat(kv, mod, 2, 3, machine="m1")
        disc = mod.KVAgentDiscovery(kv, max_agents=4)
        assert disc.find_available_hosts_and_slots() == (
            {"m0": 2, "m1": 1} if pkg == "port"
            else {"agent0": 1, "agent1": 1, "agent2": 1})
        # only the agent whose heartbeat value keeps changing survives a
        # quiet period longer than STALE_AFTER_SECONDS (driver clock)
        _beat(kv, mod, 0, 4)
        real = time.monotonic()
        ctr = itertools.count()
        with mock.patch.object(mod.time, "monotonic",
                               lambda: real + mod.STALE_AFTER_SECONDS + 1
                               + next(ctr) * 0.01):
            assert disc.find_available_hosts_and_slots() == (
                {"m0": 1} if pkg == "port" else {"agent0": 1})
        if pkg == "port":
            assert disc.agents == {"m0": ["agent0"]}
            assert disc.is_fresh("agent0") and not disc.is_fresh("agent1")
        h = mod._AgentHandle(kv, 1, "agent0")
        assert h.poll() is None
        kv.put(mod._SCOPE, "status/1/agent0/0", b"0")
        assert h.poll() == 0
        h2 = mod._AgentHandle(kv, 2, "agent1")
        h2.terminate()
        assert kv.get(mod._SCOPE, "kill/agent1", timeout=0) == (
            b"2" if pkg == "port" else b"1")
        assert h2.poll() == 143
        if pkg == "port":
            assert mod._AgentHandle(kv, 3, "agent1",
                                    alive=lambda: False).poll() == 1
    finally:
        rdv.stop()
    assert (spe._SCOPE, spe.HEARTBEAT_SECONDS, spe.STALE_AFTER_SECONDS) == \
        (jspe._SCOPE, jspe.HEARTBEAT_SECONDS, jspe.STALE_AFTER_SECONDS)


def _slot(machine, local_rank):
    return types.SimpleNamespace(hostname=machine, local_rank=local_rank)


def test_placement_keeps_each_slot_with_its_agent():
    """A survivor's slot keeps its agent, and a fresh slot takes an agent
    that runs no other slot of the round, whatever the agents' indices;
    a machine with no agent to spare gives None."""
    disc = types.SimpleNamespace(agents={"m0": ["agent1"]})
    pl = spe._Placement(disc)
    pl.publish([_slot("m0", 0)], 1)
    assert pl.place(_slot("m0", 0), 1) == "agent1"
    # agent0 registers late: (m0, 0) survives on agent1, (m0, 1) is new
    disc.agents = {"m0": ["agent0", "agent1"]}
    pl.publish([_slot("m0", 0), _slot("m0", 1)], 2)
    assert pl.place(_slot("m0", 1), 2) == "agent0"
    # agent1 is lost and agent2 joins: (m0, 1) survives on agent0, the
    # respawned (m0, 0) takes agent2
    disc.agents = {"m0": ["agent0", "agent2"]}
    pl.publish([_slot("m0", 0), _slot("m0", 1)], 3)
    assert pl.place(_slot("m0", 0), 3) == "agent2"
    assert pl.owner == {("m0", 0): "agent2", ("m0", 1): "agent0"}
    # both respawned: each keeps its agent
    pl.publish([_slot("m0", 0), _slot("m0", 1)], 4)
    assert [pl.place(_slot("m0", k), 4) for k in (0, 1)] == \
        ["agent2", "agent0"]
    # the machine lost an agent after the round was planned
    disc.agents = {"m0": ["agent0"]}
    assert pl.place(_slot("m0", 0), 4) is None


# ----------------------------------------------------------------------
# Elastic runs with threaded agents and real workers
# ----------------------------------------------------------------------

def _agents(show_up=None):
    """Threaded agents (spark.elastic.thread_agent_runner); `show_up`
    caps how many of the requested agents register."""
    runner = spe.thread_agent_runner()
    return lambda n, m, kv: runner(show_up or n, m, kv)


def _make_train_fn():
    def train_fn():
        import torch
        import torch.distributed as dist

        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.spark.backend import worker_device

        hvd.init(device=worker_device())
        try:
            s = int(hvd.allreduce(
                torch.tensor(hvd.rank() + 1, dtype=torch.int32),
                op=hvd.Sum).item())
            return (hvd.rank(), hvd.size(), s, dist.get_backend(),
                    hvd.local_rank(), hvd.local_size())
        finally:
            hvd.shutdown()
    return train_fn


@pytest.fixture(scope="module")
def elastic_jobs():
    """Two elastic jobs with the CPU request, started together at the
    first test that reads one and run side by side (each is mostly its
    workers' start-up): two agents for two workers, and one agent
    showing up for two asked. The futures by name."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield {
            "two": pool.submit(
                spe.run_elastic, _make_train_fn(), num_proc=2,
                min_num_proc=2, start_timeout=30, elastic_timeout=60,
                extra_env=CPU, _agent_runner=_agents()),
            "fewer": pool.submit(
                spe.run_elastic, _make_train_fn(), num_proc=2,
                min_num_proc=1, start_timeout=30, elastic_timeout=60,
                extra_env=CPU, _agent_runner=_agents(show_up=1))}


def test_spark_elastic_happy_path(elastic_jobs):
    """Two agents on this one machine: their workers form one world and
    take local ranks 0 and 1 of 2 (on a card host, cuda:0 and cuda:1)."""
    out = elastic_jobs["two"].result(timeout=120)
    assert out == [(0, 2, 3, "gloo", 0, 2), (1, 2, 3, "gloo", 1, 2)]


def test_spark_elastic_runs_with_fewer_agents(elastic_jobs):
    out = elastic_jobs["fewer"].result(timeout=120)
    assert out == [(0, 1, 1, "gloo", 0, 1)]


def test_spark_elastic_workers_ask_for_the_card(monkeypatch, capfd):
    monkeypatch.setenv("HOROVOD_ELASTIC_FAILED_ROUND_LIMIT", "1")
    with pytest.raises(RuntimeError, match="elastic spark job failed"):
        spe.run_elastic(_make_train_fn(), num_proc=1, start_timeout=30,
                        elastic_timeout=20, _agent_runner=_agents())
    assert "no CUDA device is visible" in capfd.readouterr().err


def test_spark_elastic_no_agents_times_out():
    with pytest.raises(TimeoutError, match="agent registered"):
        spe.run_elastic(_make_train_fn(), num_proc=1, start_timeout=1.0,
                        _agent_runner=lambda n, m, kv: None)


def test_function_ships_as_a_partial_without_cloudpickle(monkeypatch):
    """(fn, args, kwargs) as a functools.partial, pickled by the
    standard pickle when cloudpickle is absent."""
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    seen = {}
    orig_put = KVClient.put

    def put(self, scope, key, value):
        if key == "fn":
            seen["fn"] = pickle.loads(value)
        return orig_put(self, scope, key, value)

    monkeypatch.setattr(KVClient, "put", put)
    with pytest.raises(TimeoutError):
        spe.run_elastic(os.path.join, args=("a",), kwargs={},
                        num_proc=1, start_timeout=0.5,
                        _agent_runner=lambda n, m, kv: None)
    fn = seen["fn"]
    assert isinstance(fn, functools.partial) and fn.func is os.path.join
    assert fn() == "a"


def test_newer_launch_record_replaces_live_worker(tmp_path):
    """The NEWER launch record itself terminates the old process (a live
    worker with a newer launch is a replacement, not a survivor), and a
    kill that names the old round, arriving after the replacement, does
    not stop the new one."""
    import cloudpickle

    key = secret_mod.make_secret_key()
    rdv = RendezvousServer(secret=key.encode())
    port = rdv.start()
    stop = threading.Event()
    marker_dir = str(tmp_path)

    def sleeper():
        import os
        import time as _t
        rnd = os.environ.get("HOROVOD_ELASTIC_ROUND", "?")
        open(os.path.join(os.environ["MARKER_DIR"],
                          f"pid_{rnd}_{os.getpid()}"), "w").close()
        _t.sleep(120)

    def pids(rnd):
        return [int(f.split("_")[-1]) for f in os.listdir(marker_dir)
                if f.startswith(f"pid_{rnd}_")]

    def wait_for(cond, what, timeout=20):
        end = time.monotonic() + timeout
        while time.monotonic() < end and not cond():
            time.sleep(0.05)
        assert cond(), what

    t = None
    try:
        kv = KVClient("127.0.0.1", port, secret=key.encode())
        kv.put(spe._SCOPE, "fn", cloudpickle.dumps(sleeper))
        t = threading.Thread(
            target=spe.agent_main,
            args=(KVClient("127.0.0.1", port, secret=key.encode()), 0),
            kwargs={"stop_event": stop, "poll_interval": 0.05},
            daemon=True)
        t.start()
        wait_for(lambda: kv.get(spe._SCOPE, "agent/0", timeout=0),
                 "agent never heartbeat", 10)
        host = json.loads(kv.get(spe._SCOPE, "agent/0", timeout=0))["host"]

        def launch(round_id):
            kv.put(spe._SCOPE, f"launch/{round_id}/{host}", json.dumps({
                "round": round_id, "rank": 0,
                "env": {"HOROVOD_ELASTIC_ROUND": str(round_id),
                        "MARKER_DIR": marker_dir}}).encode())
            kv.put(spe._SCOPE, "round_hint", str(round_id).encode())

        launch(1)
        wait_for(lambda: pids(1), "round-1 worker never started")
        (old_pid,) = pids(1)
        launch(2)  # no kill key: the launch record is the kill
        wait_for(lambda: pids(2), "round-2 worker never started")

        def gone():
            try:
                os.kill(old_pid, 0)
                return False
            except ProcessLookupError:
                return True

        wait_for(gone, "replaced worker still running", 10)
        # a late kill for the replaced round-1 worker: the agent takes
        # it and spares the round-2 one
        (new_pid,) = pids(2)
        kv.put(spe._SCOPE, f"kill/{host}", b"1")
        wait_for(lambda: kv.get(spe._SCOPE, f"kill/{host}", timeout=0)
                 is None, "the agent never took the kill", 10)
        time.sleep(0.2)
        os.kill(new_pid, 0)  # raises if the replacement was stopped
        kv.put(spe._SCOPE, "stopall", b"1")
    finally:
        stop.set()
        if t is not None:
            t.join(timeout=30)
            assert not t.is_alive()
        rdv.stop()
