"""The runtime control plane of the port across processes, on gloo on
this host's CPU.

Worlds of 2 through tests/torch_world_worker.py (one deadline each;
tests/torch_control_worker.py holds the ranks):
- a stall: rank 1 reaches an all-reduce 4 s after rank 0, whose wait
  the watchdog raises as HorovodInternalError naming the collective
  within the 1 s shutdown window plus a 2.5 s margin (a loaded host),
  with its flight dump naming it too (the contract of tests/test_faults.py:488 and
  tests/test_native.py's stall cases on the port);
- a divergent call order, which the fingerprint verifier
  (HOROVOD_CHECK_COLLECTIVES, interval 1) turns into a
  CollectiveDivergenceError naming the first divergent call on both
  ranks (tests/test_hvdlint.py:990, 1001; tests/test_multiprocess.py:177);
- the consistency check on DistributedOptimizer's hook path, over the
  native KV server: one round a step however many buckets the step has,
  one for an eager call, and one for the version handshake.
Then one launched job (`runner.launch -np 2`, bounded as in
tests/test_torch_observe.py) with HOROVOD_KV_REPLICAS=3: it survives a
host_kill of its primary KV replica, every acknowledged write read back
(tests/test_kv_ha_e2e.py); `GET /metrics` on the new primary holds both
ranks' collective counters while the job runs, and the flight tails and
trace spans are in HOROVOD_FLIGHT_DIR at its end
(tests/test_metrics_e2e.py). Unit cases of the watchdog
on a fake Work: its restore-grace re-arm and the bound on it
(tests/test_ckpt.py:536, 574).
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

import torch_control_worker as W
from torch_world_worker import spawn_world
from torch_threads import leftover, snapshot

@pytest.fixture(scope="module", autouse=True)
def threads_at_start():
    return snapshot()


TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parent
TOPOLOGY_ENV = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
                "HOROVOD_CROSS_SIZE", "HOROVOD_COORDINATOR_ADDR",
                "HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_GLOO_RENDEZVOUS_PORT",
                "HOROVOD_NATIVE_KV_ADDR", "HOROVOD_NATIVE_KV_PORT",
                "HOROVOD_FLIGHT_DIR", "HOROVOD_KV_REPLICAS",
                "HOROVOD_FAULT_SPEC")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in TOPOLOGY_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _read(paths):
    return [json.load(open(p)) for p in paths]


# ---------------------------------------------------------- gloo worlds

def test_stall_raises_on_the_waiting_rank_within_the_window(tmp_path):
    window, late, margin = 1, 4, 2.5
    outs = [str(tmp_path / f"r{r}.json") for r in range(2)]
    flight = str(tmp_path / "flight")
    spawn_world(W.stall, [(r, 2, str(tmp_path / "store"), outs[r], flight,
                           window, late) for r in range(2)], tmp_path,
                deadline=60)
    r0, _ = _read(outs)
    assert r0["raised"] == "HorovodInternalError", r0
    assert "collective 'grads' stalled past " \
        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS=1s" in r0["message"]
    assert window <= r0["seconds"] < window + margin, r0["seconds"]
    dump = json.load(open(os.path.join(flight, "0.json")))
    assert dump["trigger"] == "stall_watchdog"
    assert any(e[2] == "stall" and "'grads'" in e[3]
               for e in dump["events"])
    assert any(e[2] == "collective" and e[4] == "grads"
               for e in dump["events"])


@pytest.fixture()
def rendezvous():
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    srv = RendezvousServer()
    srv.start()
    yield srv
    srv.stop()


def test_divergent_call_order_raises_collective_divergence(tmp_path,
                                                           rendezvous):
    outs = [str(tmp_path / f"r{r}.json") for r in range(2)]
    spawn_world(W.diverge, [(r, 2, str(tmp_path / "store"), outs[r],
                             rendezvous.port) for r in range(2)], tmp_path,
                deadline=60)
    for body in _read(outs):
        assert body["raised"] == "CollectiveDivergenceError", body
        # detected at the next call's dispatch, before it goes out
        assert body["done"] == (["w"] if body["rank"] == 0 else ["b"])
        msg = body["message"]
        assert "first divergent call #0: rank " in msg
        assert "|name=w" in msg and "|name=b" in msg


def test_consistency_check_is_one_round_a_step_not_a_bucket(tmp_path):
    from horovod_tpu_torch import native
    if not native.available():
        pytest.skip("no C++ toolchain on this host")
    srv = native.NativeKVServer()
    try:
        outs = [str(tmp_path / f"r{r}.json") for r in range(2)]
        spawn_world(W.rounds, [(r, 2, str(tmp_path / "store"), outs[r],
                                srv.port, 3) for r in range(2)], tmp_path,
                    deadline=60)
    finally:
        srv.stop()
    for body in _read(outs):
        assert body["buckets"] > 2, body
        assert body["handshake"] == 1
        assert body["per_step"] == [1, 1, 1]
        assert body["eager"] == 1


# ------------------------------------------------------- the watchdog

class FakeWork:
    def __init__(self):
        self.done = threading.Event()

    def is_completed(self):
        return self.done.is_set()

    def wait(self):
        return True


def test_stall_watchdog_rearms_while_peer_restores(monkeypatch):
    from horovod_tpu_torch.ckpt import resume
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.common.resilience import PyStallInspector
    from horovod_tpu_torch.ops import collectives
    restoring = {"on": True}
    monkeypatch.setattr(resume, "peer_restore_active",
                        lambda kv=None: restoring["on"])
    monkeypatch.setattr(collectives, "_abort_world", lambda reason: None)
    wd = collectives.StallWatchdog(PyStallInspector(10.0, 0.0),
                                   warn_sec=0.05, shutdown_sec=0.15,
                                   poll_interval=0.01)
    work = FakeWork()
    # The wait lasts past three bare windows and ends while the peer
    # still restores: the window re-armed each time, no raise.
    t = threading.Timer(0.5, work.done.set)
    t.start()
    wd.guard("resume_bcast", work)
    t.join()
    restoring["on"] = False
    with pytest.raises(HorovodInternalError, match="stalled past"):
        wd.guard("resume_bcast", FakeWork())


def test_stall_grace_is_bounded_by_grace_max(monkeypatch):
    from horovod_tpu_torch.ckpt import resume
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.common.resilience import PyStallInspector
    from horovod_tpu_torch.ops import collectives
    monkeypatch.setattr(resume, "peer_restore_active", lambda kv=None: True)
    monkeypatch.setattr(collectives, "_abort_world", lambda reason: None)
    monkeypatch.setenv("HOROVOD_CKPT_RESTORE_GRACE_MAX", "0.2")
    wd = collectives.StallWatchdog(PyStallInspector(10.0, 0.0),
                                   warn_sec=0.05, shutdown_sec=0.1,
                                   poll_interval=0.01)
    t0 = time.monotonic()
    with pytest.raises(HorovodInternalError, match="stalled past"):
        wd.guard("resume_bcast", FakeWork())
    assert time.monotonic() - t0 < 5.0


# -------------------------------------------------------- launched jobs

class Launch:
    """`runner.launch -np 2` of torch_control_worker.main, bounded: a
    job still running at the deadline is terminated, then its group
    killed."""

    def __init__(self, tmp_path, env, timeout=90):
        self.go = tmp_path / "go"
        self.port_file = tmp_path / "rdv.port"
        # The workers stop by the go file, or a few seconds before this
        # deadline: one clock for the test and its job, where each rank
        # used to give itself 60 s from its own start.
        env = {**os.environ, **env, "CONTROL_TEST_GO": str(self.go),
               "CONTROL_TEST_DEADLINE": str(time.time() + timeout - 10),
               "HOROVOD_RENDEZVOUS_PORT_FILE": str(self.port_file),
               "HOROVOD_METRICS_PUSH_INTERVAL": "0.2"}
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", "2", sys.executable, str(TESTS / "torch_control_worker.py")]
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     start_new_session=True)
        self.end = time.monotonic() + timeout

    def endpoints(self):
        while time.monotonic() < self.end:
            if self.port_file.exists() and self.port_file.read_text():
                return self.port_file.read_text().split(",")
            assert self.proc.poll() is None, self.proc.communicate()
            time.sleep(0.1)
        pytest.fail("the launcher never announced its endpoints")

    def finish(self):
        self.go.touch()
        try:
            out, err = self.proc.communicate(
                timeout=max(1.0, self.end - time.monotonic()))
        except subprocess.TimeoutExpired:
            self.proc.terminate()
            try:
                out, err = self.proc.communicate(timeout=15)
            finally:
                if self.proc.poll() is None:
                    os.killpg(self.proc.pid, signal.SIGKILL)
                    self.proc.communicate()
            pytest.fail("the launched job is still running at its deadline")
        assert self.proc.returncode == 0, out + err
        seen = {}
        for ln in out.splitlines():
            if "<stdout>: {" in ln:
                body = json.loads(ln.split(": ", 1)[1])
                seen[body["rank"]] = body
        assert sorted(seen) == [0, 1], out + err
        return seen, out + err


def wait_for(job, ready, what):
    """Poll `ready()` until it holds; a wait that reaches the job's
    deadline fails the test naming what it waited for."""
    while not ready():
        if time.monotonic() >= job.end:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.2)


@pytest.fixture()
def launches():
    started = []
    yield lambda *a, **kw: started.append(Launch(*a, **kw)) or started[-1]
    for job in started:
        if job.proc.poll() is None:
            os.killpg(job.proc.pid, signal.SIGKILL)
            job.proc.communicate()


def test_launched_job_scrape_and_replicated_control_plane(tmp_path,
                                                          launches):
    """One launched job under HOROVOD_KV_REPLICAS=3 whose primary replica
    is host_killed after 40 writes: it fails over to epoch 2, the new
    primary's `/metrics` holds both ranks, every step's write is read
    back, and the records are in the flight directory at the end."""
    from horovod_tpu_torch.common.resilience import RetryPolicy
    from horovod_tpu_torch.runner.rendezvous import KVClient
    secret = "control-plane-test-secret-0123456789"
    flight = tmp_path / "flight"
    job = launches(tmp_path, {
        "HOROVOD_SECRET_KEY": secret, "HOROVOD_FLIGHT_DIR": str(flight),
        "HOROVOD_KV_REPLICAS": "3", "HOROVOD_KV_PROBE_INTERVAL": "0.1",
        "HOROVOD_FAULT_SPEC": "site=kv_ha.put.r0,kind=host_kill,after=40,"
                              "count=1"})
    eps = job.endpoints()
    assert len(eps) == 3
    wait_for(job, lambda: job.port_file.read_text().split(",")[0] != eps[0],
             "the failover to a new primary")
    primary = job.port_file.read_text().split(",")[0]
    info = json.loads(urllib.request.urlopen(
        f"http://{primary}/leader", timeout=5).read())
    assert info["role"] == "primary" and info["epoch"] == 2, info
    scraped = {}

    def both_ranks_scraped():
        scraped["text"] = urllib.request.urlopen(
            f"http://{primary}/metrics", timeout=5).read().decode()
        return all(f'dtype="float32",rank="{r}"}}' in scraped["text"]
                   for r in (0, 1))

    wait_for(job, both_ranks_scraped,
             "both ranks' counters on the new primary's /metrics")
    text = scraped["text"]
    for r in (0, 1):
        assert ('horovod_collective_calls_total{op="allreduce",'
                f'dtype="float32",rank="{r}"}}') in text, text[-2000:]
        assert f'horovod_perfscope_steps_total{{rank="{r}"}}' in text
    host, port = primary.rsplit(":", 1)
    kv = KVClient(host, int(port), secret=secret.encode(),
                  retry_policy=RetryPolicy(max_attempts=3, base_delay=0.05),
                  endpoints=eps)

    def steps_of(rank):
        s = 0
        while kv.get("job", f"r{rank}-s{s}", timeout=0) is not None:
            s += 1
        return s

    after = {r: steps_of(r) for r in (0, 1)}
    wait_for(job, lambda: all(steps_of(r) >= after[r] + 5 for r in (0, 1)),
             "5 more steps of each rank after the failover")
    seen, _ = job.finish()
    for r, body in seen.items():
        assert body["steps"] >= after[r] + 5 and body["lost"] == [], body
        assert body["failovers"] >= 1, body
    files = {p.name for p in flight.iterdir()}
    for r in (0, 1):
        assert f"kv-tail-rank-{r}.r0.json" in files, files
        assert f"trace-kv-rank-{r}.r0.json" in files, files
        assert f"perf-rank-{r}.r0.json" in files, files
    tail = json.load(open(flight / "kv-tail-rank-0.r0.json"))
    assert any(e[2] == "collective" for e in tail["events"])


def test_no_thread_left_behind(threads_at_start):
    assert not leftover(threads_at_start), leftover(threads_at_start)
