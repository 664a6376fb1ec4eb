"""The port's serving tier end to end on this host's CPU: the two cases
of tests/test_serve_e2e.py, on one launched job.

`python -m horovod_tpu_torch.serve` spawns two replica processes
(tests/torch_serve_replica.py, on the CPU, which they ask for) that
restore params-only from a training checkpoint the port wrote; four
client threads drive load through the authenticated frontend while one
replica is SIGKILLed. Then:

* every accepted request is answered, with the right value, and p99
  over the run (the kill included) stays under 10x the steady p50;
* `hvddoctor` (the port's) names the killed replica in its [serve]
  section, from the flight dumps and KV tails the launcher persisted;
* `hvddoctor --json --trace` joins the per-process span fragments into
  complete cross-process traces: the slowest request's queue, dispatch
  and device split, and a requeued request with both dispatch attempts
  (the failed one on the dead replica, the retry on the survivor);
* the job drains and exits 0.

Every launched process runs under tests/torch_guard.py with one shared
deadline: a hung process prints its stacks and exits before the test's
own bound kills what is left.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GUARD = os.path.join(HERE, "torch_guard.py")
REPLICA = os.path.join(HERE, "torch_serve_replica.py")

FEATURES = 4
SECRET = "ab" * 32
DEADLINE_S = 100.0


def _expected(v: float) -> float:
    return v * sum(range(1, FEATURES + 1)) + 0.5


def _write_hosts(path, spec: str) -> None:
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(spec.split(",")) + "\n")
    os.replace(tmp, path)


def _save_checkpoint(tmp) -> str:
    """A training-shaped checkpoint (params + optimizer state) written
    by the port without an initialized world."""
    import torch

    from horovod_tpu_torch import checkpoint
    path = str(tmp / "train_ck")
    checkpoint.save(path, {
        "params": {"w": torch.arange(1, FEATURES + 1,
                                     dtype=torch.float32),
                   "b": torch.tensor(0.5)},
        "opt": {"mu": {"w": torch.ones(FEATURES)},
                "count": np.int64(77)}})
    return path


def _load(addr, stop, lock, latencies, results, failures, tid):
    from horovod_tpu_torch.serve.frontend import ServeClient
    c = ServeClient(addr, secret=SECRET.encode())
    i = 0
    try:
        while not stop.is_set():
            v = float(tid * 10000 + i)
            t0 = time.perf_counter()
            try:
                out = c.infer(np.full((FEATURES,), v, np.float32))
            except Exception as e:
                with lock:
                    failures.append((v, repr(e)))
                return
            dt = time.perf_counter() - t0
            with lock:
                latencies.append((time.monotonic(), dt))
                results.append((v, float(np.ravel(out)[0])))
            i += 1
            time.sleep(0.01)
    finally:
        c.close()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One serving job with a SIGKILL under load; what both cases read."""
    from horovod_tpu_torch.serve.frontend import (ServeClient,
                                                  wait_for_port_file)
    tmp = tmp_path_factory.mktemp("serve_e2e")
    ckpt_path = _save_checkpoint(tmp)
    hosts_file = tmp / "hosts.txt"
    script = tmp / "discover.sh"
    script.write_text(f"#!/bin/sh\ncat {hosts_file}\n")
    script.chmod(0o755)
    port_file = tmp / "serve.port"
    flight_dir = tmp / "flight"
    pid_dir = tmp / "pids"
    end = time.time() + DEADLINE_S
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": os.pathsep.join([REPO, HERE]),
        "OMP_NUM_THREADS": "1",
        "HOROVOD_SECRET_KEY": SECRET,
        "HOROVOD_SERVE_PORT_FILE": str(port_file),
        "HOROVOD_FLIGHT_DIR": str(flight_dir),
        "SERVE_TEST_CHECKPOINT": ckpt_path,
        "SERVE_TEST_PID_DIR": str(pid_dir),
        "SERVE_TEST_FEATURES": str(FEATURES),
        "HOROVOD_SERVE_MAX_BATCH": "4",
        "HOROVOD_SERVE_MAX_WAIT_MS": "20",
        "HOROVOD_SERVE_REPLICA_TIMEOUT": "5",
        "HOROVOD_METRICS_PUSH_INTERVAL": "0.2",
    })
    _write_hosts(hosts_file, "localhost:1,127.0.0.1:1")
    cmd = [sys.executable, GUARD, str(end), "-m", "horovod_tpu_torch.serve",
           "--host-discovery-script", str(script),
           "--slots-per-host", "1", "--min-np", "1",
           "--elastic-timeout", "60",
           "--blacklist-cooldown-range", "300", "600",
           "--", sys.executable, GUARD, str(end), REPLICA]
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    out_lines = []
    reader = threading.Thread(
        target=lambda: out_lines.extend(proc.stdout), daemon=True)
    reader.start()
    lock = threading.Lock()
    latencies, results, failures = [], [], []
    victim_pid = None
    t_kill = None
    try:
        port = wait_for_port_file(str(port_file), timeout=60)
        addr = ("127.0.0.1", port)
        probe = ServeClient(addr, secret=SECRET.encode())
        while time.time() < end - 30:
            try:
                if len(os.listdir(pid_dir)) >= 2:
                    out = probe.infer(np.full((FEATURES,), 1.0, np.float32))
                    assert abs(float(out) - _expected(1.0)) < 1e-4
                    break
            except (OSError, ConnectionError):
                pass
            time.sleep(0.2)
        else:
            pytest.fail("replicas never came up:\n" + "".join(out_lines))
        stop = threading.Event()
        threads = [threading.Thread(
            target=_load, args=(addr, stop, lock, latencies, results,
                                failures, t), daemon=True)
            for t in range(4)]
        for t in threads:
            t.start()
        time.sleep(2.0)
        t_kill = time.monotonic()
        with open(os.path.join(pid_dir, "127.0.0.1")) as f:
            victim_pid = int(f.read().strip())
        os.kill(victim_pid, signal.SIGKILL)
        _write_hosts(hosts_file, "localhost:1")
        time.sleep(3.0)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        alive = [t for t in threads if t.is_alive()]
        probe.shutdown()
        probe.close()
        rc = proc.wait(timeout=max(1.0, end - time.time()))
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(10)
        reader.join(10)
    return {"rc": rc, "out": "".join(out_lines), "alive": alive,
            "latencies": latencies, "results": results,
            "failures": failures, "victim": victim_pid, "t_kill": t_kill,
            "flight_dir": str(flight_dir), "tmp": tmp}


def test_serving_survives_replica_sigkill_under_load(run):
    from horovod_tpu_torch.observability import doctor
    assert run["rc"] == 0, run["out"]
    assert not run["alive"]
    assert not run["failures"], run["failures"]
    res = run["results"]
    assert len(res) > 50, f"too little load ran: {len(res)}"
    for v, out in res:
        assert abs(out - _expected(v)) < max(1e-3, 1e-6 * abs(out)), (v, out)
    steady = sorted(dt for ts, dt in run["latencies"] if ts < run["t_kill"])
    assert steady, "no steady-state samples before the kill"
    p50 = steady[len(steady) // 2]
    lat = sorted(dt for _, dt in run["latencies"])
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
    assert p99 < 10 * max(p50, 0.05), (p99, p50)
    out = run["out"]
    assert "SERVE_REPLICA_UP" in out
    assert "died" in out and "requeued" in out, out
    dumps = doctor.dedupe(doctor.load_dir(run["flight_dir"]))
    assert dumps, sorted(os.listdir(run["flight_dir"]))
    report = doctor.merge(dumps)
    serve = report["serve"]
    assert serve is not None and serve["deaths"], report
    dead = serve["deaths"][0]
    assert dead["pid"] == run["victim"] and dead["host"] == "127.0.0.1"
    text = doctor.render(report)
    assert "SERVE REPLICA DEATH" in text, text
    assert str(run["victim"]) in text, text


def test_serving_trace_reconstruction_across_sigkill(run, capsys):
    from horovod_tpu_torch.observability import doctor
    assert run["rc"] == 0, run["out"]
    names = sorted(os.listdir(run["flight_dir"]))
    assert any(n.startswith("trace-") for n in names), names
    perfetto = run["tmp"] / "perfetto.json"
    assert doctor.main(["--dir", run["flight_dir"], "--json",
                        "--trace", str(perfetto)]) == 0
    report = json.loads(capsys.readouterr().out)
    tr = report["traces"]
    assert tr is not None and tr["requests"] > 0
    assert tr["complete"] >= 1, tr
    complete = [e for e in tr["slowest"] if e["complete"]]
    assert complete, tr["slowest"]
    slow = complete[0]
    for hop in ("queue_s", "dispatch_s", "device_s"):
        assert isinstance(slow[hop], float) and slow[hop] >= 0.0, slow
    assert slow["total_s"] > 0.0 and slow["rid"] is not None
    assert tr["requeued"], tr
    rq = next((e for e in tr["requeued"] if len(e["attempts"]) >= 2), None)
    assert rq is not None, tr["requeued"]
    attempts = sorted(rq["attempts"], key=lambda a: a["attempt"] or 0)
    assert any(a["status"] != "ok" for a in attempts), attempts
    assert attempts[-1]["status"] == "ok", attempts
    assert len({a["replica"] for a in attempts}) >= 2, attempts
    with open(perfetto) as f:
        evs = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" and e.get("cat") == "hvdtrace"
               for e in evs)
    starts = {e["id"] for e in evs if e.get("ph") == "s"
              and e.get("cat") == "hvdtrace.flow"}
    finishes = {e["id"] for e in evs if e.get("ph") == "f"
                and e.get("cat") == "hvdtrace.flow"}
    assert starts & finishes
    rc = doctor.main(["--dir", run["flight_dir"]])
    text = capsys.readouterr().out
    assert rc == 0 and "[serve]" in text and "[traces]" in text
