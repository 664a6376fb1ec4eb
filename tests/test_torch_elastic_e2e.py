"""Elastic and checkpoint end-to-end jobs of the port on gloo: the three
jobs of tests/test_elastic_e2e.py and the two of tests/test_ckpt_e2e.py.

Each job is the port's launcher in elastic mode
(`python -m horovod_tpu_torch.runner.launch --host-discovery-script`)
over tests/torch_elastic_worker.py, with a discovery script that reads a
hosts file the test rewrites mid-run, each under its own timeout:

1. scale down keeps the survivors (never respawned) and their state;
2. scale up syncs the joiner from rank 0;
3. a crashed worker's peers recover from the last commit;
4. a whole-job SIGKILL resumes from the last COMMITTED step, exactly
   once, to the uninterrupted twin's final value;
5. the uninterrupted twin.
"""

import math
import os
import subprocess
import sys
import time

import pytest

HERE = os.path.dirname(__file__)
WORKER = os.path.join(HERE, "torch_elastic_worker.py")
JOB_TIMEOUT = 150.0


def write_hosts(path, spec: str) -> None:
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(spec.split(",")) + "\n")
    os.replace(tmp, path)  # atomic: discovery never sees a partial file


def start_job(tmp_path, mode, extra_env=None, cooldown=("300", "600")):
    hosts_file = tmp_path / "hosts.txt"
    progress = tmp_path / "progress.txt"
    script = tmp_path / "discover.sh"
    script.write_text(f"#!/bin/sh\ncat {hosts_file}\n")
    script.chmod(0o755)
    env = dict(os.environ)
    env.update({
        "ELASTIC_PROGRESS_FILE": str(progress),
        "OMP_NUM_THREADS": "1",
        # gloo reports a dead peer at once; this bounds anything else
        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "60",
    })
    env.update(extra_env or {})
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "--host-discovery-script", str(script),
           "--slots-per-host", "1", "--min-np", "1",
           "--elastic-timeout", "120",
           "--blacklist-cooldown-range", *cooldown,
           sys.executable, WORKER, mode]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    return proc, hosts_file, progress


def _kill(proc) -> str:
    import signal
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    out, _ = proc.communicate()
    return out


def wait_for_step(progress, step: int, proc, timeout: float = 90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            lines = progress.read_text().split()
            if lines and max(int(x) for x in lines) >= step:
                return
        except FileNotFoundError:
            pass
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    pytest.fail(f"training never reached step {step}; job output:\n"
                f"{_kill(proc)}")


def finish(proc, timeout: float = JOB_TIMEOUT) -> str:
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        pytest.fail(f"elastic job hung; output:\n{_kill(proc)}")
    assert proc.returncode == 0, f"job failed rc={proc.returncode}:\n{out}"
    return out


def test_elastic_scale_down_preserves_survivors(tmp_path):
    proc, hosts_file, progress = start_job(tmp_path, "resize")
    write_hosts(hosts_file, "localhost:3")
    wait_for_step(progress, 3, proc)
    write_hosts(hosts_file, "localhost:2")
    out = finish(proc)
    # Exactly the 3 original processes booted: survivors NOT respawned.
    assert out.count("WORKER_BOOT") == 3, out
    assert "RESIZED old=3 new=2" in out, out
    assert out.count("ELASTIC_DONE") == 2, out
    for line in out.splitlines():
        if "ELASTIC_DONE" in line:
            assert "step=12" in line and "w=12.000" in line, line


def test_elastic_scale_up_syncs_new_worker(tmp_path):
    proc, hosts_file, progress = start_job(tmp_path, "resize")
    write_hosts(hosts_file, "localhost:2")
    wait_for_step(progress, 3, proc)
    write_hosts(hosts_file, "localhost:3")
    out = finish(proc)
    # 2 original boots + 1 joiner, which reaches the full count only
    # through the state sync from rank 0
    assert out.count("WORKER_BOOT") == 3, out
    assert "RESIZED old=2 new=3" in out, out
    assert out.count("ELASTIC_DONE") == 3, out
    for line in out.splitlines():
        if "ELASTIC_DONE" in line:
            assert "step=12" in line and "w=12.000" in line, line


def test_elastic_crash_recovers_from_last_commit(tmp_path):
    proc, hosts_file, progress = start_job(
        tmp_path, "crash",
        extra_env={"ELASTIC_CRASH_HOSTNAME": "127.0.0.1",
                   "ELASTIC_CRASH_STEP": "5"})
    write_hosts(hosts_file, "localhost:1,127.0.0.1:1")
    wait_for_step(progress, 6, proc)
    write_hosts(hosts_file, "localhost:1")
    out = finish(proc)
    assert "CRASHING host=127.0.0.1 step=5" in out, out
    assert out.count("WORKER_BOOT") == 2, out  # the survivor stayed
    done = [l for l in out.splitlines() if "ELASTIC_DONE" in l]
    assert len(done) == 1, out
    assert "size=1" in done[0] and "step=12" in done[0] \
        and "w=12.000" in done[0], done[0]


CKPT_TOTAL = 10
KILL_STEP = 4


def start_ckpt_job(tmp_path, kill_step):
    return start_job(
        tmp_path, "ckpt", cooldown=("2", "4"),
        extra_env={"ELASTIC_TOTAL_STEPS": str(CKPT_TOTAL),
                   "ELASTIC_CKPT_KILL_STEP": str(kill_step),
                   "HOROVOD_CKPT_DIR": str(tmp_path / "ckpts")})


def _done_w(out):
    return [l.split("w=")[1].strip() for l in out.splitlines()
            if "ELASTIC_DONE" in l]


def test_ckpt_sigkill_resumes_from_last_committed_step(tmp_path):
    proc, hosts_file, progress = start_ckpt_job(tmp_path, KILL_STEP)
    write_hosts(hosts_file, "localhost:1,127.0.0.1:1")
    out = finish(proc)
    kills = [l for l in out.splitlines() if "CKPT_KILL" in l]
    assert len(kills) == 2, out
    assert all(f"step={KILL_STEP}" in l for l in kills), kills
    # round 2 booted FRESH processes and restored from the checkpoint at
    # exactly the last committed step, not step 0
    assert out.count("WORKER_BOOT") >= 4, out
    resumes = [l for l in out.splitlines()
               if "RESUME step=" in l and "source=checkpoint" in l]
    assert any(f"RESUME step={KILL_STEP} " in l for l in resumes), out
    late = [l for l in out.splitlines()
            if "RESUME step=" in l and "round=1" not in l]
    assert late and all("RESUME step=0 " not in l for l in late), late
    # exactly once: no committed step re-executed, none skipped
    steps = [int(x) for x in progress.read_text().split()]
    post_kill = [s for s in steps if s > KILL_STEP]
    assert post_kill and min(post_kill) == KILL_STEP + 1, steps
    assert sorted(set(steps)) == sorted(steps), steps
    assert max(steps) == CKPT_TOTAL, steps
    done = _done_w(out)
    assert len(done) == 2 and all(w == f"{float(CKPT_TOTAL):.3f}"
                                  for w in done), out


def test_ckpt_uninterrupted_twin_matches(tmp_path):
    proc, hosts_file, progress = start_ckpt_job(tmp_path, 0)
    write_hosts(hosts_file, "localhost:1,127.0.0.1:1")
    out = finish(proc)
    assert out.count("WORKER_BOOT") == 2, out
    assert "CKPT_KILL" not in out, out
    assert not any("source=checkpoint" in l for l in out.splitlines()
                   if "RESUME step=" in l), out
    done = _done_w(out)
    assert len(done) == 2 and all(w == f"{float(CKPT_TOTAL):.3f}"
                                  for w in done), out
    steps = [int(x) for x in progress.read_text().split()]
    assert max(steps) == CKPT_TOTAL and len(set(steps)) == len(steps)


# ------------------------- the elastic ResNet check of chip_smoke phase 10

RESNET = ["-m", "horovod_tpu_torch.elastic.resnet_check", "--device", "cpu",
          "--image", "32", "--batch", "8"]


def run_resnet_check(tmp_path, hosts, flags, cooldown=("1", "1")):
    """The launcher in elastic mode over elastic/resnet_check.py, as
    chip_smoke.py phase 10 starts it; returns ({step: loss}, lines)."""
    os.makedirs(tmp_path, exist_ok=True)
    hosts_file = tmp_path / "hosts.txt"
    write_hosts(hosts_file, hosts)
    script = tmp_path / "discover.sh"
    script.write_text(f"#!/bin/sh\ncat {hosts_file}\n")
    script.chmod(0o755)
    env = dict(os.environ, OMP_NUM_THREADS="1", HOROVOD_CKPT_EVERY="1",
               HOROVOD_CKPT_DIR=str(tmp_path / "ckpts"),
               HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="60")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "--host-discovery-script", str(script), "--slots-per-host", "1",
           "--min-np", "1", "--elastic-timeout", "120",
           "--blacklist-cooldown-range", *cooldown,
           sys.executable, *RESNET, "--hosts-file", str(hosts_file), *flags]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    out = finish(proc)
    lines = [l.split(">: ", 1)[-1] for l in out.splitlines()]
    losses = {}
    for l in lines:
        if l.startswith("STEP "):
            f = dict(kv.split("=", 1) for kv in l.split()[1:])
            losses.setdefault(int(f["step"]), set()).add(f["loss"])
    assert losses and all(math.isfinite(float(v)) for vs in losses.values()
                          for v in vs), out
    return losses, lines, out


def _field(lines, prefix, key):
    return [dict(kv.split("=", 1) for kv in l.split()[1:])[key]
            for l in lines if l.startswith(prefix)]


@pytest.fixture(scope="module")
def resnet_twin(tmp_path_factory):
    """The uninterrupted one-process run both checks end on."""
    losses, lines, _ = run_resnet_check(
        tmp_path_factory.mktemp("twin"), "localhost:1",
        ["--steps", "8", "--digest-steps", "6,8"])
    return losses, lines


def test_resnet_check_preempted_resumes_bit_for_bit(tmp_path, resnet_twin):
    """Phase 10 (d) at a small size: killed after step 3's commit, the
    job resumes from the checkpoint in a fresh process and ends on the
    uninterrupted twin's losses and weights."""
    twin, tl = resnet_twin
    got, gl, out = run_resnet_check(
        tmp_path / "kill", "localhost:1",
        ["--steps", "6", "--kill-step", "3", "--digest-steps", "6"])
    assert len(_field(gl, "KILL", "step")) == 1, out
    resumes = [l for l in gl if l.startswith("RESUME") and "round=2" in l]
    assert resumes and "step=3 source=checkpoint" in resumes[0], out
    assert sorted(got) == list(range(1, 7))
    assert got == {k: twin[k] for k in got}
    assert all(len(v) == 1 for v in got.values())
    assert _field(gl, "DIGEST", "digest") == \
        _field(tl, "DIGEST", "digest")[:1]


def test_resnet_check_survivor_recovers_and_joiner_syncs(tmp_path,
                                                         resnet_twin):
    """Phase 10 (e) on gloo: in a world of 2 rank 1 exits at step 5; the
    survivor's collective raises, it restores step 4's commit, re-joins
    round 2 at size 1, then grows back to 2 with a joiner that syncs from
    rank 0; every rank ends on a one-process run's weights."""
    twin, tl = resnet_twin
    got, gl, out = run_resnet_check(
        tmp_path / "resize", "localhost:2",
        ["--steps", "8", "--exit-step", "5", "--exit-rank", "1",
         "--grow-step", "6"])
    assert _field(gl, "EXIT", "step") == ["5"], out
    assert _field(gl, "RAISED", "step") == ["5"], out
    sizes = {int(s) for s in _field(gl, "RESUME", "size")}
    assert sizes == {1, 2}, out
    assert got == twin and all(len(v) == 1 for v in got.values()), out
    done = _field(gl, "DONE", "digest")
    assert len(done) == 2 and set(done) == set(_field(tl, "DONE", "digest"))
    assert _field(tl, "DIGEST", "digest")[-1] == done[0]
