"""The PyTorch package's launcher across real processes, on gloo on the
host.

`launch_static` starts two workers (tests/torch_launch_worker.py) that
join their world from the env it injects and all-reduce int32 inputs
(fault C3's case through real ranks), once through the launcher's
`tcp://` coordinator and once through the coordinator rank 0 publishes
in the rendezvous KV. Then: a failing rank's exit code comes back
through the CLI and its sibling is terminated; --output-filename writes
per-rank logs; `runner.run(fn, np=2)` returns each rank's result and
raises naming a failed rank; and `hvd.init` refuses a local rank with
no GPU of its own before NCCL is reached.

Every wait is bounded: the in-process launches by their `timeout`, the
CLI by `_run_bounded`, which on expiry sends the launcher SIGTERM (it
then terminates its workers' process groups) and kills it after a
grace period.
"""

import io
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import runner
from horovod_tpu_torch.runner import launch
from horovod_tpu_torch.runner.results import RemoteJobError

TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parent
WORKER = str(TESTS / "torch_launch_worker.py")
ENV = {"OMP_NUM_THREADS": "1", "PYTHONPATH": str(TESTS)}


def _run_bounded(cmd, timeout, env=None):
    """Run `cmd`; on timeout SIGTERM it, then kill its process group."""
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=15)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        pytest.fail(f"{cmd} still running after {timeout} s")
    return proc.returncode, out, err


def _launch_two(extra_args=()):
    buf = io.StringIO()
    rc = launch.launch_static(
        2, "localhost:2", [sys.executable, WORKER, *extra_args], dict(ENV),
        stdout=buf, timeout=120)
    lines = [ln.split(": ", 1) for ln in buf.getvalue().splitlines()
             if "<stdout>: {" in ln]
    return rc, {int(p[1 : p.index("]")]): json.loads(j) for p, j in lines}


def _check_world(seen):
    assert sorted(seen) == [0, 1]
    for r, s in seen.items():
        assert (s["rank"], s["size"], s["local_rank"]) == (r, 2, r)
        assert s["controller"] == "torch"
        assert s["average"] == [3, -4, -8] and s["dtype"] == "torch.int32"
    assert seen[0]["rendezvous"] == seen[1]["rendezvous"]


def test_launch_static_two_workers_allreduce():
    rc, seen = _launch_two()
    assert rc == 0
    _check_world(seen)
    assert seen[0]["rendezvous"].startswith("tcp://")
    assert "rendezvous KV" not in seen[0]["rendezvous"]


def test_kv_published_coordinator_without_coordinator_addr():
    rc, seen = _launch_two(["--kv-coordinator"])
    assert rc == 0
    _check_world(seen)
    assert seen[0]["rendezvous"].startswith("tcp://")
    assert "published through the rendezvous KV" in seen[0]["rendezvous"]


def test_failing_rank_exit_code_and_sibling_terminated():
    code = ("import os, sys, time\n"
            "if os.environ['HOROVOD_RANK'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    rc, _, err = _run_bounded(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", sys.executable, "-c", code], timeout=50)
    assert rc == 3, err
    assert time.monotonic() - t0 < 40  # rank 0 did not sleep it out
    assert f"workers failed: [(0, {-signal.SIGTERM}), (1, 3)]" in err


def test_output_filename_writes_per_rank_logs(tmp_path):
    code = "import os; print('hello from', os.environ['HOROVOD_RANK'])"
    rc, out, err = _run_bounded(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", "--output-filename", str(tmp_path), "-prefix-timestamp",
         sys.executable, "-c", code], timeout=50)
    assert rc == 0, err
    for r in (0, 1):
        assert (tmp_path / f"rank.{r}" / "stdout").read_text() == \
            f"hello from {r}\n"
        assert f"[{r}]<stdout>: hello from {r}" in out


def test_run_returns_each_ranks_result():
    import torch_launch_worker
    assert runner.run(torch_launch_worker.rank_x10, np=2, extra_env=ENV,
                      stdout=io.StringIO(), timeout=120) == [0, 10]


def test_run_raises_naming_the_failed_rank():
    import torch_launch_worker
    with pytest.raises(RemoteJobError,
                       match="(?s)rank 0 failed.*this rank fails"):
        runner.run(torch_launch_worker.fail, np=1, extra_env=ENV,
                   stdout=io.StringIO(), timeout=60)


def test_init_refuses_a_local_rank_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: pytest.fail(
        "set_device reached"))
    monkeypatch.setenv("HOROVOD_RANK", "1")
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "1")
    with pytest.raises(hvd.HorovodError,
                       match="local rank 1 has no GPU of its own: 1 visible"):
        hvd.init()
    assert not hvd.is_initialized()
