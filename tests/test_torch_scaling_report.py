"""The PyTorch synthetic benchmark's scaling report, on gloo on the host.

`--scaling-report 2 --device cpu` runs ResNet-50 (32², batch 2, f32; one
warm-up, one iteration of one batch) in a world of 1, then of 2, both
through `runner.run`, and prints one JSON line with the keys of
examples/synthetic_benchmark.py `scaling_report`. On the card, N above
the visible GPUs is refused with both numbers named. The run is bounded:
on expiry the benchmark gets SIGTERM, which terminates its workers.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys

import pytest

from horovod_tpu_torch import synthetic_benchmark as sb

ROOT = pathlib.Path(__file__).resolve().parents[1]
# examples/synthetic_benchmark.py scaling_report, letter for letter.
KEYS = ["model", "per_rank_batch", "ips_1chip", "ips_per_chip_at_n", "n",
        "scaling_efficiency"]
SMALL = ["--device", "cpu", "--image-size", "32", "--batch-size", "2",
         "--dtype", "float32", "--num-warmup-batches", "1", "--num-iters",
         "1", "--num-batches-per-iter", "1"]


def test_scaling_report_two_ranks_on_gloo():
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.synthetic_benchmark",
         "--scaling-report", "2", *SMALL], cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=15)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        pytest.fail("the scaling report ran past 240 s")
    assert proc.returncode == 0, err
    lines = out.strip().splitlines()
    report = json.loads(lines[-1])
    assert list(report) == KEYS
    assert report["model"] == "resnet50" and report["per_rank_batch"] == 2
    assert report["n"] == 2
    assert report["ips_1chip"] > 0 and report["ips_per_chip_at_n"] > 0
    assert report["scaling_efficiency"] > 0
    worlds = [ln for ln in lines if "<stdout>: World:" in ln]
    assert len(worlds) == 2 and "1 rank(s)" in worlds[0] \
        and "2 rank(s)" in worlds[1] and "(gloo)" in worlds[1]


def test_scaling_report_refuses_more_ranks_than_gpus(monkeypatch):
    monkeypatch.setattr(sb.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(sb.torch.cuda, "device_count", lambda: 1)
    argv = ["--scaling-report", "2"]
    with pytest.raises(SystemExit, match="needs 2 GPUs, have 1 visible"):
        sb.scaling_report(sb.parse_args(argv), argv)


@pytest.mark.parametrize("argv,want", [
    (["--scaling-report", "4", "--batch-size", "8"], ["--batch-size", "8"]),
    (["--batch-size", "8", "--scaling-report=4"], ["--batch-size", "8"]),
    (["--device", "cpu", "--scaling-report", "2", "--num-iters", "2"],
     ["--device", "cpu", "--num-iters", "2"]),
])
def test_workers_get_the_flags_without_the_report(argv, want):
    assert sb._strip_report(argv) == want
    assert sb.parse_args(want).scaling_report is None
