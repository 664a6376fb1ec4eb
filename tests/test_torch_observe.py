"""perfscope and the timeline wired into the port's paths, on gloo on
the host.

In a world of one in this process: each eager collective opens one span
on the timeline, named and with the JAX package's activity, and adds to
perfscope's `comms`; DistributedOptimizer closes one implicit step per
applied step (under backward_passes_per_step 2 only on the second
pass), with `comms`, `optimizer` and the bytes it reduced; hvd.init()
starts the timeline from HOROVOD_TIMELINE (and warns, without one, when
the path cannot be written); the ParameterManager marks its sample
boundaries; a kernel build is `compile` time with a COMPILE span each.

Then one launched run: `runner.launch -np 2 --timeline-filename` with
HOROVOD_FLIGHT_DIR starts tests/torch_observe_worker.py on two gloo
ranks. Only rank 0 holds the timeline; its trace loads and holds one
span per bucket each step; the launcher wrote both ranks' perfscope
summaries into the flight directory. The launch is bounded as in
tests/test_torch_launch.py.
"""

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
from horovod_tpu_torch import kernels
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.profiler import perfscope

TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parent
WORKER = str(TESTS / "torch_observe_worker.py")
TOPOLOGY_ENV = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
                "HOROVOD_CROSS_SIZE", "HOROVOD_COORDINATOR_ADDR",
                "HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_GLOO_RENDEZVOUS_PORT",
                "HOROVOD_TIMELINE", "HOROVOD_TIMELINE_MARK_CYCLES",
                "HOROVOD_AUTOTUNE", "HOROVOD_BUCKET_AUTOTUNE",
                "HOROVOD_PERFSCOPE")


@pytest.fixture()
def world(monkeypatch):
    """A fresh world of one on gloo, and a fresh perfscope."""
    for k in TOPOLOGY_ENV:
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    perfscope.reset_for_tests()
    yield monkeypatch
    hvd.shutdown()
    perfscope.reset_for_tests()


def _spans(path):
    return [e for e in json.load(open(path))["traceEvents"]
            if e["ph"] == "X"]


X = torch.arange(8, dtype=torch.float32)

OPS = [
    ("allreduce", "ALLREDUCE", lambda: hvd.allreduce(X)),
    ("allreduce", "ALLREDUCE", lambda: hvd.allreduce_async(X).wait()),
    ("grad.w", "ALLREDUCE", lambda: hvd.allreduce(X, name="grad.w")),
    ("grouped_allreduce", "ALLREDUCE",
     lambda: hvd.grouped_allreduce([X, X[:3]])),
    ("bucketed_allreduce", "ALLREDUCE",
     lambda: hvd.bucketed_allreduce([X, X[:3]])),
    ("allgather", "ALLGATHER", lambda: hvd.allgather(X)),
    ("allgather", "ALLGATHER", lambda: hvd.allgather_async(X).wait()),
    ("grouped_allgather", "ALLGATHER",
     lambda: hvd.grouped_allgather([X, X[:3]])),
    ("reducescatter", "REDUCESCATTER", lambda: hvd.reducescatter(X)),
    ("grouped_reducescatter", "REDUCESCATTER",
     lambda: hvd.grouped_reducescatter([X, X[:4]])),
    ("alltoall", "ALLTOALL", lambda: hvd.alltoall(X)),
    ("broadcast", "BROADCAST", lambda: hvd.broadcast(X, 0)),
    ("broadcast", "BROADCAST",
     lambda: collectives.broadcast_(X.clone(), 0)),
    ("barrier", "BARRIER", lambda: hvd.barrier()),
]


@pytest.mark.parametrize("label,activity,op", OPS,
                         ids=[f"{i}-{o[0]}" for i, o in enumerate(OPS)])
def test_each_collective_opens_one_span_and_adds_comms(world, tmp_path,
                                                        label, activity, op):
    hvd.init(device="cpu")
    path = str(tmp_path / "tl.json")
    hvd.start_timeline(path)
    ps = hvd.perfscope()
    with ps.step():
        op()
    hvd.stop_timeline()
    mine = [e for e in _spans(path) if e["args"]["tensor"] == label]
    assert [e["name"] for e in mine] == [activity]
    s = ps.summary()
    assert s["phases_s"]["comms"] > 0
    assert s["coverage"] == pytest.approx(1.0)


def test_bucketed_allreduce_spans_each_bucket(world, tmp_path):
    world.setenv("HOROVOD_FUSION_THRESHOLD", "40")   # one tensor a bucket
    hvd.init(device="cpu")
    path = str(tmp_path / "tl.json")
    hvd.start_timeline(path)
    hvd.bucketed_allreduce([X, X, X])
    hvd.stop_timeline()
    names = sorted(e["args"]["tensor"] for e in _spans(path))
    assert names == ["bucketed_allreduce", "bucketed_allreduce/b0",
                     "bucketed_allreduce/b1", "bucketed_allreduce/b2"]


def test_no_timeline_and_perfscope_off_read_no_clock(world, monkeypatch):
    """With no timeline, HOROVOD_PERFSCOPE=0 and HOROVOD_METRICS=0 (the
    metrics registry also times each call, on by default as in the JAX
    package) a collective reads no clock."""
    from horovod_tpu_torch.observability import metrics
    world.setenv("HOROVOD_PERFSCOPE", "0")
    world.setenv("HOROVOD_METRICS", "0")
    metrics.reset_for_tests()
    try:
        hvd.init(device="cpu")
        calls = []
        real = time.perf_counter
        monkeypatch.setattr(collectives.time, "perf_counter",
                            lambda: calls.append(1) or real())
        hvd.allreduce(X)
        assert calls == []
    finally:
        metrics.reset_for_tests()  # the next test reads the env anew


def _train(opt, model, passes):
    rets = []
    for _ in range(passes):
        model(torch.ones(2, 4)).sum().backward()
        rets.append(opt.step())
    return rets


@pytest.mark.parametrize("bpps", [1, 2])
def test_optimizer_closes_implicit_steps(world, bpps):
    """Four step() calls: four training steps at bpps 1, two at bpps 2,
    each with comms and optimizer, and the bytes reduced by axis."""
    hvd.init(device="cpu")
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=bpps)
    ps = hvd.perfscope()
    rets = _train(opt, model, 4)
    s = ps.summary()
    assert s["steps"] == 4 // bpps
    assert s["phases_s"]["comms"] > 0 and s["phases_s"]["optimizer"] > 0
    assert s["coverage"] == pytest.approx(1.0)
    assert s["comms_axes"] == {"hvd": 4 * 15}   # 15 f32 gradient values
    if bpps == 2:
        assert rets[0] is None and rets[2] is None


def test_optimizer_buckets_are_spans(world, tmp_path):
    world.setenv("HOROVOD_FUSION_THRESHOLD", "40")
    hvd.init(device="cpu")
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    path = str(tmp_path / "tl.json")
    hvd.start_timeline(path)
    _train(opt, model, 2)
    hvd.stop_timeline()
    buckets = [e["args"]["tensor"] for e in _spans(path)]
    assert len(opt.plan) > 1
    assert sorted(buckets) == sorted(
        [f"bucketed_allreduce/b{i}" for i in range(len(opt.plan))] * 2)


def test_init_starts_the_timeline_from_the_env(world, tmp_path):
    path = tmp_path / "tl.json"
    world.setenv("HOROVOD_TIMELINE", str(path))
    hvd.init(device="cpu")
    assert topology.timeline() is not None
    hvd.allreduce(X)
    hvd.shutdown()
    assert topology.timeline() is None
    assert [e["name"] for e in _spans(path)] == ["ALLREDUCE"]


def test_init_warns_when_the_timeline_cannot_open(world, tmp_path, capfd):
    # a logger made by an earlier test writes to the stderr of its time
    from horovod_tpu_torch.common import hvd_logging
    hvd_logging.reset_for_tests()
    blocker = tmp_path / "file"
    blocker.write_text("")
    world.setenv("HOROVOD_TIMELINE", str(blocker / "tl.json"))
    hvd.init(device="cpu")
    assert topology.timeline() is None
    assert "could not start timeline" in capfd.readouterr().err
    assert hvd.allreduce(X).tolist() == X.tolist()


def test_parameter_manager_marks_cycles(world, tmp_path):
    path = tmp_path / "tl.json"
    world.setenv("HOROVOD_TIMELINE", str(path))
    world.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    world.setenv("HOROVOD_AUTOTUNE", "1")
    world.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "2")
    world.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "1")
    hvd.init(device="cpu")
    pm = topology.parameter_manager()
    for _ in range(6):
        pm.record(1 << 20, 0.01)
        pm.update()
    hvd.shutdown()
    events = json.load(open(path))["traceEvents"]
    marks = [e["name"] for e in events if e["ph"] == "i"]
    assert len(marks) >= 2 and set(marks) == {"CYCLE_START:cycle"}


def test_kernel_build_is_compile_time(world, tmp_path, monkeypatch):
    """A first-use build (nvcc stood in for) is perfscope's compile
    phase, with one COMPILE span a source; a built source is not."""
    hvd.init(device="cpu")
    targets = {n: tmp_path / f"{n}.so" for n in ("k_a", "k_b")}
    monkeypatch.setattr(kernels, "_target", lambda n: str(targets[n]))
    monkeypatch.setattr(kernels, "_start", lambda n: n)

    def finish(n, started):
        time.sleep(0.05)
        targets[n].write_text("")

    monkeypatch.setattr(kernels, "_finish", finish)
    path = str(tmp_path / "tl.json")
    hvd.start_timeline(path)
    ps = hvd.perfscope()
    with ps.step():
        kernels.build_all(["k_a", "k_b"])
        kernels.build_all(["k_a", "k_b"])
    hvd.stop_timeline()
    assert sorted((e["name"], e["args"]["tensor"]) for e in _spans(path)) \
        == [("COMPILE", "k_a"), ("COMPILE", "k_b")]
    s = ps.summary()
    assert s["phases_s"]["compile"] >= 0.1
    assert s["dominant_phase"] == "compile"


def test_launched_run_leaves_trace_and_summaries(tmp_path):
    """The one spawned case: two gloo ranks through the launcher's CLI."""
    trace = tmp_path / "trace.json"
    flight = tmp_path / "flight"
    env = {k: v for k, v in os.environ.items() if k not in TOPOLOGY_ENV}
    env.update(OMP_NUM_THREADS="1", HOROVOD_FLIGHT_DIR=str(flight),
               HOROVOD_FUSION_THRESHOLD="300")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
           "2", "--timeline-filename", str(trace), sys.executable, WORKER]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=90)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=15)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        pytest.fail("the launched run is still running after 90 s")
    assert proc.returncode == 0, out + err
    seen = {}
    for ln in out.splitlines():
        if "<stdout>: {" in ln:
            body = json.loads(ln.split(": ", 1)[1])
            seen[body["rank"]] = body
    assert sorted(seen) == [0, 1]
    assert seen[0]["timeline"] and not seen[1]["timeline"]
    n_buckets = seen[0]["buckets"]
    assert n_buckets > 1
    spans = [e["args"]["tensor"] for e in _spans(trace)
             if e["name"] == "ALLREDUCE"]
    want = [f"bucketed_allreduce/b{i}" for i in range(n_buckets)]
    assert sorted(s for s in spans if "/b" in s) == sorted(want * 3)
    files = sorted(p.name for p in flight.iterdir())
    assert [f for f in files if f.startswith("perf-")] == [
        "perf-rank-0.r0.json", "perf-rank-1.r0.json"]
    # the flight recorder's exit dumps and KV tails and the trace spans
    # land beside them
    assert {"0.json", "1.json", "kv-tail-rank-0.r0.json",
            "kv-tail-rank-1.r0.json", "trace-kv-rank-0.r0.json",
            "trace-kv-rank-1.r0.json"} <= set(files), files
    for r in (0, 1):
        body = json.load(open(flight / f"perf-rank-{r}.r0.json"))
        assert body["rank"] == r and body["size"] == 2
        assert body["summary"]["steps"] == seen[r]["steps"] == 3
        assert body["summary"]["phases_s"]["comms"] > 0
