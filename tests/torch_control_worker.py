"""Ranks for tests/test_torch_control_plane.py.

The gloo-world targets (started by tests/torch_world_worker.py) each
join a world of `size` through a FileStore, set the env their case
needs before hvd.init() reads it, and write what they saw as JSON to
`out`; they end with os._exit so that a world the watchdog gave up on
does not wait in its teardown. `main` is the launched worker of the
metrics scrape and the replicated control plane: it trains a small MLP
on gloo, writes a key to the rendezvous KV each step, and waits for the
test's go-ahead file before it reads its keys back and shuts down; the
ranks agree on the step at which they stop.
"""

import json
import os
import sys
import time


def _init(rank, size, store, env):
    os.environ.update({k: str(v) for k, v in env.items()})
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size))
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", init_method=f"file://{store}")
    return hvd, torch


def _finish(out, body):
    with open(out, "w") as f:
        json.dump(body, f)
    sys.stderr.flush()
    os._exit(0)


def stall(rank, size, store, out, flight_dir, window, late):
    """Rank 1 reaches the all-reduce `late` seconds after rank 0, whose
    wait must raise within the shutdown window."""
    hvd, torch = _init(rank, size, store, {
        "HOROVOD_STALL_CHECK_TIME_SECONDS": 0.5,
        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": window,
        "HOROVOD_FLIGHT_DIR": flight_dir})
    body = {"rank": rank}
    hvd.allreduce(torch.ones(4), name="warmup")
    if rank == 1:
        time.sleep(late)
    t0 = time.monotonic()
    try:
        hvd.allreduce(torch.ones(4), name="grads")
        body["raised"] = None
    except Exception as e:  # noqa: BLE001 - reported to the test
        body["raised"] = type(e).__name__
        body["message"] = str(e)
    body["seconds"] = time.monotonic() - t0
    _finish(out, body)


def diverge(rank, size, store, out, rdv_port):
    """The two ranks issue the same all-reduces in different orders; the
    fingerprint verifier (interval 1) must name the first divergent
    call."""
    hvd, torch = _init(rank, size, store, {
        "HOROVOD_CHECK_COLLECTIVES": 1,
        "HOROVOD_CHECK_COLLECTIVES_INTERVAL": 1,
        "HOROVOD_GLOO_RENDEZVOUS_ADDR": "127.0.0.1",
        "HOROVOD_GLOO_RENDEZVOUS_PORT": rdv_port,
        "HOROVOD_CONSISTENCY_CHECK": 0})
    names = ["w", "b", "c", "d"] if rank == 0 else ["b", "w", "c", "d"]
    body = {"rank": rank, "done": []}
    try:
        for n in names:
            hvd.allreduce(torch.ones(4), name=n)
            body["done"].append(n)
        body["raised"] = None
    except Exception as e:  # noqa: BLE001 - reported to the test
        body["raised"] = type(e).__name__
        body["message"] = str(e)
    _finish(out, body)


def rounds(rank, size, store, out, kv_port, steps):
    """The consistency check on DistributedOptimizer's hook path: its
    KV rounds a step, against the step's buckets."""
    hvd, torch = _init(rank, size, store, {
        "HOROVOD_NATIVE_KV_ADDR": "127.0.0.1",
        "HOROVOD_NATIVE_KV_PORT": kv_port,
        "HOROVOD_FUSION_THRESHOLD": 256})
    from horovod_tpu_torch.core import consistency
    checker = consistency.get()
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 4))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    after_init = checker.rounds
    per_step = []
    for _ in range(steps):
        r0 = checker.rounds
        opt.zero_grad()
        model(torch.randn(4, 16)).square().mean().backward()
        opt.step()
        per_step.append(checker.rounds - r0)
    r0 = checker.rounds
    hvd.allreduce(torch.ones(3), name="eager")
    _finish(out, {"rank": rank, "handshake": after_init,
                  "per_step": per_step, "buckets": len(opt.plan),
                  "eager": checker.rounds - r0})


def main() -> None:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import config as C
    from horovod_tpu_torch.runner.rendezvous import KVClient

    torch.set_num_threads(1)
    go = os.environ["CONTROL_TEST_GO"]
    hvd.init(device="cpu")
    try:
        kv = KVClient(os.environ[C.HOROVOD_RENDEZVOUS_ADDR],
                      int(os.environ[C.HOROVOD_RENDEZVOUS_PORT]))
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                    torch.nn.Linear(16, 4))
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        step, seen = 0, 0
        deadline = time.monotonic() + 60
        # A rank past CONTROL_TEST_GO_LAG sees the go file that many checks
        # late (rank 0 at once), as a loaded host's ranks see it apart.
        lag = int(os.environ.get("CONTROL_TEST_GO_LAG", "0")) \
            if hvd.rank() else 0
        while True:
            seen = seen + 1 if os.path.exists(go) else 0
            stop = seen > lag or time.monotonic() > deadline
            # The ranks stop at the same step: each sees the file, and its
            # own deadline, at its own time, and a rank that stopped alone
            # would leave the other in the next step's all-reduce.
            if hvd.allreduce(torch.tensor([float(stop)]), op=hvd.Max,
                             name="stop").item():
                break
            opt.zero_grad()
            model(torch.randn(4, 8)).square().mean().backward()
            opt.step()
            kv.put("job", f"r{hvd.rank()}-s{step}", str(step).encode())
            step += 1
            time.sleep(0.05)
        lost = [s for s in range(step)
                if kv.get("job", f"r{hvd.rank()}-s{s}", timeout=5)
                != str(s).encode()]
        print(json.dumps({"rank": hvd.rank(), "steps": step,
                          "lost": lost, "failovers": kv.failovers}),
              flush=True)
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
