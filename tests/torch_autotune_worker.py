"""Worker for tests/test_torch_autotune.py: one rank of a 2-rank gloo
world that trains under each online tuner in turn (HOROVOD_AUTOTUNE,
then HOROVOD_BUCKET_AUTOTUNE, each in its own init) and records, at
every step, the fusion threshold and the optimizer's bucket plan.

Imports torch and horovod_tpu_torch only. Rank 1's deciding functions
raise if called: it may only apply what rank 0 broadcasts. Under the
bucket tuner, rank 0's per-bucket times are replaced by a rate that
favours 1 MiB buckets, so that it makes one decision on any host.
"""

import math
import os

import numpy as np

from torch_collectives_worker import _env

# f32 elements: four 1 MiB parameters and four of 256 KiB.
SIZES = [262144] * 4 + [65536] * 4
STEPS = 16
PM_ENV = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
          "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "1",
          "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "3"}
BT_ENV = {"HOROVOD_BUCKET_AUTOTUNE": "1",
          "HOROVOD_BUCKET_AUTOTUNE_INTERVAL": "1"}
FAST_CLASS = 20  # log2 of 1 MiB


def _refuse(*a, **k):
    raise AssertionError("a rank other than 0 made a tuner decision")


def _train(torch, hvd, fusion, out, tag):
    ps = [torch.nn.Parameter(torch.zeros(n)) for n in SIZES]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=0.0))
    from horovod_tpu_torch.core import topology
    cfg = topology.config()
    thr, sig = [], []
    for _ in range(STEPS):
        opt.zero_grad()
        sum(p.sum() for p in ps).backward()
        opt.step()
        thr.append(cfg.fusion_threshold_bytes)
        sig.append(fusion.plan_signature(opt.plan))
        assert opt.plan_threshold == fusion.effective_threshold(
            cfg.fusion_threshold_bytes, cfg.bucket_cap_bytes)
    out[f"{tag}/threshold"] = np.asarray(thr)
    out[f"{tag}/plan"] = np.asarray(sig)


def run_tuners(rank, size, store, inputs, out_path):
    _env(rank, size, PM_ENV)
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import autotune, topology
    from horovod_tpu_torch.ops import collectives, fusion

    torch.set_num_threads(1)
    out = {}
    if rank != 0:
        autotune.ParameterManager._decide = _refuse
        autotune.OnlineBucketTuner._decide = _refuse
    hvd.init(device="cpu", init_method=f"file://{store}")
    try:
        pm = topology.parameter_manager()
        out["pm/exclusive"] = np.asarray(topology.bucket_tuner() is None)
        _train(torch, hvd, fusion, out, "pm")
        out["pm/frozen"] = np.asarray(pm.frozen)
        out["pm/samples"] = np.asarray(len(pm.samples))
    finally:
        hvd.shutdown()
    out["pm/dropped"] = np.asarray(not topology.is_initialized())

    for k in PM_ENV:
        os.environ.pop(k)
    os.environ.update(BT_ENV)
    if rank == 0:
        results = collectives.BucketTimer.results

        def favour_1mib(self):
            return [(nb, nb / (2e9 if int(math.log2(nb)) == FAST_CLASS
                               else 1e9)) for nb, _ in results(self)]

        collectives.BucketTimer.results = favour_1mib
    hvd.init(device="cpu", init_method=f"file://{store}.bt")
    try:
        bt = topology.bucket_tuner()
        out["bt/exclusive"] = np.asarray(
            topology.parameter_manager() is None)
        _train(torch, hvd, fusion, out, "bt")
        out["bt/frozen"] = np.asarray(bt.frozen)
        out["bt/history"] = np.asarray(bt.history)
        out["bt/decisions"] = np.asarray(len(bt.decisions))
        out["bt/timings"] = np.asarray(
            len(collectives.last_bucket_timings()) if rank == 0 else 0)
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)
