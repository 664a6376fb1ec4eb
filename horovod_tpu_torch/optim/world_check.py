"""The training API in a world of N, held against numpy on every rank:
the phase of `chip_smoke.py` that needs two or more cards, run through
`horovod_tpu_torch.runner.run` (one process per card, or with
device="cpu" one gloo process per rank).

    runner.run(functools.partial(world_check.worker, None), np=4)

Each rank rebuilds every rank's seeded gradients, so each holds the
whole reference: DistributedOptimizer with every op (Average, Sum, Min,
Max, Product on the buckets, Adasum per tensor, groups=2 and
gradient_predivide_factor 4 under Average) against numpy's reduction of
the ranks' f32 gradients; a sparse Embedding gradient against numpy's
scatter-add averaged over the ranks; broadcast_optimizer_state from a
rank 0 that has stepped to ranks that have not (fault C5); join_steps
and join over loops of 2 + rank steps; one OnlineBucketTuner decision
that rank 0 makes and every rank applies, with the optimizer's bucket
plan rebuilt alike on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

SHAPES = [(33, 17), (1000,), (8, 3, 3, 5)]
# Sums of N f32 values: 1e-6 of Σ|x|; Adasum: 1e-5 of the largest value
# (float64 reference, float32 dots); Min, Max and Product exact (the
# port multiplies in rank order, as numpy's prod does).
TOL = {"Average": 1e-6, "Sum": 1e-6, "Adasum": 1e-5, "Min": 0.0,
       "Max": 0.0, "Product": 0.0}


def _grads(rank: int):
    rng = np.random.default_rng(1000 + rank)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _reference(op: str, rows):
    from horovod_tpu_torch.ops.adasum import adasum_numpy_reference
    st = np.stack(rows)
    if op == "Adasum":
        return adasum_numpy_reference(rows)
    return {"Average": lambda: st.astype(np.float64).mean(0),
            "Sum": lambda: st.astype(np.float64).sum(0),
            "Min": lambda: st.min(0), "Max": lambda: st.max(0),
            "Product": lambda: np.prod(st, axis=0)}[op]()


def _check_ops(hvd, dev, k, rank) -> dict:
    grads = [_grads(q) for q in range(k)]
    errs = {}
    cases = [(op, op, {}) for op in TOL] + [
        ("groups2", "Average", {"groups": 2}),
        ("predivide4", "Average", {"gradient_predivide_factor": 4.0})]
    for name, op, kw in cases:
        ps = [torch.nn.Parameter(torch.zeros(s, device=dev))
              for s in SHAPES]
        opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=0.0), op=op,
                                       **kw)
        sum((p * torch.from_numpy(g).to(dev)).sum()
            for p, g in zip(ps, grads[rank])).backward()
        opt.synchronize()
        worst = 0.0
        for i, p in enumerate(ps):
            rows = [grads[q][i] for q in range(k)]
            want = _reference(op, rows)
            got = p.grad.cpu().numpy().astype(np.float64)
            err = float(np.max(np.abs(got - want)))
            scale = float(np.max(np.abs(want))) if op == "Adasum" else \
                float(np.max(np.sum(np.abs(np.stack(rows, 0)), 0)))
            if err > TOL[op] * scale:
                raise AssertionError(f"{name}: tensor {i} off by {err} "
                                     f"(tolerance {TOL[op] * scale})")
            worst = max(worst, err)
        errs[name] = {"max_abs_err": worst, "hooked": opt.hooked,
                      "collectives": opt.collectives_per_step}
    return errs


def _check_sparse(hvd, dev, k, rank) -> dict:
    """Embedding(50, 4, sparse=True): rows 3·rank + (0..5) get ones."""
    emb = torch.nn.Embedding(50, 4, sparse=True, device=dev)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(emb.parameters(),
                                                   lr=0.0))
    idx = torch.arange(6, device=dev) + 3 * rank
    emb(idx).sum().backward()
    opt.synchronize()
    want = np.zeros((50, 4))
    for q in range(k):
        want[3 * q:3 * q + 6] += 1.0 / k
    got = emb.weight.grad.to_dense().cpu().numpy()
    err = float(np.max(np.abs(got - want)))
    if err > 1e-6:
        raise AssertionError(f"sparse: off by {err}")
    return {"max_abs_err": err, "collectives": opt.collectives_per_step}


def _check_c5(hvd, dev, rank) -> dict:
    torch.manual_seed(rank)
    model = torch.nn.Linear(3, 2, device=dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    if rank == 0:
        model(torch.randn(4, 3, device=dev)).sum().backward()
        opt.step()
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    bufs = [opt.state[p]["momentum_buffer"] for p in model.parameters()]
    if any(b.device != dev for b in bufs):
        raise AssertionError("C5: a momentum buffer left the device")
    seen = hvd.allgather_object([b.cpu().numpy().tobytes() for b in bufs])
    if any(s != seen[0] for s in seen):
        raise AssertionError("C5: the ranks hold different momentum")
    return {"entries": len(opt.state)}


def _check_join(hvd, dev, k, rank) -> dict:
    local = 2 + rank
    n = hvd.join_steps(local)
    counts = [hvd.allreduce(torch.ones(1, device=dev) * (s < local),
                            op=hvd.Sum).item() for s in range(n)]
    want = [float(sum(s < 2 + q for q in range(k))) for s in range(n)]
    last = hvd.join()
    if n != k + 1 or counts != want or last != k - 1:
        raise AssertionError(f"join: {n} steps, counts {counts} (want "
                             f"{want}), join() gave {last}")
    return {"steps": n, "join": last}


def _check_tuner(hvd, dev, rank) -> dict:
    from horovod_tpu_torch.core import autotune, topology
    from horovod_tpu_torch.ops import fusion
    cfg = topology.config()
    cfg.bucket_autotune, cfg.bucket_autotune_interval = True, 1
    bt = autotune.OnlineBucketTuner(cfg)
    before = cfg.fusion_threshold_bytes
    if rank == 0:  # 1 MiB buckets move twice the bytes a second
        for _ in range(autotune.OnlineBucketTuner._MIN_SAMPLES):
            bt.record_bucket(1 << 20, 0.5e-3)
            bt.record_bucket(1 << 22, 4e-3)
    changed = bt.update()
    ps = [torch.nn.Parameter(torch.zeros(1 << 18, device=dev))
          for _ in range(6)]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=0.0))
    seen = hvd.allgather_object((cfg.fusion_threshold_bytes,
                                 fusion.plan_signature(opt.plan)))
    if not changed or len(set(seen)) != 1 or seen[0][0] != 2 << 20:
        raise AssertionError(f"tuner: changed {changed}, every rank's "
                             f"(threshold, plan) {seen}")
    cfg.fusion_threshold_bytes = before
    return {"threshold": seen[0][0], "plan": seen[0][1]}


def worker(device=None) -> dict:
    """One rank: join the world, run every check, leave. Raises on a
    disagreement; returns what it measured."""
    import horovod_tpu_torch as hvd
    hvd.init(device=device)
    try:
        dev = hvd.device()
        k, rank = hvd.size(), hvd.rank()
        return {"size": k, "device": (torch.cuda.get_device_name(dev)
                                      if dev.type == "cuda" else "cpu"),
                "ops": _check_ops(hvd, dev, k, rank),
                "sparse": _check_sparse(hvd, dev, k, rank),
                "c5": _check_c5(hvd, dev, rank),
                "join": _check_join(hvd, dev, k, rank),
                "tuner": _check_tuner(hvd, dev, rank)}
    finally:
        hvd.shutdown()
