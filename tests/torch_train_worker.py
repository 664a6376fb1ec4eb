"""Worker for tests/test_torch_train.py: one rank of a gloo world that
trains the PyTorch package's mini ResNet and runs its eager collectives.

Imports torch and horovod_tpu_torch only. Started with the `spawn`
method; everything it needs arrives as arguments, and it writes its
results to `out_path` as an .npz file.
"""

import os

import numpy as np


def run(rank: int, size: int, store: str, state: dict, x: np.ndarray,
        y: np.ndarray, steps: int, out_path: str) -> None:
    os.environ.update({"HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(size),
                       "HOROVOD_LOCAL_RANK": str(rank),
                       "HOROVOD_LOCAL_SIZE": str(size),
                       "HOROVOD_CONV_BLOCK": "1",
                       "HOROVOD_FUSION_THRESHOLD": str(64 * 1024)})
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet

    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    out = {}
    try:
        resnet.STAGE_BLOCKS[8] = (1, 1)
        # Every rank starts from different weights; broadcast makes them
        # rank 0's (the JAX weights).
        model = resnet.ResNet(depth=8, num_classes=10, seed=100 + rank)
        if rank == 0:
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in state.items()})
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01 * size,
                            momentum=0.9),
            named_parameters=model.named_parameters())
        out["n_buckets"] = np.asarray(len(opt.plan))
        n = x.shape[0] // size  # contiguous shards, as P("hvd") cuts
        xs = torch.from_numpy(x[rank * n:(rank + 1) * n].copy())
        ys = torch.from_numpy(y[rank * n:(rank + 1) * n].copy())
        for _ in range(steps):
            opt.zero_grad()
            loss, ns = resnet.loss_fn(model, (xs, ys), group=dist.group.WORLD)
            loss.backward()
            opt.step()
            model.set_stats(ns)
        for k, v in model.state_dict().items():
            out[f"state/{k}"] = v.numpy()

        # broadcast_optimizer_state: rank 1's momentum and lr are
        # overwritten by rank 0's.
        sgd = opt.opt
        fc_w = model.fc.w
        if rank == 1:
            sgd.state[fc_w]["momentum_buffer"].mul_(3.0)
            sgd.param_groups[0]["lr"] = 0.5
        hvd.broadcast_optimizer_state(sgd, root_rank=0)
        out["opt/fc_momentum"] = sgd.state[fc_w]["momentum_buffer"].numpy()
        out["opt/lr"] = np.asarray(sgd.param_groups[0]["lr"])

        # Eager collectives on rank-dependent inputs.
        rng = np.random.default_rng(rank)
        a = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
        group = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                 for n in (7, 300000, 4)]
        out["in/a"] = a.numpy()
        for i, t in enumerate(group):
            out[f"in/g{i}"] = t.numpy()
        out["allreduce_avg"] = hvd.allreduce(a).numpy()
        out["allreduce_sum"] = hvd.allreduce(a, op=hvd.Sum).numpy()
        h = hvd.allreduce_async(a, op=hvd.Sum)
        out["async_sum"] = hvd.synchronize(h).numpy()
        out["polled"] = np.asarray(hvd.poll(h))
        for i, t in enumerate(hvd.grouped_allreduce(group)):
            out[f"grouped/{i}"] = t.numpy()
        for i, t in enumerate(hvd.bucketed_allreduce(group, op=hvd.Sum)):
            out[f"bucketed/{i}"] = t.numpy()
        out["broadcast"] = hvd.broadcast(a, root_rank=1).numpy()
        hvd.barrier()
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)
