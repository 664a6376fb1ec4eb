"""Hybrid-parallel tied-LM training over HOROVOD_MESH, PyTorch twin of
examples/hybrid_lm.py (and the model of bench.py's gspmd_hybrid
section).

The tied-embedding LM (models/tied_lm.py) trained model-sharded through
`hvd.DistributedOptimizer(sharding_spec=...)` on the named-axis mesh
that HOROVOD_MESH declares: each rank holds its shards of the
vocab-sharded embedding and the column/row-parallel FFN, the batch
shards over dp, and the sharded step reduces each gradient over the
axes its leaf is replicated on. Without HOROVOD_MESH the same model and
step run pure data-parallel (dp = every rank). Run it on four GPUs:

    HOROVOD_MESH="dp=2,tp=2" python -m horovod_tpu_torch.runner.launch \\
        -np 4 python -m horovod_tpu_torch.hybrid_lm

--device cpu trains on the host with gloo.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import tied_lm
from horovod_tpu_torch.parallel.mesh import (MeshSpec, build_mesh, shard_of,
                                             use_mesh)


def train(cfg: tied_lm.TiedLMConfig, mesh, params: Dict[str, torch.Tensor],
          data: Tuple[torch.Tensor, torch.Tensor], steps: int, lr: float,
          optimizer: str = "adam", every: int = 0, warmup: int = 0
          ) -> Tuple[List[float], float]:
    """`steps` sharded steps from the global `params` on the global batch
    `data` (tokens, targets): this rank's shards under param_specs on
    `mesh`, Adam (or SGD) at `lr`. Returns the losses (the mean over the
    batch of each step) and the wall seconds a step after the first
    `warmup` (the device synchronised at both ends); with `every` > 0
    rank 0 prints every that many steps."""
    specs = tied_lm.param_specs(cfg)
    with use_mesh(mesh):
        shards = {n: shard_of(v, specs[n]).requires_grad_()
                  for n, v in params.items()}
        batch = tuple(shard_of(a, ("dp",)) for a in data)
    inner = (torch.optim.Adam if optimizer == "adam" else torch.optim.SGD)(
        list(shards.values()), lr=lr)
    opt = hvd.DistributedOptimizer(inner, named_parameters=list(
        shards.items()), sharding_spec=specs, mesh=mesh)
    step = opt.sharded_step(
        lambda p, b: tied_lm.local_loss(p, b[0], b[1], cfg))
    losses, t0 = [], time.perf_counter()
    for i in range(steps):
        if i == warmup:
            _sync(batch[0])
            t0 = time.perf_counter()
        losses.append(step(batch))
        if every and hvd.rank() == 0 and (i % every == 0 or
                                          i == steps - 1):
            print(f"step {i:4d}  loss {float(losses[-1]):.4f}", flush=True)
    _sync(batch[0])
    step_s = (time.perf_counter() - t0) / max(steps - warmup, 1)
    return [float(v) for v in losses], step_s


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None, choices=["cpu"],
                    help="cpu: train on the host with gloo")
    args = ap.parse_args(argv)

    hvd.init(device=args.device)
    try:
        mesh = hvd.hybrid_mesh()
        if mesh is None:  # no HOROVOD_MESH: the pure-DP twin
            mesh = build_mesh(MeshSpec.infer(hvd.size()))
        dev = hvd.device()
        cfg = tied_lm.canonical_config()
        params = tied_lm.init(0, cfg, dev)
        data = tied_lm.sample_batch(1, cfg, batch=args.batch, seq=args.seq,
                                    device=dev)
        _, step_s = train(cfg, mesh, params, data, args.steps, args.lr,
                          every=5)
        if hvd.rank() == 0:
            print(f"mesh {mesh.spec.describe()} on {mesh.spec.total} "
                  f"ranks: {1 / step_s:.2f} steps/s, "
                  f"{args.batch * args.seq / step_s:.0f} tokens/s")
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
