"""DistributedOptimizer: bucketed gradient all-reduce launched during
backward (counterpart of horovod_tpu/optim/optimizer.py
reduce_gradients_in_jit, with the API of the JAX package's torch
frontend, horovod_tpu/frontends/torch.py DistributedOptimizer).

The parameters are planned into buckets once, with
`plan_buckets(reverse=True)` at min(HOROVOD_FUSION_THRESHOLD,
HOROVOD_BUCKET_CAP), on the wire dtype of the compression. A
post-accumulate-grad hook on each parameter counts the gradients each
bucket still waits for; when the last one arrives the bucket is packed
and its all-reduce starts (`async_op=True`), so buckets go out in
backward-production order while the backward pass runs. `step()` waits
on every bucket, divides by size() for Average in the wire dtype, copies
the result back into each `.grad` and steps the wrapped optimizer.

Only backward_passes_per_step=1 and the ops Average and Sum are ported:
any other op (Adasum, Min, Max, Product) raises naming ROADMAP A6 rather
than summing.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import types as T
from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.ops import collectives, fusion
from horovod_tpu_torch.ops.compression import Compression


class DistributedOptimizer:
    """Wraps a torch.optim.Optimizer so that `step()` applies gradients
    averaged (or summed) over every rank."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, compression=Compression.none,
                 op: T.ReduceOp = T.Average,
                 backward_passes_per_step: int = 1):
        if backward_passes_per_step != 1:
            raise NotImplementedError(
                "backward_passes_per_step > 1 is not ported yet")
        self.op = T.normalize_reduce_op(op)
        if self.op not in (T.Average, T.Sum):
            raise HorovodError(
                f"DistributedOptimizer(op={self.op.name}): only Average and "
                f"Sum are ported; the optimizer's other ops come with "
                f"ROADMAP A6")
        self.opt = optimizer
        self.compression = compression
        params = [p for g in optimizer.param_groups for p in g["params"]
                  if p.requires_grad]
        if named_parameters is not None:
            order = [p for _, p in named_parameters if p.requires_grad]
            if {id(p) for p in order} != {id(p) for p in params}:
                raise ValueError("named_parameters must cover exactly the "
                                 "optimizer's trainable parameters")
            params = order
        self.params: List[torch.Tensor] = params
        cfg = topology.config()
        self.plan = fusion.plan_buckets(
            [(tuple(p.shape), compression.wire_dtype(p.dtype))
             for p in params],
            fusion.effective_threshold(cfg.fusion_threshold_bytes,
                                       cfg.bucket_cap_bytes),
            reverse=True)
        self._buckets_of: List[List[int]] = [[] for _ in params]
        for bi, b in enumerate(self.plan):
            for idx in sorted({it.index for it in b.items}):
                self._buckets_of[idx].append(bi)
        self._index = {id(p): i for i, p in enumerate(params)}
        self._reset()
        self._hooks = [p.register_post_accumulate_grad_hook(self._hook)
                       for p in params]

    def __getattr__(self, name):  # param_groups, state_dict, ...
        return getattr(self.opt, name)

    def _reset(self) -> None:
        self._pending = [len({it.index for it in b.items})
                         for b in self.plan]
        self._inflight = {}  # bucket index -> (work, wire flat, ctx)

    def _hook(self, p: torch.Tensor) -> None:
        for bi in self._buckets_of[self._index[id(p)]]:
            self._pending[bi] -= 1
            if self._pending[bi] == 0:
                self._launch(bi)

    def _launch(self, bi: int) -> None:
        flat = fusion.pack(self.plan[bi], [p.grad for p in self.params])
        wire, ctx = self.compression.compress(flat)
        work = dist.all_reduce(wire, op=dist.ReduceOp.SUM, async_op=True)
        self._inflight[bi] = (work, wire, ctx)

    def synchronize(self) -> None:
        """Launch any bucket whose gradients did not all arrive (a
        parameter the loss does not reach gets a zero gradient, as
        autodiff gives it in the JAX package), wait for every bucket and
        install the reduced gradients."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif not p.grad.is_contiguous():  # e.g. channels_last conv grads
                p.grad = p.grad.contiguous()
        for bi in range(len(self.plan)):
            if bi not in self._inflight:
                self._launch(bi)
        k = topology.size()
        flat_grads = [p.grad.view(-1) for p in self.params]
        for bi, b in enumerate(self.plan):
            work, wire, ctx = self._inflight[bi]
            work.wait()
            if self.op == T.Average and k != 1:
                wire = collectives.average(wire, k)
            fusion.unpack(b, self.compression.decompress(wire, ctx),
                          flat_grads)
        self._reset()

    def step(self, closure=None):
        self.synchronize()
        return self.opt.step(closure)

    def zero_grad(self, set_to_none: bool = True):
        return self.opt.zero_grad(set_to_none=set_to_none)
