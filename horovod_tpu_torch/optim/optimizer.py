"""DistributedOptimizer: Horovod's torch optimizer wrapper (the API of
horovod_tpu/frontends/torch.py DistributedOptimizer, the reduction of
horovod_tpu/optim/optimizer.py DistributedOptimizer).

Two ways to reduce, as in the reference:
- the hook path (the default; `groups` None and op not Adasum): the
  parameters are planned into buckets with `plan_buckets(reverse=True)`
  at min(HOROVOD_FUSION_THRESHOLD, HOROVOD_BUCKET_CAP), on the wire
  dtype of the compression. A post-accumulate-grad hook on each
  parameter counts the gradients each bucket still waits for; when the
  last one arrives the bucket is packed and its collective starts, so
  buckets go out in backward-production order while the backward pass
  runs. `step()` waits on every bucket and copies the results back into
  each `.grad`. Min, Max and Product are elementwise and ride the
  buckets too;
- the step-time path (`groups` given, or op Adasum): at `step()`, one
  `grouped_allreduce` for each group of `_group_plan`. Adasum's dot
  products are per tensor, so it reduces tensor by tensor and never over
  a packed bucket (the reference keeps Adasum off its bucket pipeline).

Both reduce with the reference's `_scale_factors`: a
gradient_predivide_factor f (Average only) sums g / f and scales the sum
by f / k. A gradient that arrives sparse (`nn.Embedding(sparse=True)`)
is reduced at `step()` by `ops/collectives.py sparse_allreduce`, or
densified first under `sparse_as_dense`. On the hook path the plan is
made before any gradient exists: a parameter whose gradient arrives
sparse rides its bucket as zeros for that one step, then leaves the plan
(every rank sees the same sparse gradients, so every rank re-plans
alike at the same step).

backward_passes_per_step N follows the torch API: the passes pile up in
`.grad` as a sum (do not zero them between passes), `step()` returns
None and applies nothing on the first N - 1 calls, and the Nth reduces
the sum, with no division by N (the optax wrapper of the JAX package
divides by N instead). The hooks launch no bucket before the Nth pass.

The online tuners (core/autotune.py) are fed here, as in the reference:
while the ParameterManager is live, each step's reduction is timed from
its first bucket's launch to the completion of the last (a device sync),
and while the OnlineBucketTuner is live each bucket is timed
(`collectives.BucketTimer`). When a decision moves the fusion threshold
the buckets are re-planned at the step boundary, never while buckets are
in flight; rank 0 decides and every rank applies, so every rank packs
the same buckets. The tuners coordinate over the global set: an
optimizer over a smaller process set does not feed them. Once they are
frozen, a step does not sync.

perfscope (profiler/perfscope.py) is fed as in the reference: each
`step()` that applies gradients closes one implicit training step (step
N runs from the end of call N-1 to the end of call N; under
backward_passes_per_step the step stays open across the accumulation
passes), `synchronize()` is the `comms` phase and the wrapped
optimizer's step the `optimizer` phase. Each bucket's launch is a
`bucketed_allreduce/b<i>` ALLREDUCE span on the timeline and `comms`
time; on a card the hooks run on autograd's device thread, and that
time is taken out of the phase the training thread is in. The bytes a
step reduces go to `set_comms_axes`, under "hvd" (the JAX package's
global axis) or the process set's id.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.common import types as T
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.core.process_sets import ProcessSet, global_process_set
from horovod_tpu_torch.ops import collectives, fusion
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.profiler import perfscope


def scale_factors(op: T.ReduceOp, k: int, gradient_predivide_factor: float
                  ) -> Tuple[float, float, T.ReduceOp]:
    """(prescale, postscale, op) of a reduction over k ranks: a predivide
    factor f turns Average into a Sum of g / f scaled by f / k."""
    if gradient_predivide_factor != 1.0:
        if op != T.ReduceOp.AVERAGE:
            raise ValueError("gradient_predivide_factor requires op=Average")
        return (1.0 / gradient_predivide_factor,
                gradient_predivide_factor / k, T.ReduceOp.SUM)
    return 1.0, 1.0, op


def group_plan(groups, dense: List[torch.Tensor]
               ) -> List[List[torch.Tensor]]:
    """The step-time path's groups of `dense` parameters, each one
    grouped_allreduce: an int N splits them into N contiguous groups, a
    list of lists pins which tensors reduce together (the rest form one
    last group)."""
    if groups is None or not dense:
        return [dense] if dense else []
    if isinstance(groups, int):
        if groups == 0:
            return [dense]
        n = min(groups, len(dense))
        bounds = np.linspace(0, len(dense), n + 1, dtype=int)
        return [dense[bounds[i]:bounds[i + 1]] for i in range(n)
                if bounds[i] < bounds[i + 1]]
    gid = {}
    for i, grp in enumerate(groups):
        for p in grp:
            gid[id(p)] = i
    plans: Dict[int, list] = {}
    rest = []
    for p in dense:
        g = gid.get(id(p))
        if g is None:
            rest.append(p)
        else:
            plans.setdefault(g, []).append(p)
    out = [plans[g] for g in sorted(plans)]
    if rest:
        out.append(rest)
    return out


class DistributedOptimizer:
    """Wraps a torch.optim.Optimizer so that `step()` applies gradients
    reduced over the members of `process_set` (default every rank)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op: T.ReduceOp = T.Average,
                 gradient_predivide_factor: float = 1.0,
                 sparse_as_dense: bool = False, groups=None,
                 process_set: Optional[ProcessSet] = None):
        self.opt = optimizer
        self.op = T.normalize_reduce_op(op)
        if gradient_predivide_factor != 1.0 and self.op != T.Average:
            raise ValueError("gradient_predivide_factor requires op=Average")
        if int(backward_passes_per_step) < 1:
            raise ValueError("backward_passes_per_step must be at least 1")
        if groups is not None:
            if isinstance(groups, int):
                if groups < 0:
                    raise ValueError("groups must be a non-negative integer "
                                     "or a list of lists of tensors")
            elif not all(isinstance(g, (list, tuple)) for g in groups):
                raise ValueError("groups must be a non-negative integer or "
                                 "a list of lists of tensors")
        self.compression = compression
        self.backward_passes_per_step = int(backward_passes_per_step)
        self.gradient_predivide_factor = float(gradient_predivide_factor)
        self.sparse_as_dense = bool(sparse_as_dense)
        self.groups = groups
        self.process_set = process_set if process_set is not None \
            else global_process_set
        params = [p for g in optimizer.param_groups for p in g["params"]
                  if p.requires_grad]
        if named_parameters is not None:
            order = [p for _, p in named_parameters if p.requires_grad]
            if {id(p) for p in order} != {id(p) for p in params}:
                raise ValueError("named_parameters must cover exactly the "
                                 "optimizer's trainable parameters")
            params = order
        self.params: List[torch.Tensor] = params
        self._index = {id(p): i for i, p in enumerate(params)}
        self._count = 0  # step() calls
        self._synchronized = False
        self._sparse: set = set()  # indices whose gradients arrive sparse
        self._group_buckets: dict = {}
        # Collective calls of the last reduction: one per bucket, one per
        # tensor for Adasum, two allgathers per sparse gradient.
        self.collectives_per_step = 0
        self.hooked = groups is None and self.op != T.ReduceOp.ADASUM
        self.plan: List[fusion.Bucket] = []
        self._members: List[List[int]] = []
        self._reset()
        if self.hooked:
            self._replan()
            self._hooks = [p.register_post_accumulate_grad_hook(self._hook)
                           for p in params]

    def __getattr__(self, name):  # param_groups, state, ...
        return getattr(self.opt, name)

    # ------------------------------------------------------------ plans

    @staticmethod
    def _threshold() -> int:
        cfg = topology.config()
        return fusion.effective_threshold(cfg.fusion_threshold_bytes,
                                          cfg.bucket_cap_bytes)

    def _dense_plan(self, threshold: int):
        """The dense parameters' indices and their bucket plan (indices
        into that list) at an effective threshold."""
        dense = [i for i in range(len(self.params)) if i not in self._sparse]
        return dense, fusion.plan_buckets(
            [(tuple(self.params[i].shape),
              self.compression.wire_dtype(self.params[i].dtype))
             for i in dense], threshold, reverse=True)

    def _replan(self) -> None:
        """Plan the dense parameters into buckets at the threshold in
        force (between steps only)."""
        self.plan_threshold = self._threshold()
        dense, plan = self._dense_plan(self.plan_threshold)
        self.plan = [fusion.Bucket(b.dtype, b.itemsize, tuple(
            fusion.BucketItem(dense[it.index], it.start, it.size)
            for it in b.items)) for b in plan]
        self._members = [sorted({it.index for it in b.items})
                         for b in self.plan]
        self.plan_bytes = sum(it.size * b.itemsize for b in self.plan
                              for it in b.items)
        self._buckets_of: List[List[int]] = [[] for _ in self.params]
        for bi, members in enumerate(self._members):
            for i in members:
                self._buckets_of[i].append(bi)
        self._reset()

    def buckets_at(self, threshold_bytes: int) -> int:
        """How many buckets the hook path plans at a threshold."""
        cap = topology.config().bucket_cap_bytes
        return len(self._dense_plan(
            fusion.effective_threshold(threshold_bytes, cap))[1])

    def _reset(self) -> None:
        self._pending = [len(m) for m in self._members]
        self._inflight: dict = {}  # bucket index -> (Handle, ctx)
        self._start = None  # the step's collective launcher
        self._timer: Optional[collectives.BucketTimer] = None
        self._t_first = 0.0

    # ------------------------------------------------------ tuner state

    def _tuners(self):
        """(ParameterManager, OnlineBucketTuner), each None unless live
        for this optimizer."""
        if self.process_set.ranks is not None:
            return None, None
        pm, bt = topology.parameter_manager(), topology.bucket_tuner()
        return (pm if pm is not None and not pm.frozen else None,
                bt if bt is not None and not bt.frozen else None)

    def _begin(self) -> None:
        """At a step's first launch: the launcher of the step's
        collectives (it reads the hierarchical knob now), and the timers
        while a tuner is live."""
        ps = collectives._resolve(self.process_set)
        pre, post, rop = scale_factors(self.op, ps.size(),
                                       self.gradient_predivide_factor)
        self._start = collectives._launch(rop, pre, post, ps)
        pm, bt = self._tuners()
        if pm is not None:
            self._t_first = time.perf_counter()
        if bt is not None and self.hooked:
            self._timer = collectives.BucketTimer(topology.device())

    def _tune(self, nbytes: int) -> None:
        """Feed the live tuners at the end of a reduction, then re-plan
        if a decision moved the threshold."""
        pm, bt = self._tuners()
        if bt is not None and self.hooked:  # it tunes the bucket path
            for nb, sec in self._timer.results():
                bt.record_bucket(nb, sec)
            bt.update()
        if pm is not None:
            if topology.device().type == "cuda":
                torch.cuda.synchronize()
            pm.record(nbytes, time.perf_counter() - self._t_first)
            pm.update()
        if self.hooked and self._threshold() != self.plan_threshold:
            self._replan()

    # -------------------------------------------------------- hook path

    def _hook(self, p: torch.Tensor) -> None:
        if (self._count + 1) % self.backward_passes_per_step:
            return  # an accumulation pass: the sum piles up in .grad
        self._synchronized = False
        i = self._index[id(p)]
        if self.sparse_as_dense and p.grad is not None and p.grad.is_sparse:
            p.grad = p.grad.to_dense()
        for bi in self._buckets_of[i]:
            self._pending[bi] -= 1
            if self._pending[bi] == 0:
                self._launch(bi)

    def _dense_grad(self, i: int) -> torch.Tensor:
        g = self.params[i].grad
        # A gradient that arrived sparse rides as zeros this once.
        return torch.zeros_like(self.params[i]) if g.is_sparse else g

    def _launch(self, bi: int) -> None:
        with collectives.instrument(f"bucketed_allreduce/b{bi}",
                                    "ALLREDUCE"):
            if self._start is None:
                self._begin()
            flat = fusion.pack(self.plan[bi], {i: self._dense_grad(i)
                                               for i in self._members[bi]})
            wire, ctx = self.compression.compress(flat)
            start = self._start
            if self._timer is not None:
                h = self._timer.launch(wire.numel() * wire.element_size(),
                                       lambda: start(wire))
            else:
                h = start(wire)
        self._inflight[bi] = (h, ctx)

    def _prepare_grads(self) -> List[int]:
        """Zero gradients for parameters the loss did not reach (autodiff
        gives them zeros in the JAX package), densify or list the sparse
        ones, make the dense ones contiguous; returns the sparse
        indices."""
        sparse = []
        for i, p in enumerate(self.params):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif p.grad.is_sparse:
                if self.sparse_as_dense:
                    p.grad = p.grad.to_dense()
                else:
                    sparse.append(i)
            elif not p.grad.is_contiguous():  # e.g. channels_last grads
                p.grad = p.grad.contiguous()
        return sparse

    def _reduce_sparse(self, sparse: List[int]) -> None:
        ps = collectives._resolve(self.process_set)
        pre, post, rop = scale_factors(self.op, ps.size(),
                                       self.gradient_predivide_factor)
        for i in sparse:
            p = self.params[i]
            p.grad = collectives.sparse_allreduce(p.grad, rop, ps, pre, post)

    def _synchronize_hooked(self) -> int:
        sparse = self._prepare_grads()
        if self._start is None:
            self._begin()
        for bi in range(len(self.plan)):
            if bi not in self._inflight:
                self._launch(bi)
        outs = {i: (self.params[i].grad.view(-1) if i not in sparse
                    else self.params[i].new_empty(self.params[i].numel()))
                for members in self._members for i in members}
        for bi, b in enumerate(self.plan):
            h, ctx = self._inflight[bi]
            fusion.unpack(b, self.compression.decompress(h.wait(), ctx),
                          outs)
        self._reduce_sparse(sparse)
        self.collectives_per_step = len(self.plan) + 2 * len(sparse)
        nbytes = self.plan_bytes  # the plan may change below
        self._tune(nbytes)
        new = set(sparse) - self._sparse
        if new:  # every rank sees the same sparse gradients
            self._sparse |= new
            self._replan()
        self._reset()
        return nbytes

    # --------------------------------------------------- step-time path

    def _calls(self, plan: List[torch.Tensor], tensors) -> int:
        """Collective calls of one grouped_allreduce of `tensors`."""
        if self.op == T.ReduceOp.ADASUM:
            return len(tensors)
        key = (self._threshold(), tuple(id(p) for p in plan))
        if key not in self._group_buckets:
            self._group_buckets[key] = len(fusion.plan_buckets(
                [(tuple(t.shape), t.dtype) for t in tensors],
                self._threshold()))
        return self._group_buckets[key]

    def _synchronize_at_step(self) -> int:
        sparse = self._prepare_grads()
        self._begin()
        ps = collectives._resolve(self.process_set)
        pre, post, rop = scale_factors(self.op, ps.size(),
                                       self.gradient_predivide_factor)
        dense = [p for i, p in enumerate(self.params) if i not in sparse]
        calls, nbytes, pending = 2 * len(sparse), 0, []
        for plan in group_plan(self.groups, dense):
            pairs = [self.compression.compress(p.grad) for p in plan]
            wires = [w for w, _ in pairs]
            nbytes += sum(w.numel() * w.element_size() for w in wires)
            calls += self._calls(plan, wires)
            pending.append((plan, pairs, collectives.grouped_allreduce_async(
                wires, op=rop, prescale_factor=pre, postscale_factor=post,
                process_set=ps)))
        for plan, pairs, h in pending:
            for p, r, (_, ctx) in zip(plan, h.wait(), pairs):
                p.grad.copy_(self.compression.decompress(r, ctx))
        self._reduce_sparse(sparse)
        self.collectives_per_step = calls
        self._tune(nbytes)
        self._reset()
        return nbytes

    # ------------------------------------------------------------- API

    def synchronize(self) -> None:
        """Wait for every bucket (launching any whose gradients did not
        all arrive) and install the reduced gradients; on the step-time
        path, reduce them now (perfscope's `comms` phase)."""
        scope = perfscope.get()
        with scope.phase("comms"):
            nbytes = self._synchronize_hooked() if self.hooked \
                else self._synchronize_at_step()
        axis = "hvd" if self.process_set.ranks is None \
            else f"process_set_{self.process_set.process_set_id}"
        scope.set_comms_axes({axis: nbytes})
        self._synchronized = True

    def step(self, closure=None):
        """Reduce and apply; None without applying anything on the first
        backward_passes_per_step - 1 calls of each cycle."""
        scope = perfscope.get()
        scope.step_entry()
        self._count += 1
        if self._count % self.backward_passes_per_step:
            return None  # an accumulation pass: the step stays open
        try:
            if not self._synchronized:
                self.synchronize()
            self._synchronized = False
            with scope.phase("optimizer"):
                return self.opt.step(closure)
        finally:
            scope.step_boundary()

    def zero_grad(self, set_to_none: bool = True):
        return self.opt.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self.opt.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.opt.load_state_dict(state_dict)
