"""DistributedOptimizer: Horovod's torch optimizer wrapper (the API of
horovod_tpu/frontends/torch.py DistributedOptimizer, the reduction of
horovod_tpu/optim/optimizer.py DistributedOptimizer).

Two ways to reduce, as in the reference:
- the hook path (the default; `groups` None and op not Adasum): the
  parameters are planned into buckets with `plan_buckets(reverse=True)`
  at min(HOROVOD_FUSION_THRESHOLD, HOROVOD_BUCKET_CAP), each on the
  dtype it travels in: the compression is decided for each gradient on
  its own (a thresholded compressor tests each tensor's bytes, as the
  reference compresses every leaf before bucketing), so compressed and
  uncompressed gradients fill separate buckets of one dtype each. A
  post-accumulate-grad hook on each parameter counts the gradients each
  bucket still waits for; when the last one arrives its members are
  compressed, packed, and the bucket's collective starts, so buckets go
  out in backward-production order while the backward pass runs.
  `step()` waits on every bucket, decompresses each gradient and copies
  it back into its `.grad`. Min, Max and Product are elementwise and
  ride the buckets too;
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

The sharded step (`sharding_spec` given, with the mesh: the port of the
JAX package's `sharded_step` / `build_sharded_train_step`): each
parameter is this rank's shard of a global leaf under a partition spec
over the HOROVOD_MESH mesh, and no hook is registered. After the
backward pass, `step()` divides every gradient by the tp size (the
loss is computed redundantly on every tp member, REDUNDANT_LOSS_AXES),
then reduces each gradient over the live axes its spec leaves out
(`grad_axes_from_specs`): one grouped all-reduce for each distinct
axis set, over the process set of those axes, averaged over the batch
axes among them and summed over the model axes (op Average), or summed
(op Sum, for a loss already divided by the global token count, as the
LM's local_loss is). Reducing after the backward pass, never from
hooks, keeps every rank's collectives in one order while a pipeline's
ring shifts run inside the backward pass.

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

The hook path passes the collectives' dispatch choke point
(`collectives.dispatch`) once a step, at its first launch, with the
descriptor the JAX package's one `bucketed_allreduce` call of the step
gives (the dense gradients' shapes, the threshold and the plan's
signature): one flight record, one consistency round and one verifier
record a step, however many buckets it has. Each bucket is one
collective call in the metrics (its bytes the set's size times the
bucket's), one tracing span, and one wait under the stall watchdog.
While a tuner times the buckets, their overlap feeds
`horovod_overlap_fraction` and `bucket_overlap_stats`.
"""

from __future__ import annotations

import functools
import math
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.common import types as T
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.core.process_sets import ProcessSet, global_process_set
from horovod_tpu_torch.ops import collectives, fusion
from horovod_tpu_torch.ops.compression import Compression, wire_dtype
from horovod_tpu_torch.parallel import mesh as mesh_mod
from horovod_tpu_torch.profiler import perfscope

#: Mesh axes over which the shard-local losses compute the loss
#: redundantly (every member holds the same scalar, each copy
#: differentiated on its rank): per-rank autograd scales every gradient
#: by the axis size, and the sharded step divides it back out
#: (models/transformer.py local_loss, models/tied_lm.py local_loss).
REDUNDANT_LOSS_AXES: Tuple[str, ...] = ("tp",)

def _spec_axis_names(spec) -> set:
    """The mesh axes a partition spec mentions (entries are None, a
    name, or a tuple of names)."""
    names: set = set()
    for entry in spec or ():
        if isinstance(entry, (tuple, list)):
            names.update(e for e in entry if e)
        elif entry is not None:
            names.add(entry)
    return names


def _tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts (specs are tuples: leaves)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def grad_axes_from_specs(param_specs: Any, mesh) -> Any:
    """Per leaf, the live axes (size > 1) its spec does not mention, in
    mesh order: the axes its gradient is reduced over. A leaf replicated
    over an axis holds a partial gradient there (a batch axis, or a
    model axis its shard is copied over); an axis it is sharded over
    contributes no sum, its shard's gradient lives on its owners alone.
    Computed from the spec tree, this is models/transformer.py
    grad_reduce_axes (the JAX function, same rule)."""
    sizes = mesh_mod.mesh_axis_sizes(mesh)
    live = tuple(a for a in mesh.axis_names if sizes[a] > 1)
    return _tree_map(lambda spec: tuple(
        a for a in live if a not in _spec_axis_names(spec)), param_specs)


def opt_state_specs(opt_state: Any, params: Any, param_specs: Any) -> Any:
    """Per-leaf specs of an optimizer state held by parameter name
    ({name: {"exp_avg": t, "step": t, ...}}, as `named_state` gives it):
    a state leaf of its parameter's shape takes the parameter's spec
    (Adam's moments, SGD's momentum), anything else (the step count) is
    replicated. The JAX function matches state leaves to parameters by
    (shape, dtype); a torch optimizer keys its state by parameter, so
    no match is ambiguous."""
    def leaf(x, name):
        return param_specs[name] if tuple(getattr(x, "shape", ())) == \
            tuple(params[name].shape) else ()
    return {name: {k: leaf(v, name) for k, v in st.items()}
            for name, st in opt_state.items()}


def named_state(opt, named_parameters) -> Dict[str, Dict[str, Any]]:
    """The torch optimizer's per-parameter state by parameter name (the
    tree a sharded checkpoint saves)."""
    return {n: dict(opt.state[p]) for n, p in named_parameters
            if p in opt.state}


def load_named_state(opt, named_parameters, state) -> None:
    """Install `named_state`'s tree (host tensors) into the optimizer,
    each tensor onto its parameter's device."""
    for n, p in named_parameters:
        if n in state:
            opt.state[p] = {k: (v.to(p.device) if torch.is_tensor(v) and
                                v.dim() else v)
                            for k, v in state[n].items()}


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


def _post_accumulate_hook(ref, p: torch.Tensor) -> None:
    """A parameter's post-accumulate-grad hook. The parameter holds it in
    C++, where the garbage collector cannot follow it, so it reaches its
    optimizer through a weak reference: a strong one would keep the
    optimizer, and through it the parameters, their gradients and the
    wrapped optimizer's state, alive for as long as the process runs."""
    opt = ref()
    if opt is not None:
        opt._hook(p)


class DistributedOptimizer:
    """Wraps a torch.optim.Optimizer so that `step()` applies gradients
    reduced over the members of `process_set` (default every rank), or,
    with `sharding_spec` ({parameter name: partition spec}) on `mesh`
    (default the HOROVOD_MESH mesh), over the axes each parameter's
    shard is replicated on (the sharded step, module docstring)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op: T.ReduceOp = T.Average,
                 gradient_predivide_factor: float = 1.0,
                 sparse_as_dense: bool = False, groups=None,
                 process_set: Optional[ProcessSet] = None,
                 sharding_spec: Optional[Dict[str, tuple]] = None,
                 mesh=None):
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
            named_parameters = list(named_parameters)  # may be a generator
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
        self.sharding_spec = sharding_spec
        self.hooked = groups is None and self.op != T.ReduceOp.ADASUM \
            and sharding_spec is None
        if sharding_spec is not None:
            self._init_sharded(named_parameters, mesh)
        self.plan: List[fusion.Bucket] = []
        self._members: List[List[int]] = []
        self._reset()
        if self.hooked:
            self._replan()
            hook = functools.partial(_post_accumulate_hook, weakref.ref(self))
            self._hooks = [p.register_post_accumulate_grad_hook(hook)
                           for p in params]

    def __getattr__(self, name):  # param_groups, state, ...
        return getattr(self.opt, name)

    def __del__(self):
        # Parameters that outlive this optimizer drop its hooks.
        for h in self.__dict__.get("_hooks", ()):
            h.remove()

    # ------------------------------------------------------ sharded step

    def _init_sharded(self, named_parameters, mesh) -> None:
        """The sharded step's per-parameter reduce axes, and their
        process sets registered now, on every rank in one order."""
        if named_parameters is None:
            raise ValueError("sharding_spec needs named_parameters: the "
                             "spec is keyed by parameter name")
        if self.op not in (T.ReduceOp.SUM, T.ReduceOp.AVERAGE) or \
                self.groups is not None:
            raise ValueError("the sharded step reduces with Sum or Average "
                             "and takes no groups")
        m = mesh if mesh is not None else mesh_mod.current_mesh()
        if m is None:
            raise ValueError(
                "sharding_spec needs a hybrid mesh: set HOROVOD_MESH (e.g. "
                "\"dp=2,tp=4\") before hvd.init(), or pass mesh=")
        self.mesh = m
        self.names = [n for n, p in named_parameters if p.requires_grad]
        if len(self.names) != len(self.params):
            raise ValueError("named_parameters must name every parameter")
        missing = [n for n in self.names if n not in self.sharding_spec]
        if missing:
            raise ValueError(f"sharding_spec has no spec for {missing[:4]}")
        axes = grad_axes_from_specs(
            {n: self.sharding_spec[n] for n in self.names}, m)
        self._axes = [axes[n] for n in self.names]
        sizes = mesh_mod.mesh_axis_sizes(m)
        self._redundant = math.prod(sizes[a] for a in REDUNDANT_LOSS_AXES)
        self._axis_sets = {ax: mesh_mod.axes_process_set(ax, m)
                           for ax in dict.fromkeys(self._axes)}
        self._set_batch_spec(("dp",))

    def _set_batch_spec(self, batch_spec) -> None:
        """The live axes the batch shards over (`batch_spec` a partition
        spec): the axes the gradients average over."""
        sizes = mesh_mod.mesh_axis_sizes(self.mesh)
        self._mean_axes = tuple(a for a in self.mesh.axis_names
                                if a in _spec_axis_names(batch_spec)
                                and sizes[a] > 1)

    def _synchronize_sharded(self) -> Dict[str, int]:
        """/tp, then one grouped all-reduce for each distinct axis set;
        returns the bytes reduced by axis-set label."""
        self._prepare_grads()
        sizes = mesh_mod.mesh_axis_sizes(self.mesh)
        grads = [p.grad for p in self.params]
        if self._redundant != 1:
            for g in grads:
                g.div_(self._redundant)
        by_axes: Dict[tuple, List[int]] = {}
        for i, ax in enumerate(self._axes):
            by_axes.setdefault(ax, []).append(i)
        nbytes: Dict[str, int] = {}
        calls = 0
        for ax, idx in by_axes.items():
            ps = self._axis_sets[ax]
            if ps is None:
                continue  # sharded over every live axis: nothing to sum
            k = math.prod(sizes[a] for a in ax if a in self._mean_axes)
            pre, post, rop = scale_factors(self.op, k,
                                           self.gradient_predivide_factor)
            pairs = [self.compression.compress(grads[i]) for i in idx]
            wires = [w for w, _ in pairs]
            out = collectives.grouped_allreduce(
                wires, op=T.Sum, prescale_factor=pre, postscale_factor=post,
                process_set=ps)
            for i, r, (_, ctx) in zip(idx, out, pairs):
                r = self.compression.decompress(r, ctx)
                grads[i].copy_(r / k if rop == T.ReduceOp.AVERAGE and k != 1
                               else r)
            calls += self._calls([self.params[i] for i in idx], wires)
            nbytes["+".join(ax)] = sum(w.numel() * w.element_size()
                                       for w in wires)
        self.collectives_per_step = calls
        return nbytes

    def sharded_step(self, loss_fn: Callable, batch_spec=None,
                     loss_axes: Optional[Tuple[str, ...]] = None
                     ) -> Callable:
        """The sharded train step: `step(batch) -> loss`. `loss_fn(params,
        batch)` is the shard-local loss (params: {name: this rank's
        shard}; `batch` this rank's shard of the batch), run with axis
        names resolved against this optimizer's mesh: it returns the
        LOCAL batch shard's loss, not reduced over the batch axes, and
        over the model axes the same value on every member (see the
        module docstring). `batch_spec` (default ("dp",)) names the
        batch axes the gradients average over. The loss returned is
        reduced over `loss_axes` (default the batch axes): averaged
        under op Average, summed under Sum. The JAX step's contract."""
        if self.sharding_spec is None:
            raise ValueError("sharded_step requires DistributedOptimizer("
                             "sharding_spec=<{name: partition spec}>)")
        self._set_batch_spec(("dp",) if batch_spec is None else batch_spec)
        sizes = mesh_mod.mesh_axis_sizes(self.mesh)
        axes = self._mean_axes if loss_axes is None else tuple(
            a for a in self.mesh.axis_names if a in loss_axes and
            sizes[a] > 1)
        loss_set = mesh_mod.axes_process_set(axes, self.mesh)
        named = dict(zip(self.names, self.params))
        mean = self.op == T.ReduceOp.AVERAGE

        def step(batch):
            self.zero_grad()
            with mesh_mod.use_mesh(self.mesh):
                loss = loss_fn(named, batch)
                loss.backward()
                self.step()
            loss = loss.detach()
            if loss_set is not None:
                loss = collectives.allreduce(
                    loss, op=T.Average if mean else T.Sum,
                    name="sharded_step.loss", process_set=loss_set)
            return loss

        return step

    def shard_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's shard of each global leaf of `params` under this
        optimizer's spec (the spec-driven device_put of the JAX step)."""
        if self.sharding_spec is None:
            raise ValueError("shard_params requires sharding_spec")
        return {n: mesh_mod.shard_of(v, self.sharding_spec[n], self.mesh)
                for n, v in params.items()}

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
              wire_dtype(self.compression, self.params[i].dtype,
                         self.params[i].numel()))
             for i in dense], threshold, reverse=True)

    def _replan(self) -> None:
        """Plan the dense parameters into buckets at the threshold in
        force (between steps only)."""
        self.plan_threshold = self._threshold()
        dense, plan = self._dense_plan(self.plan_threshold)
        self._dense, self._dense_plan_raw = dense, plan
        self._desc = None  # the step's descriptor, built at its first launch
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
        self._inflight: dict = {}  # bucket index -> Handle
        self._wires: dict = {}  # param index -> compress(gradient)
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
        if self.hooked:
            if self._desc is None:
                self._desc = collectives.describe_bucketed(
                    [tuple(self.params[i].shape) for i in self._dense],
                    rop, self.plan_threshold, self._dense_plan_raw, ps)
            collectives.dispatch(self._desc, ps, "bucketed_allreduce")
        self._start = collectives._launch(rop, pre, post, ps)
        self._ps = ps
        pm, bt = self._tuners()
        if pm is not None:
            self._t_first = time.perf_counter()
        if bt is not None and self.hooked:
            self._timer = collectives.BucketTimer(topology.device())

    def _tune(self, nbytes: int) -> None:
        """Feed the live tuners at the end of a reduction, then re-plan
        if a decision moved the threshold."""
        pm, bt = self._tuners()
        self._spans = None
        if bt is not None and self.hooked:  # it tunes the bucket path
            for nb, sec in self._timer.results():
                bt.record_bucket(nb, sec)
            self._spans = self._timer.spans
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

    def _wire(self, i: int):
        """(wire tensor, ctx) of gradient i, compressed once a step, when
        the first bucket that holds it (or a chunk of it) launches."""
        if i not in self._wires:
            self._wires[i] = self.compression.compress(self._dense_grad(i))
        return self._wires[i]

    def _launch(self, bi: int) -> None:
        label = f"bucketed_allreduce/b{bi}"
        with collectives.instrument(label, "ALLREDUCE") as ins:
            if self._start is None:
                self._begin()
            wire = fusion.pack(self.plan[bi], {i: self._wire(i)[0]
                                               for i in self._members[bi]})
            start = self._start
            if self._timer is not None:
                h = self._timer.launch(wire.numel() * wire.element_size(),
                                       lambda: start(wire))
            else:
                h = start(wire)
            h.label = label
            ins.meta = collectives._meta(h, self._ps, [wire]).meta
        if ins.enabled:
            mx = collectives._mx()
            mx["bucket_n"].inc()
            mx["bucket_bytes"].observe(ins.meta[1])
        self._inflight[bi] = h

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
        # A gradient sent as it is (its wire tensor is the .grad itself)
        # is reduced in place; the others land in a wire-dtype buffer,
        # decompressed into .grad below (sparse ones are dropped).
        outs = {}
        for members in self._members:
            for i in members:
                w, _ = self._wire(i)
                g = self.params[i].grad
                outs[i] = g.view(-1) if w is g and i not in sparse \
                    else w.new_empty(w.numel())
        for bi, b in enumerate(self.plan):
            fusion.unpack(b, self._inflight[bi].wait(), outs)
        for i, out in outs.items():
            g = self.params[i].grad
            if i not in sparse and out.data_ptr() != g.data_ptr():
                g.copy_(self.compression.decompress(
                    out.view(g.shape), self._wires[i][1]))
        self._reduce_sparse(sparse)
        self.collectives_per_step = len(self.plan) + 2 * len(sparse)
        nbytes = self.plan_bytes  # the plan may change below
        n_buckets = len(self.plan)  # the plan may change in _tune
        self._tune(nbytes)
        collectives.record_buckets(n_buckets, self._spans)
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
            if self.sharding_spec is not None:
                scope.set_comms_axes(self._synchronize_sharded())
                self._synchronized = True
                return
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

    def abandon_step(self) -> None:
        """Forget a step that failed part-way (a collective raised in
        elastic mode): its in-flight buckets, the gradients counted
        toward them, and the step's launcher, which holds the old
        world's size. The elastic restore calls it; the next step plans
        from the world in force."""
        self._reset()
        self._synchronized = False

    def zero_grad(self, set_to_none: bool = True):
        return self.opt.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self.opt.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.opt.load_state_dict(state_dict)


def build_sharded_train_step(loss_fn: Callable,
                             optimizer: torch.optim.Optimizer,
                             named_parameters, mesh=None,
                             param_specs: Optional[Dict[str, tuple]] = None,
                             batch_spec=None, op: T.ReduceOp = T.Average,
                             compression=Compression.none,
                             gradient_predivide_factor: float = 1.0,
                             loss_axes: Optional[Tuple[str, ...]] = None
                             ) -> Callable:
    """The sharded train step over `mesh` (default the HOROVOD_MESH
    mesh) for parameters that follow `param_specs` ({name: partition
    spec}): `step(batch) -> loss`, through
    DistributedOptimizer(sharding_spec=...).sharded_step (its docstring
    has the contract for `loss_fn`)."""
    if param_specs is None:
        raise ValueError("build_sharded_train_step requires param_specs "
                         "({name: partition spec})")
    named_parameters = list(named_parameters)
    opt = DistributedOptimizer(
        optimizer, named_parameters=named_parameters, op=op,
        compression=compression,
        gradient_predivide_factor=gradient_predivide_factor,
        sharding_spec=param_specs, mesh=mesh)
    return opt.sharded_step(loss_fn, batch_spec, loss_axes)
