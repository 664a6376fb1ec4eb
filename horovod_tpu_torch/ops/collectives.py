"""Eager collectives over torch.distributed (counterpart of the public
eager API of horovod_tpu/ops/collectives.py): allreduce, grouped and
bucketed allreduce, allgather and grouped_allgather, reducescatter and
grouped_reducescatter, alltoall, broadcast, barrier, their `_async`
forms, synchronize and poll, each over a process set.

Every collective is issued with `async_op=True`; a `Handle` holds the
`Work` and the output, `synchronize` waits on it and `poll` reports
`Work.is_completed()`. An async handle holds its `name` until it is
synchronized: another operation with that name meanwhile raises
DuplicateNameError. Every op takes `process_set=` (default the global
set); a rank outside the set raises instead of joining.

Reductions follow the JAX package's `_apply_reduce`
(horovod_tpu/ops/collectives.py:505-533):
- Average is a sum divided by the set's size in the tensor's own dtype:
  floor division for an integer tensor, true division otherwise;
- Min and Max are NCCL's (gloo's) MIN and MAX;
- Product gathers every rank's tensor and multiplies them in rank order,
  float16 and bf16 in float32 as jnp.prod computes them, not the
  library's PROD, whose ring order would round differently;
- Adasum is ops/adasum.py;
- pre- and postscale factors are cast to the tensor's dtype before they
  multiply it (`jnp.asarray(f, x.dtype)`).
Under HOROVOD_HIERARCHICAL_ALLREDUCE, Sum and Average over the global
set run reduce-scatter over the local group, all-reduce over the cross
group and all-gather over the local group (`_apply_reduce_hier`); under
HOROVOD_HIERARCHICAL_ALLGATHER an allgather of equal sizes gathers over
the local group, then the cross group (core/topology.py builds both).

A sparse tensor (`torch.sparse_coo`) reduces as the JAX package's torch
frontend does (`_sparse_allreduce`): allgather of its indices and
values, a coalesced sum, Average dividing by the set's size, the scale
factors on the values. `BucketTimer` takes each bucket's
launch-to-completion time for the online bucket tuner (the counterpart
of the JAX package's profiled `bucketed_allreduce`).

Every call is instrumented as in the JAX package (`instrument`): one
span on the Chrome-trace timeline (profiler/timeline.py), named by the
op's name and its activity (ALLREDUCE, ALLGATHER, BROADCAST,
REDUCESCATTER, ALLTOALL, BARRIER), and its window attributed to
perfscope's `comms` phase (profiler/perfscope.py). The window of an
`_async` form is the launch; that of the blocking form, launch and wait.
On a card both are host windows: the device may still be transferring
when `wait()` returns.

Not ported here: the consistency fingerprints (ROADMAP A13), the
collectives' metrics and byte counters, and the stall watchdog (A13).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import types as T
from horovod_tpu_torch.common.exceptions import (DuplicateNameError,
                                                 HorovodError)
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.core.process_sets import ProcessSet, global_process_set
from horovod_tpu_torch.ops import adasum, fusion
from horovod_tpu_torch.profiler import perfscope

# torch 2.13 renames the tensor forms to *_single and deprecates the old
# names; older builds have only the old ones.
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class Handle:
    """An in-flight collective: its Work, the tensor it writes, what
    finishes the result once the Work is done, and the name it holds."""

    def __init__(self, work, out, finish=None, name: Optional[str] = None):
        self.work = work
        self.out = out
        self._finish = finish
        self.name = name
        self._done = False

    def wait(self):
        if not self._done:
            try:
                if self.work is not None:
                    self.work.wait()
                    self.work = None
                if self._finish is not None:
                    self.out = self._finish(self.out)
            finally:
                self._done = True
                release_inflight_name(self.name)
        return self.out


# In-flight names: an async handle claims its name until synchronize.
_inflight_names: set = set()
_inflight_lock = threading.Lock()


def register_inflight_name(name: Optional[str]) -> bool:
    """Claim `name` until release_inflight_name; raises DuplicateNameError
    if an operation with that name is still pending. Returns False for
    anonymous ops (no claim)."""
    if not name:
        return False
    with _inflight_lock:
        if name in _inflight_names:
            raise DuplicateNameError(
                f"an operation named '{name}' is already in flight — "
                f"synchronize it before reusing the name (reference: "
                f"DUPLICATE_NAME_ERROR, common/tensor_queue.cc)")
        _inflight_names.add(name)
        return True


def release_inflight_name(name: Optional[str]) -> None:
    if name:
        with _inflight_lock:
            _inflight_names.discard(name)


def _named(name: Optional[str], start: Callable[[], Handle]) -> Handle:
    """Claim `name`, then start the op; the handle releases the name."""
    claimed = register_inflight_name(name)
    try:
        h = start()
    except BaseException:
        release_inflight_name(name if claimed else None)
        raise
    h.name = name if claimed else None
    return h


class instrument:
    """A timeline span and perfscope's `comms` attribution around a
    collective's host window (the JAX package's `_instrument`). With no
    timeline and HOROVOD_PERFSCOPE=0 it reads no clock. Nested
    attributions (a kernel build inside the window) are subtracted from
    the window's own by diffing `attributed_marker`."""

    __slots__ = ("name", "activity", "tl", "ps", "timed", "t0",
                 "attr_mark")

    def __init__(self, name: str, activity: str) -> None:
        self.name = name
        self.activity = activity

    def __enter__(self) -> "instrument":
        self.ps = perfscope.get()
        self.tl = topology.timeline()
        if self.tl is not None:
            self.tl.span_begin(self.name, self.activity)
        self.timed = self.ps is not perfscope.NOOP
        if self.timed:
            self.attr_mark = self.ps.attributed_marker()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.timed:
            dt = time.perf_counter() - self.t0
        if self.tl is not None:
            self.tl.span_end(self.name, self.activity)
        if self.timed:
            nested = self.ps.attributed_marker() - self.attr_mark
            self.ps.attribute("comms", dt - nested)
        return False


def _call(name: str, activity: str, start: Callable[[], Handle],
          wait: bool):
    """Start an op inside its instrumented window; with `wait`, wait for
    it there too and return its result, else return the handle."""
    with instrument(name, activity):
        h = start()
        return h.wait() if wait else h


def _resolve(process_set: Optional[ProcessSet]) -> ProcessSet:
    topology._require()
    ps = process_set if process_set is not None else global_process_set
    if ps.process_set_id is None:
        raise HorovodError(
            f"process set {ps} is not registered; call hvd.add_process_set")
    if not ps.included():
        raise HorovodError(
            f"rank {topology.rank()} is not in process set "
            f"{ps.process_set_id} (ranks {ps.ranks})")
    return ps


def _normalize_op(average: Optional[bool], op) -> T.ReduceOp:
    if op is not None and average is not None:
        raise ValueError("pass either `average` or `op`, not both")
    if op is None:
        return T.ReduceOp.SUM if average is False else T.ReduceOp.AVERAGE
    return T.normalize_reduce_op(op)


def average(y: torch.Tensor, k: int) -> torch.Tensor:
    """A sum over k ranks divided by k in y's own dtype: floor division
    for integers, true division otherwise."""
    kt = torch.tensor(k, dtype=y.dtype, device=y.device)
    if y.is_floating_point() or y.is_complex():
        return y / kt
    return torch.div(y, kt, rounding_mode="floor")


def scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    """x times `factor` cast to x's dtype."""
    return x * torch.tensor(factor, dtype=x.dtype, device=x.device)


def _product(g: torch.Tensor) -> torch.Tensor:
    """The product over dim 0 in index (rank) order; float16 and bf16
    multiply in float32 and round once, as jnp.prod does."""
    acc = g[0].float() if g.dtype in (torch.float16, torch.bfloat16) \
        else g[0]
    for i in range(1, g.shape[0]):
        acc = acc * g[i]
    return acc.to(g.dtype)


def _joined(hs: List[Handle]) -> Handle:
    """One handle over several: waiting gives their results in order."""
    return Handle(None, hs, lambda hs: [h.wait() for h in hs])


def _hier_for(ps: ProcessSet, flag: bool) -> Optional[topology.Hier]:
    """The hierarchical groups where `flag` asks for them and `ps` is the
    global set (sub-sets keep the flat path)."""
    return topology.hier() if flag and ps.ranks is None else None


def _hier_allreduce(x: torch.Tensor, h: topology.Hier):
    """ReduceScatter over the local group → AllReduce over the cross
    group → AllGather over the local group, on x zero-padded to a
    multiple of the local size; returns (work, gathered, trim)."""
    n = x.numel()
    v = x.reshape(-1)
    pad = -n % h.n_local
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    s = v.new_empty(v.numel() // h.n_local)
    _reduce_scatter_single(s, v, group=h.local_group, async_op=True).wait()
    if h.n_cross > 1:
        dist.all_reduce(s, group=h.cross_group, async_op=True).wait()
    out = torch.empty_like(v)
    work = _all_gather_single(out, s, group=h.local_group, async_op=True)
    shape = x.shape
    return work, out, lambda y: y[:n].reshape(shape)


def _launch(rop: T.ReduceOp, prescale: float, postscale: float,
            ps: ProcessSet) -> Callable[[torch.Tensor], Handle]:
    """A function that starts the reduction of one tensor it owns."""
    k = ps.size()
    group = ps.group
    cfg = topology.config()
    hier = _hier_for(ps, cfg.hierarchical_allreduce) \
        if rop in (T.ReduceOp.SUM, T.ReduceOp.AVERAGE) else None

    def post(y: torch.Tensor) -> torch.Tensor:
        if rop == T.ReduceOp.AVERAGE and k != 1:
            y = average(y, k)
        if postscale != 1.0:
            y = scale(y, postscale)
        return y

    def start(x: torch.Tensor) -> Handle:
        T.check_supported_dtype(x.dtype)
        if prescale != 1.0:
            x = scale(x, prescale)
        if hier is not None:
            work, out, trim = _hier_allreduce(x, hier)
            return Handle(work, out, lambda y: post(trim(y)))
        if rop in (T.ReduceOp.SUM, T.ReduceOp.AVERAGE, T.ReduceOp.MIN,
                   T.ReduceOp.MAX):
            op = {T.ReduceOp.MIN: dist.ReduceOp.MIN,
                  T.ReduceOp.MAX: dist.ReduceOp.MAX}.get(rop,
                                                         dist.ReduceOp.SUM)
            work = dist.all_reduce(x, op=op, group=group, async_op=True)
            return Handle(work, x, post)
        if rop == T.ReduceOp.PRODUCT:
            g = x.new_empty(k * x.numel())
            work = _all_gather_single(g, x.reshape(-1), group=group,
                                      async_op=True)
            shape = (k,) + tuple(x.shape)
            return Handle(work, g, lambda y: post(_product(y.view(shape))))
        if rop == T.ReduceOp.ADASUM:
            y = adasum.adasum_allreduce(x, ps, halving=cfg.adasum_halving)
            return Handle(None, y, post)
        raise HorovodError(f"unsupported reduce op {rop}")

    return start


def _allreduce(tensor, average, name, op, prescale_factor, postscale_factor,
               process_set) -> Handle:
    ps = _resolve(process_set)
    rop = _normalize_op(average, op)
    if tensor.is_sparse:
        return _named(name, lambda: Handle(None, sparse_allreduce(
            tensor, rop, ps, prescale_factor, postscale_factor)))
    start = _launch(rop, prescale_factor, postscale_factor, ps)
    return _named(name, lambda: start(tensor.clone()))


def allreduce_async(tensor: torch.Tensor, average: Optional[bool] = None,
                    name: Optional[str] = None, op=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set: Optional[ProcessSet] = None) -> Handle:
    """Start reducing `tensor` across the set; the input is untouched."""
    return _call(name or "allreduce", "ALLREDUCE", lambda: _allreduce(
        tensor, average, name, op, prescale_factor, postscale_factor,
        process_set), False)


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op=None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Reduce `tensor` across the set (default: Average)."""
    return _call(name or "allreduce", "ALLREDUCE", lambda: _allreduce(
        tensor, average, name, op, prescale_factor, postscale_factor,
        process_set), True)


def _fused(tensors, average, op, prescale, postscale, process_set,
           reverse: Optional[bool], name) -> Handle:
    """Start a group's reduction: Adasum tensor by tensor (its dots are
    per tensor), every other op in ≤-threshold buckets, one collective
    per bucket, packed in submission order (reverse False) or backward
    production order (None: HOROVOD_BUCKET_REVERSE)."""
    ps = _resolve(process_set)
    rop = _normalize_op(average, op)
    start = _launch(rop, prescale, postscale, ps)

    def go() -> Handle:
        if not tensors:
            return Handle(None, [])
        if rop == T.ReduceOp.ADASUM:
            return _joined([start(t.clone()) for t in tensors])
        cfg = topology.config()
        thresh = fusion.effective_threshold(cfg.fusion_threshold_bytes,
                                            cfg.bucket_cap_bytes)
        rev = cfg.bucket_reverse if reverse is None else reverse
        buckets = itertools.count()

        def launch(flat):
            if reverse is not None:  # grouped: one span for the call
                return start(flat).wait
            # bucketed: a span for each bucket's launch, as in the JAX
            # package
            with instrument(f"{name or 'bucketed_allreduce'}"
                            f"/b{next(buckets)}", "ALLREDUCE"):
                return start(flat).wait

        finish = fusion.fused_launch(list(tensors), launch, thresh,
                                     reverse=rev)
        return Handle(None, None, lambda _: finish())

    return _named(name, go)


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            average: Optional[bool] = None,
                            name: Optional[str] = None, op=None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set: Optional[ProcessSet] = None
                            ) -> Handle:
    """Start grouped_allreduce; the handle gives the list of results."""
    return _call(name or "grouped_allreduce", "ALLREDUCE", lambda: _fused(
        tensors, average, op, prescale_factor, postscale_factor,
        process_set, False, name), False)


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      average: Optional[bool] = None,
                      name: Optional[str] = None, op=None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: Optional[ProcessSet] = None
                      ) -> List[torch.Tensor]:
    """Reduce a group of tensors in ≤-threshold buckets packed in
    submission order, one collective per bucket."""
    return _call(name or "grouped_allreduce", "ALLREDUCE", lambda: _fused(
        tensors, average, op, prescale_factor, postscale_factor,
        process_set, False, name), True)


def bucketed_allreduce_async(tensors: Sequence[torch.Tensor],
                             average: Optional[bool] = None,
                             name: Optional[str] = None, op=None,
                             prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0,
                             process_set: Optional[ProcessSet] = None
                             ) -> Handle:
    """Start bucketed_allreduce; the handle gives the list of results."""
    return _call(name or "bucketed_allreduce", "ALLREDUCE", lambda: _fused(
        tensors, average, op, prescale_factor, postscale_factor,
        process_set, None, name), False)


def bucketed_allreduce(tensors: Sequence[torch.Tensor],
                       average: Optional[bool] = None,
                       name: Optional[str] = None, op=None,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       process_set: Optional[ProcessSet] = None
                       ) -> List[torch.Tensor]:
    """Reduce a group of tensors as independently launched buckets packed
    in backward-production order (HOROVOD_BUCKET_REVERSE); all buckets are
    in flight before the first is waited on."""
    return _call(name or "bucketed_allreduce", "ALLREDUCE", lambda: _fused(
        tensors, average, op, prescale_factor, postscale_factor,
        process_set, None, name), True)


# ------------------------------------------------------- sparse tensors

def sparse_allreduce(tensor: torch.Tensor, op=T.ReduceOp.AVERAGE,
                     process_set: Optional[ProcessSet] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0) -> torch.Tensor:
    """Reduce a sparse COO tensor across the set: every member's indices
    and values gathered in set order and summed where indices repeat;
    Average divides by the set's size. Only Sum and Average are defined
    on sparse tensors."""
    ps = _resolve(process_set)
    rop = T.normalize_reduce_op(op)
    if rop not in (T.ReduceOp.SUM, T.ReduceOp.AVERAGE):
        raise HorovodError(
            f"a sparse tensor reduces with Sum or Average, not {rop.name}; "
            f"pass sparse_as_dense=True to reduce it densely")
    t = tensor.coalesce()
    idx, val = t.indices(), t.values()
    if prescale_factor != 1.0:
        val = scale(val, prescale_factor)
    all_idx = allgather(idx.t().contiguous(), process_set=ps)
    all_val = allgather(val.contiguous(), process_set=ps)
    out = torch.sparse_coo_tensor(all_idx.t(), all_val, size=t.shape,
                                  check_invariants=True).coalesce()
    factor = postscale_factor
    if rop == T.ReduceOp.AVERAGE:
        factor = factor / ps.size()
    if factor != 1.0:
        out = torch.sparse_coo_tensor(out.indices(),
                                      scale(out.values(), factor),
                                      size=t.shape,
                                      check_invariants=True).coalesce()
    return out


def sparse_allreduce_async(tensor: torch.Tensor, name: Optional[str] = None,
                           op=T.ReduceOp.AVERAGE,
                           process_set: Optional[ProcessSet] = None
                           ) -> Handle:
    """sparse_allreduce behind the async API: it runs at the call, and
    the handle gives the result."""
    ps = _resolve(process_set)
    return _named(name, lambda: Handle(None, sparse_allreduce(
        tensor, op, ps)))


# ------------------------------------------------- per-bucket timing

_bucket_tls = threading.local()


def last_bucket_timings() -> List[Tuple[int, float]]:
    """(wire bytes, seconds) of each bucket of this thread's last timed
    reduction (`BucketTimer.results`)."""
    return list(getattr(_bucket_tls, "timings", ()))


class BucketTimer:
    """Each bucket's time from its launch to the completion of its
    collective, for the online bucket tuner.

    On the card the span runs from a CUDA event on the compute stream at
    the launch (where the bucket's gradients are ready, since the
    collective waits on that stream) to an event on a side stream that
    waits on the collective's end: device time, including the wait
    behind earlier buckets on the communication stream, and none of the
    host's time until `step()`. On the host it runs from the launch to
    the moment the library's future completes. `results()` waits for
    every event (a device sync), so a timer is only made while a tuner
    is live."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._side = torch.cuda.Stream(device) if self._cuda else None
        self._recs: List[list] = []

    def launch(self, nbytes: int, start: Callable[[], Handle]) -> Handle:
        if self._cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t0.record()
            h = start()
            t1 = torch.cuda.Event(enable_timing=True)
            if h.work is not None:
                with torch.cuda.stream(self._side):
                    h.work.wait()
                    t1.record()
            else:
                t1.record()
            self._recs.append([nbytes, t0, t1])
            return h
        rec = [nbytes, time.perf_counter(), None]
        h = start()
        fut = h.work.get_future() if h.work is not None else None
        if fut is None:
            rec[2] = time.perf_counter()
        else:
            fut.add_done_callback(
                lambda _f: rec.__setitem__(2, time.perf_counter()))
        self._recs.append(rec)
        return h

    def results(self) -> List[Tuple[int, float]]:
        """(wire bytes, seconds) per bucket, in launch order; resets."""
        out = []
        for nbytes, t0, t1 in self._recs:
            if self._cuda:
                t1.synchronize()
                out.append((nbytes, t0.elapsed_time(t1) / 1e3))
            elif t1 is not None:
                out.append((nbytes, t1 - t0))
        self._recs = []
        _bucket_tls.timings = out
        return out


# ------------------------------------------------------------ allgather

def _exchange_rows(row: Sequence[int], ps: ProcessSet) -> List[List[int]]:
    """Every member's small int row, in set order: one all-gather of an
    int64 row on the collective's device, read back with one sync."""
    if ps.size() == 1:
        return [list(row)]
    mine = torch.tensor(list(row), dtype=torch.int64,
                        device=topology.device())
    rows = mine.new_empty(ps.size() * mine.numel())
    _all_gather_single(rows, mine, group=ps.group)
    return rows.view(ps.size(), -1).tolist()


def _gather_start(x: torch.Tensor, sizes: Sequence[int], ps: ProcessSet
                  ) -> Handle:
    """Start the all-gather of x, whose dim 0 is sizes[i] on member i:
    pad to the largest, gather, trim and concatenate in set order. Equal
    sizes on the global set under HOROVOD_HIERARCHICAL_ALLGATHER gather
    over the local group, then the cross group."""
    T.check_supported_dtype(x.dtype)
    k = ps.size()
    rest = tuple(x.shape[1:])
    x = x.contiguous()
    even = len(set(sizes)) == 1
    hier = _hier_for(ps, topology.config().hierarchical_allgather) \
        if even else None
    if hier is not None:
        g1 = x.new_empty((hier.n_local * x.shape[0],) + rest)
        _all_gather_single(g1, x, group=hier.local_group,
                           async_op=True).wait()
        if hier.n_cross == 1:
            return Handle(None, g1)
        out = x.new_empty((k * x.shape[0],) + rest)
        work = _all_gather_single(out, g1, group=hier.cross_group,
                                  async_op=True)
        return Handle(work, out)
    m = max(sizes)
    if x.shape[0] < m:
        x = torch.cat([x, x.new_zeros((m - x.shape[0],) + rest)])
    out = x.new_empty((k * m,) + rest)
    work = _all_gather_single(out, x, group=ps.group, async_op=True)
    if even:
        return Handle(work, out)
    return Handle(work, out, lambda y: torch.cat(
        [y[i * m:i * m + n] for i, n in enumerate(sizes)]))


def _check_dims(t: torch.Tensor, what: str) -> None:
    if t.dim() < 1:
        raise HorovodError(
            f"{what} requires per-rank tensors with at least one dimension")


def _allgather(tensor, name, process_set) -> Handle:
    ps = _resolve(process_set)
    _check_dims(tensor, "allgather")

    def go() -> Handle:
        sizes = [r[0] for r in _exchange_rows([tensor.shape[0]], ps)]
        return _gather_start(tensor, sizes, ps)

    return _named(name, go)


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> Handle:
    """Start the concatenation of every member's tensor along dim 0; the
    first dims may differ (they are exchanged first)."""
    return _call(name or "allgather", "ALLGATHER",
                 lambda: _allgather(tensor, name, process_set), False)


def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Concatenate every member's tensor along dim 0, in set order."""
    return _call(name or "allgather", "ALLGATHER",
                 lambda: _allgather(tensor, name, process_set), True)


def grouped_allgather(tensors: Sequence[torch.Tensor],
                      name: Optional[str] = None,
                      process_set: Optional[ProcessSet] = None
                      ) -> List[torch.Tensor]:
    """allgather of each tensor, with one size exchange for the group;
    every gather is in flight before the first is waited on."""
    ps = _resolve(process_set)
    for t in tensors:
        _check_dims(t, "allgather")

    def go() -> Handle:
        if not tensors:
            return Handle(None, [])
        rows = _exchange_rows([t.shape[0] for t in tensors], ps)
        return _joined([_gather_start(t, [r[i] for r in rows], ps)
                        for i, t in enumerate(tensors)])

    return _call(name or "grouped_allgather", "ALLGATHER",
                 lambda: _named(name, go), True)


# -------------------------------------------------------- reducescatter

def _rs_sizes(d0: int, k: int) -> List[int]:
    """Horovod's uneven rule: member i gets d0 // k + (i < d0 % k) rows."""
    return [d0 // k + (1 if i < d0 % k else 0) for i in range(k)]


def _rs_start(x: torch.Tensor, rop: T.ReduceOp, prescale: float,
              postscale: float, ps: ProcessSet) -> Handle:
    """One tensor's reduce-scatter (`_rs_block`): an even split is the
    library's reduce-scatter, an uneven one the full reduction sliced.
    Average is true division by the set's size (an integer tensor gives
    a floating one, as `/` does in the JAX package)."""
    T.check_supported_dtype(x.dtype)
    _check_dims(x, "reducescatter")
    k = ps.size()
    d0 = x.shape[0]
    x = scale(x, prescale) if prescale != 1.0 else x.clone()
    x = x.contiguous()

    def post(y: torch.Tensor) -> torch.Tensor:
        if rop == T.ReduceOp.AVERAGE:
            y = y / torch.tensor(k, dtype=y.dtype, device=y.device)
        if postscale != 1.0:
            y = scale(y, postscale)
        return y

    if d0 % k == 0:
        out = x.new_empty((d0 // k,) + tuple(x.shape[1:]))
        work = _reduce_scatter_single(out, x, group=ps.group,
                                      async_op=True)
        return Handle(work, out, post)
    sizes = _rs_sizes(d0, k)
    i = ps.rank_index(topology.rank())
    start = sum(sizes[:i])
    work = dist.all_reduce(x, group=ps.group, async_op=True)
    return Handle(work, x, lambda y: post(y[start:start + sizes[i]]))


def _rs_op(op) -> T.ReduceOp:
    rop = T.ReduceOp.AVERAGE if op is None else T.normalize_reduce_op(op)
    if rop not in (T.ReduceOp.SUM, T.ReduceOp.AVERAGE):
        raise HorovodError("reducescatter supports SUM and AVERAGE only")
    return rop


def _rs(tensor, op, name, prescale_factor, postscale_factor, process_set
        ) -> Handle:
    ps = _resolve(process_set)
    rop = _rs_op(op)
    return _named(name, lambda: _rs_start(tensor, rop, prescale_factor,
                                          postscale_factor, ps))


def reducescatter_async(tensor: torch.Tensor, op=T.ReduceOp.AVERAGE,
                        name: Optional[str] = None,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        process_set: Optional[ProcessSet] = None) -> Handle:
    """Start reducing across the set and scattering dim 0's rows: member
    i gets rows [sum(sizes[:i]), sum(sizes[:i+1])), sizes by Horovod's
    uneven rule."""
    return _call(name or "reducescatter", "REDUCESCATTER", lambda: _rs(
        tensor, op, name, prescale_factor, postscale_factor, process_set),
        False)


def reducescatter(tensor: torch.Tensor, op=T.ReduceOp.AVERAGE,
                  name: Optional[str] = None,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0,
                  process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Reduce across the set, then scatter slices of dim 0."""
    return _call(name or "reducescatter", "REDUCESCATTER", lambda: _rs(
        tensor, op, name, prescale_factor, postscale_factor, process_set),
        True)


def grouped_reducescatter(tensors: Sequence[torch.Tensor],
                          op=T.ReduceOp.AVERAGE,
                          name: Optional[str] = None,
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          process_set: Optional[ProcessSet] = None
                          ) -> List[torch.Tensor]:
    """reducescatter of each tensor, all in flight before the first is
    waited on."""
    ps = _resolve(process_set)
    rop = _rs_op(op)

    def go() -> Handle:
        return _joined([_rs_start(t, rop, prescale_factor, postscale_factor,
                                  ps) for t in tensors])

    return _call(name or "grouped_reducescatter", "REDUCESCATTER",
                 lambda: _named(name, go), True)


# ------------------------------------------------------------- alltoall

def _alltoall(tensor, splits, name, process_set) -> Handle:
    ps = _resolve(process_set)
    _check_dims(tensor, "alltoall")
    T.check_supported_dtype(tensor.dtype)
    k = ps.size()
    d0 = tensor.shape[0]
    if splits is None:
        if d0 % k:
            raise HorovodError(
                f"alltoall without splits requires dim0 ({d0}) divisible "
                f"by set size ({k})")
        mine = [d0 // k] * k
    else:
        mine = [int(s) for s in (splits.tolist() if torch.is_tensor(splits)
                                 else splits)]
        if len(mine) != k or sum(mine) != d0:
            raise HorovodError("splits must have one entry per rank and "
                               "sum to dim 0")

    def go() -> Handle:
        matrix = [mine] * k if splits is None else _exchange_rows(mine, ps)
        me = ps.rank_index(topology.rank())
        recv = [row[me] for row in matrix]
        x = tensor.contiguous()
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        work = dist.all_to_all_single(out, x, output_split_sizes=recv,
                                      input_split_sizes=mine,
                                      group=ps.group, async_op=True)
        return Handle(work, out, lambda y: (
            y, torch.tensor(recv, dtype=torch.int64)))

    return _named(name, go)


def alltoall_async(tensor: torch.Tensor, splits=None,
                   name: Optional[str] = None,
                   process_set: Optional[ProcessSet] = None) -> Handle:
    """Start the alltoall; the handle gives (output, received_splits)."""
    return _call(name or "alltoall", "ALLTOALL", lambda: _alltoall(
        tensor, splits, name, process_set), False)


def alltoall(tensor: torch.Tensor, splits=None, name: Optional[str] = None,
             process_set: Optional[ProcessSet] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send rows splits[j] of dim 0 to member j, receive every member's
    rows for this one in set order; returns (output, received_splits).
    Without splits, dim 0 must divide by the set's size."""
    return _call(name or "alltoall", "ALLTOALL", lambda: _alltoall(
        tensor, splits, name, process_set), True)


# ------------------------------------------------- broadcast and barrier

def _broadcast(tensor, root_rank, name, process_set) -> Handle:
    ps = _resolve(process_set)
    ps.rank_index(root_rank)  # the root must be a member

    def go() -> Handle:
        out = tensor.clone()
        return Handle(dist.broadcast(out, src=root_rank, group=ps.group,
                                     async_op=True), out)

    return _named(name, go)


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> Handle:
    """Start broadcasting the root's tensor (root_rank is a global rank,
    a member of the set) into a new tensor on every member."""
    return _call(name or "broadcast", "BROADCAST", lambda: _broadcast(
        tensor, root_rank, name, process_set), False)


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """The root rank's tensor, on every member (a new tensor)."""
    return _call(name or "broadcast", "BROADCAST", lambda: _broadcast(
        tensor, root_rank, name, process_set), True)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """In-place broadcast of `tensor` from the root rank (a global rank,
    a member of the set)."""
    ps = _resolve(process_set)
    ps.rank_index(root_rank)
    with instrument("broadcast", "BROADCAST"):
        dist.broadcast(tensor, src=root_rank, group=ps.group)
    return tensor


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Block until every member reaches the barrier: a one-element
    all-reduce on the collective's device, read back."""
    ps = _resolve(process_set)
    with instrument("barrier", "BARRIER"):
        one = torch.ones(1, dtype=torch.int32, device=topology.device())
        dist.all_reduce(one, group=ps.group)
        one.item()


def synchronize(handle: Handle):
    """Wait for an async collective and return its result."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """True once the collective behind `handle` has completed."""
    return handle.work is None or handle.work.is_completed()
