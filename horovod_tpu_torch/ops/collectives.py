"""Eager collectives over torch.distributed (counterpart of the public
eager API of horovod_tpu/ops/collectives.py): allreduce, grouped and
bucketed allreduce, allgather and grouped_allgather, reducescatter and
grouped_reducescatter, alltoall, broadcast, barrier, their `_async`
forms, synchronize and poll, each over a process set; and the in-place
forms of the JAX package's torch frontend (horovod_tpu/frontends/
torch.py): allreduce_, grouped_allreduce_, broadcast_ and their
`_async_` forms write the result into the caller's tensors and give
those same tensor objects back.

Every collective is issued with `async_op=True`; a `Handle` holds the
`Work` and the output, `synchronize` waits on it and `poll` reports
`Work.is_completed()`. The blocking forms, and the port's other
collectives (sync-BN, Adasum, process sets, init), wait on the `Work`
too and never call the synchronous form: under
TORCH_NCCL_BLOCKING_WAIT only `Work.wait()` blocks the host until the
collective completes or times out (torch 2.11's synchronous call
returns at once), which is how a dead peer surfaces in elastic mode
(core/topology.py). An async handle holds its `name` until it is
synchronized: another operation with that name meanwhile raises
DuplicateNameError. Every op takes `process_set=` (default the global
set); a rank outside the set raises instead of joining.

An in-place form runs the collective on the caller's tensor wherever the
library can write into it (broadcast; Sum, Min and Max on the flat path;
a fused bucket unpacked straight into the caller's contiguous tensors)
and otherwise copies the finished result into it on the device: no
round-trip through the host, which is what the JAX frontend does. An
`_async_` form writes by the time `synchronize` returns (the library may
write earlier: the tensor is the collective's buffer while in flight).

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

In elastic mode (HOROVOD_ELASTIC=1) a transport failure of a collective
(a `torch.distributed.DistError`, or a message such as gloo's
"Connection closed by peer" or NCCL's blocking-wait timeout) surfaces as
HorovodInternalError, where the elastic retry loop catches it
(`comm_failure_guard`, as the JAX package's `is_comm_failure` and
`_execute`): in `Handle.wait` and around every instrumented window,
which covers the blocking collectives, the bucket launches and their
waits in `DistributedOptimizer.synchronize`. Outside elastic mode the
error surfaces as it is.

Observability and call agreement, as in the JAX package:
- every call passes one dispatch choke point (`dispatch`, the JAX
  package's `_consistency`) with a descriptor in the JAX package's text
  (`describe_*`): one flight-recorder record (observability/flight.py),
  a tracing dispatch marker under the ambient step (observability/
  tracing.py), the cross-rank agreement of core/consistency.py
  (HOROVOD_CONSISTENCY_CHECK, on by default in launched worlds of two or
  more) and the rolling fingerprint of analysis/verifier.py
  (HOROVOD_CHECK_COLLECTIVES), each scoped to the process set. The hook
  path of DistributedOptimizer passes it once a step, on the step's
  bucket plan, as the JAX package's one `bucketed_allreduce` call does;
- `instrument` counts the calls, the bytes (the set's size times this
  rank's payload, as the JAX package counts its global arrays) and the
  host window of each call into the metrics registry
  (observability/metrics.py), and records a tracing span;
- every wait on a collective's `Work` goes through `guarded_wait`: the
  stall inspector (native/ StallInspector, or common/resilience.py
  PyStallInspector without a toolchain) names it while it is pending,
  and with HOROVOD_STALL_SHUTDOWN_TIME_SECONDS > 0 the `StallWatchdog`
  bounds it: it polls `Work.is_completed()` (never a thread left
  blocked), warns at HOROVOD_STALL_CHECK_TIME_SECONDS, re-arms while a
  peer's checkpoint restore is live (ckpt/resume.py), and at the
  shutdown window aborts the world (NCCL: `_abort_process_group`, so no
  dangling Work poisons a later collective; gloo, whose abort waits for
  the pending operation, is bounded by the process group's timeout,
  which init sets past the window), dumps the flight recorder and
  raises HorovodInternalError naming the collective, with the
  verifier's `stall_context()`. The JAX package bounds only elastic
  waits and aborts the process otherwise; the port bounds every wait,
  since a torch collective can be waited on without blocking the
  process. The NCCL settings it relies on: outside elastic mode torch's
  defaults (TORCH_NCCL_ASYNC_ERROR_HANDLING tears the process down when
  a collective outlives the process group's timeout), with that timeout
  set by init to twice the window plus 5 s, so the watchdog's abort
  comes first; in elastic mode TORCH_NCCL_BLOCKING_WAIT=1 and
  TORCH_NCCL_ASYNC_ERROR_HANDLING=0 with the window as the timeout
  (core/topology.py), under which a timed-out `Work.wait()` also raises.
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
                                                 HorovodError,
                                                 HorovodInternalError)
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.core.process_sets import ProcessSet, global_process_set
from horovod_tpu_torch.observability import flight as _flight
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.observability import tracing as _tracing
from horovod_tpu_torch.ops import adasum, fusion
from horovod_tpu_torch.profiler import perfscope
from horovod_tpu_torch.testing import faults as _faults

# torch 2.13 renames the tensor forms to *_single and deprecates the old
# names; older builds have only the old ones.
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


# A dead peer does not always surface as a typed error: gloo raises a
# plain RuntimeError ("... Connection closed by peer ..."), NCCL's
# blocking wait one that names the timeout. Message markers classify
# those (the JAX package's list, with NCCL's words).
_COMM_FAILURE_MARKERS = (
    "connection closed by peer", "connection reset", "connection refused",
    "gloo", "all-reduce failed", "broken pipe", "socket",
    "coordination service", "heartbeat", "task is unhealthy",
    "peer is unavailable", "deadline exceeded", "nccl", "timed out",
    "communicator was aborted",
)


def is_comm_failure(e: BaseException) -> bool:
    """True if `e` looks like a transport or peer failure rather than a
    user error: the trigger for HorovodInternalError in elastic mode."""
    if isinstance(e, HorovodInternalError):
        return False  # already converted
    if isinstance(e, dist.DistError):
        return True
    msg = str(e).lower()
    return any(m in msg for m in _COMM_FAILURE_MARKERS)


def _elastic() -> bool:
    cfg = topology._state.config
    return cfg is not None and cfg.elastic


def comm_failure_guard(e: BaseException, what: str) -> None:
    """Raise HorovodInternalError from `e` where elastic mode is on and
    `e` is a transport failure; else return (the caller re-raises)."""
    if isinstance(e, Exception) and _elastic() and is_comm_failure(e):
        raise HorovodInternalError(f"{what} failed: {e}") from e


# ------------------------------------------------------ the stall watchdog

def _restore_grace_active(first_start: float, shutdown_sec: float) -> bool:
    """True while a peer's checkpoint restore should extend the stall
    deadline: the restore signal is fresh and the total wait has not used
    up shutdown + HOROVOD_CKPT_RESTORE_GRACE_MAX (ckpt/resume.py). Probed
    once per armed window; a failing probe never changes the verdict."""
    try:
        from horovod_tpu_torch.ckpt import resume as _resume
        if time.monotonic() - first_start >= \
                shutdown_sec + _resume.grace_max_seconds():
            return False
        return _resume.peer_restore_active()
    except Exception:
        return False


def _abort_world(reason: str) -> None:
    """Abort the world after a stall: NCCL's communicators are aborted
    (every group), so the stalled collective cannot complete into a later
    one; gloo's abort would wait for the pending operation, which the
    process group's timeout bounds instead. Later collectives raise."""
    try:
        if dist.is_initialized() and dist.get_backend() == "nccl":
            dist.distributed_c10d._abort_process_group()
    except Exception:
        pass
    topology.mark_aborted(reason)


class StallWatchdog:
    """A bounded wait on one collective's Work (the JAX package's
    StallWatchdog over a blocking wait): the inspector names the wait
    while it is pending; the caller's thread polls `is_completed()`,
    warns once at `warn_sec`, and at `shutdown_sec` aborts the world and
    raises HorovodInternalError naming the collective."""

    def __init__(self, inspector, warn_sec: float, shutdown_sec: float,
                 poll_interval: float = 0.002):
        self.inspector = inspector
        self.warn_sec = warn_sec
        self.shutdown_sec = shutdown_sec
        self.poll_interval = poll_interval

    def guard(self, name: str, work) -> None:
        from horovod_tpu_torch.common.hvd_logging import get_logger
        self.inspector.submit(name)
        try:
            start = first_start = time.monotonic()
            warned = False
            delay = 2e-5
            while not work.is_completed():
                age = time.monotonic() - start
                if not warned and age >= self.warn_sec:
                    warned = True
                    _mx()["stall_warn"].labels(source="watchdog").inc()
                    _flight.record(
                        "stall", f"collective '{name}' stalled for "
                        f"{age:.1f}s (warning threshold "
                        f"{self.warn_sec:.0f}s)")
                    get_logger().warning(
                        "collective '%s' stalled for %.1fs "
                        "(HOROVOD_STALL_CHECK_TIME_SECONDS=%.0f)",
                        name, age, self.warn_sec)
                if self.shutdown_sec > 0 and age >= self.shutdown_sec:
                    if _restore_grace_active(first_start,
                                             self.shutdown_sec):
                        # A peer is restoring a checkpoint: re-arm the
                        # window from now, bounded by the grace maximum.
                        start = time.monotonic()
                        _flight.record(
                            "ckpt", f"stall deadline re-armed for "
                            f"'{name}': peer checkpoint restore in "
                            f"progress (waited {start - first_start:.1f}s "
                            f"total)")
                        continue
                    self._shutdown(name)
                time.sleep(delay)
                delay = min(delay * 2, self.poll_interval)
            work.wait()  # the error of a failed one; the stream order
        finally:
            self.inspector.done(name)

    def _shutdown(self, name: str) -> None:
        stalled, _ = self.inspector.check()
        _mx()["stall_shut"].inc()
        try:
            from horovod_tpu_torch.analysis import verifier as _vf
            fp_context = _vf.stall_context()
        except Exception:
            fp_context = ""
        msg = (f"collective '{name}' stalled past "
               f"HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="
               f"{self.shutdown_sec:.0f}s"
               + (f" (outstanding: {', '.join(stalled)})" if stalled
                  else "") + fp_context)
        _abort_world(msg)
        try:
            _flight.record("stall", f"collective '{name}' stalled past "
                           f"shutdown window {self.shutdown_sec:.0f}s")
            _flight.dump("stall_watchdog")
            flight_hint = _flight.dump_hint()
        except Exception:
            flight_hint = ""
        raise HorovodInternalError(msg + flight_hint)


def guarded_wait(work, name: str) -> None:
    """Wait on a collective's Work under the stall inspector: the plain
    wait with submit/done bookkeeping, or the StallWatchdog's bounded
    wait where HOROVOD_STALL_SHUTDOWN_TIME_SECONDS > 0."""
    st = topology._state
    si = st.stall_inspector
    if si is None:
        work.wait()
        return
    cfg = st.config
    if cfg.stall_shutdown_seconds <= 0:
        si.submit(name)
        try:
            work.wait()
        finally:
            si.done(name)
        return
    StallWatchdog(si, cfg.stall_warning_seconds,
                  cfg.stall_shutdown_seconds).guard(name, work)


class Handle:
    """An in-flight collective: its Work, the tensor it writes, what
    finishes the result once the Work is done, and the name it holds;
    `label` names it to the stall watchdog, `meta` is its (op, dtype,
    bytes, tensors) for the metrics."""

    def __init__(self, work, out, finish=None, name: Optional[str] = None):
        self.work = work
        self.out = out
        self._finish = finish
        self.name = name
        self.label: Optional[str] = None
        self.meta: Optional[tuple] = None
        self._done = False

    def wait(self):
        if not self._done:
            try:
                if self.work is not None:
                    guarded_wait(self.work, self.label or self.name
                                 or "collective")
                    self.work = None
                if self._finish is not None:
                    self.out = self._finish(self.out)
            except Exception as e:
                comm_failure_guard(e, f"collective {self.name or ''}")
                raise
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


def forget_inflight_names() -> None:
    """Release every claimed name (the elastic reset: the handles of a
    world that is gone are never synchronized)."""
    with _inflight_lock:
        _inflight_names.clear()


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


# ------------------------------------------------ the dispatch choke point

def dispatch(desc: str, ps: ProcessSet, name: str = "") -> None:
    """The dispatch choke point (the JAX package's `_consistency`): one
    flight record, a tracing dispatch marker under the ambient step, the
    consistency check and the fingerprint verifier, each scoped to the
    process set's members. Runs before the collective is launched, so a
    rank that calls something else is named instead of deadlocking.
    Last comes the `collective.dispatch` fault site (testing/faults.py):
    a latency there delays this rank's launch after the checks agreed."""
    _flight.record_collective(ps.process_set_id, desc, name)
    if _tracing.active():
        _tracing.record_dispatch(desc, name)
    from horovod_tpu_torch.analysis import verifier as _vf
    from horovod_tpu_torch.core import consistency as _cc
    checker = _cc.get()
    v = _vf.get()
    if checker is not None or v is not None:
        ranks = ps.ranks  # None: the world
        if ranks is None:
            group = "world"
        else:
            import hashlib
            tag = hashlib.sha256(repr(tuple(ranks)).encode()).hexdigest()
            group = f"ps{ps.process_set_id}-{tag[:12]}"
        if checker is not None:
            checker.check(desc, ranks=ranks, group=group)
        if v is not None:
            v.record(f"{desc}|name={name}" if name else desc, ranks=ranks,
                     group=group)
    if _faults._injector is not None:
        _faults.inject("collective.dispatch", f"rank{topology.rank()}:{name}")


# The descriptors, in the JAX package's text: shapes carry the set's size
# as dim 0 (its global arrays), dtypes its str(dtype) spelling.

def _dt(t: torch.Tensor) -> str:
    return fusion.dtype_name(t.dtype)


def describe_allreduce(t: torch.Tensor, rop: T.ReduceOp, ps: ProcessSet
                       ) -> str:
    return (f"allreduce(shape={(ps.size(),) + tuple(t.shape)},"
            f"dtype={_dt(t)},op={int(rop)},ps={ps.process_set_id})")


def describe_grouped(tensors: Sequence[torch.Tensor], rop: T.ReduceOp,
                     ps: ProcessSet, kind: str = "grouped_allreduce"
                     ) -> str:
    k = ps.size()
    return (f"{kind}(n={len(tensors)},shapes="
            f"{[(k,) + tuple(t.shape) for t in tensors]},op={int(rop)},"
            f"ps={ps.process_set_id})")


def describe_bucketed(shapes: Sequence[Tuple[int, ...]], rop: T.ReduceOp,
                      thresh: int, plan, ps: ProcessSet) -> str:
    k = ps.size()
    return (f"bucketed_allreduce(n={len(shapes)},shapes="
            f"{[(k,) + tuple(s) for s in shapes]},op={int(rop)},"
            f"thresh={thresh},plan={fusion.plan_signature(plan)},"
            f"ps={ps.process_set_id})")


def describe_broadcast(t: torch.Tensor, root: int, ps: ProcessSet) -> str:
    return (f"broadcast(shape={(ps.size(),) + tuple(t.shape)},"
            f"dtype={_dt(t)},root={root},ps={ps.process_set_id})")


def describe_allgather(t: torch.Tensor, ps: ProcessSet,
                       kind: str = "allgather") -> str:
    return (f"{kind}(rest={tuple(t.shape[1:])},ndim={t.dim() + 1},"
            f"dtype={_dt(t)},ps={ps.process_set_id})")


def describe_grouped_allgather(tensors: Sequence[torch.Tensor],
                               ps: ProcessSet) -> str:
    return (f"grouped_allgather(n={len(tensors)},"
            f"rests={[tuple(t.shape[1:]) for t in tensors]},"
            f"dtypes={[_dt(t) for t in tensors]},ps={ps.process_set_id})")


def describe_reducescatter(t: torch.Tensor, rop: T.ReduceOp,
                           ps: ProcessSet) -> str:
    return (f"reducescatter(shape={(ps.size(),) + tuple(t.shape)},"
            f"dtype={_dt(t)},op={int(rop)},ps={ps.process_set_id})")


def describe_barrier(ps: ProcessSet) -> str:
    return f"barrier(ps={ps.process_set_id})"


# ------------------------------------------------------------ the metrics

_mx_cache = None
_cum_bytes: dict = {}
_cum_lock = threading.Lock()


def _mx():
    """The collectives' instrument handles, cached per registry; every
    family is the shared no-op under HOROVOD_METRICS=0."""
    global _mx_cache
    m = _metrics
    reg = m.registry()
    if _mx_cache is None or _mx_cache[0] is not reg:
        _mx_cache = (reg, {
            "calls": reg.counter(
                "horovod_collective_calls_total",
                "Eager collective calls", labelnames=("op", "dtype")),
            "bytes": reg.counter(
                "horovod_collective_bytes_total",
                "Global payload bytes moved by collectives",
                labelnames=("op", "dtype")),
            "seconds": reg.histogram(
                "horovod_collective_seconds",
                "Host-side wall time per collective call (launch for the "
                "async forms, launch and wait for the blocking ones)",
                labelnames=("op",), buckets=m.TIME_BUCKETS),
            "group": reg.histogram(
                "horovod_grouped_fusion_tensors",
                "Tensors per grouped (fused) collective call",
                labelnames=("op",), buckets=m.COUNT_BUCKETS),
            "bucket_n": reg.counter(
                "horovod_bucket_dispatch_total",
                "Fusion buckets dispatched by the pipelined allreduce"),
            "bucket_bytes": reg.histogram(
                "horovod_bucket_bytes",
                "Global payload bytes per dispatched fusion bucket",
                buckets=m.SIZE_BUCKETS),
            "bucket_secs": reg.histogram(
                "horovod_bucket_seconds",
                "Per-bucket launch-to-complete wall time (timed steps "
                "only)", buckets=m.TIME_BUCKETS),
            "overlap": reg.gauge(
                "horovod_overlap_fraction",
                "Estimated fraction of bucket in-flight time shared with "
                "another bucket (1 - wall_window / sum_of_bucket_spans; "
                "timed steps only)"),
            "axis_bytes": reg.counter(
                "horovod_axis_comms_bytes_total",
                "Eager collective payload bytes attributed to a named "
                "mesh axis (process sets built by axis_process_set)",
                labelnames=("axis", "op")),
            "stall_warn": reg.counter(
                "horovod_stall_warnings_total",
                "Stall warnings", labelnames=("source",)),
            "stall_shut": reg.counter(
                "horovod_stall_shutdowns_total",
                "Stall shutdown raises (collective watchdog)"),
        })
    return _mx_cache[1]


def _meta(h: Handle, ps: ProcessSet, tensors: Sequence[torch.Tensor],
          ntensors: Optional[int] = None) -> Handle:
    """Attach (dtype, global bytes, tensors, axis) to `h` for the metrics:
    the set's size times this rank's payload."""
    nbytes = ps.size() * sum(t.numel() * t.element_size() for t in tensors)
    h.meta = (_dt(tensors[0]) if tensors else "", nbytes, ntensors,
              getattr(ps, "mesh_axis", None))
    return h


def _record(op: str, meta: tuple, seconds: float, tl) -> None:
    dtype, nbytes, ntensors, axis = meta
    mx = _mx()
    mx["calls"].labels(op=op, dtype=dtype).inc()
    if nbytes:
        mx["bytes"].labels(op=op, dtype=dtype).inc(nbytes)
        if axis:
            mx["axis_bytes"].labels(axis=axis, op=op).inc(nbytes)
    mx["seconds"].labels(op=op).observe(seconds)
    if ntensors is not None:
        mx["group"].labels(op=op).observe(ntensors)
    if tl is not None:
        with _cum_lock:
            _cum_bytes[op] = cum = _cum_bytes.get(op, 0.0) + nbytes
        tl.counter("horovod_collective_bytes_total", {op: cum})


class _BucketStats:
    """Buckets dispatched by the hook path and the last measured overlap
    fraction (the JAX package's `_BucketStats`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.dispatched = 0  # guarded-by: _lock
        self.profiled_calls = 0  # guarded-by: _lock
        self.last_overlap: float = 0.0  # guarded-by: _lock

    def record(self, n_buckets: int, overlap=None) -> None:
        with self._lock:
            self.dispatched += n_buckets
            if overlap is not None:
                self.profiled_calls += 1
                self.last_overlap = float(overlap)

    def snapshot(self) -> Tuple[int, int, float]:
        with self._lock:
            return self.dispatched, self.profiled_calls, self.last_overlap


_bucket_stats = _BucketStats()


def record_buckets(n_buckets: int,
                   spans: Optional[Sequence[Tuple[float, float]]] = None
                   ) -> None:
    """A hook-path step's buckets: the count, and where a tuner timed
    them, their overlap and times (`horovod_overlap_fraction`,
    `horovod_bucket_seconds`)."""
    overlap = overlap_fraction(spans) if spans else None
    _bucket_stats.record(n_buckets, overlap)
    if spans and _metrics.registry().enabled:
        mx = _mx()
        for b, e in spans:
            mx["bucket_secs"].observe(e - b)
        if overlap is not None:
            mx["overlap"].set(overlap)


def bucket_overlap_stats() -> Tuple[int, int, float]:
    """(buckets_dispatched, profiled_calls, last_overlap_fraction)."""
    return _bucket_stats.snapshot()


def overlap_fraction(spans: Sequence[Tuple[float, float]]
                     ) -> Optional[float]:
    """1 - wall_window / sum of the (start, end) spans: the share of the
    buckets' in-flight time shared with another bucket."""
    total = sum(e - b for b, e in spans)
    if not spans or total <= 0:
        return None
    window = max(e for _, e in spans) - min(b for b, _ in spans)
    return max(0.0, 1.0 - window / total)


class instrument:
    """A timeline span, perfscope's `comms` attribution, the metrics and
    a tracing span around a collective's host window (the JAX package's
    `_instrument`). With no timeline, HOROVOD_PERFSCOPE=0 and
    HOROVOD_METRICS=0 it reads no clock. Nested attributions (a kernel
    build inside the window) are subtracted from the window's own by
    diffing `attributed_marker`. `meta` (set by the caller once the op is
    resolved; see `_meta`) feeds the metrics."""

    __slots__ = ("name", "activity", "tl", "ps", "timed", "t0",
                 "attr_mark", "meta", "enabled")

    def __init__(self, name: str, activity: str) -> None:
        self.name = name
        self.activity = activity
        self.meta: Optional[tuple] = None

    def __enter__(self) -> "instrument":
        self.ps = perfscope.get()
        self.tl = topology.timeline()
        if self.tl is not None:
            self.tl.span_begin(self.name, self.activity)
        self.enabled = _metrics.registry().enabled
        self.timed = self.enabled or self.ps is not perfscope.NOOP
        if self.timed:
            self.attr_mark = self.ps.attributed_marker()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.timed:
            dt = time.perf_counter() - self.t0
        if self.tl is not None:
            self.tl.span_end(self.name, self.activity)
        if self.timed:
            nested = self.ps.attributed_marker() - self.attr_mark
            self.ps.attribute("comms", dt - nested)
            if _tracing.active():
                _tracing.collective_span(
                    self.name, self.activity, dt,
                    float(self.meta[1]) if self.meta else None)
            if self.enabled and self.meta is not None and exc is None:
                _record(self.activity.lower(), self.meta, dt, self.tl)
        if exc is not None:
            comm_failure_guard(exc, f"{self.activity} {self.name}")
        return False


def _call(name: str, activity: str, start: Callable[[], Handle],
          wait: bool):
    """Start an op inside its instrumented window; with `wait`, wait for
    it there too and return its result, else return the handle."""
    with instrument(name, activity) as ins:
        h = start()
        ins.meta = h.meta
        if h.label is None:
            h.label = name
        return h.wait() if wait else h


def _resolve(process_set: Optional[ProcessSet]) -> ProcessSet:
    st = topology._require()
    if st.aborted:
        raise HorovodInternalError(
            f"the world was aborted ({st.aborted}); re-initialize before "
            f"the next collective")
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


def _into(target: torch.Tensor, h: Handle) -> Handle:
    """`h`, finishing by writing its result into `target` (a copy on the
    device unless the collective already wrote there) and giving
    `target`."""
    finish = h._finish

    def write(y):
        if finish is not None:
            y = finish(y)
        if y is not target:
            target.copy_(y)
        return target

    h._finish = write
    return h


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
    guarded_wait(_reduce_scatter_single(s, v, group=h.local_group,
                                        async_op=True),
                 "hierarchical_allreduce/local")
    if h.n_cross > 1:
        guarded_wait(dist.all_reduce(s, group=h.cross_group, async_op=True),
                     "hierarchical_allreduce/cross")
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
               process_set, inplace: bool = False) -> Handle:
    ps = _resolve(process_set)
    rop = _normalize_op(average, op)
    if tensor.is_sparse:
        def go():
            h = Handle(None, sparse_allreduce(
                tensor, rop, ps, prescale_factor, postscale_factor))
            return _into(tensor, h) if inplace else h
        return _named(name, go)
    start = _launch(rop, prescale_factor, postscale_factor, ps)
    dispatch(describe_allreduce(tensor, rop, ps), ps, name or "allreduce")
    if inplace:  # contiguous() is the tensor itself where it can be
        h = _named(name, lambda: _into(tensor, start(tensor.contiguous())))
    else:
        h = _named(name, lambda: start(tensor.clone()))
    return _meta(h, ps, [tensor])


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


def allreduce_async_(tensor: torch.Tensor, average: Optional[bool] = None,
                     name: Optional[str] = None, op=None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     process_set: Optional[ProcessSet] = None) -> Handle:
    """Start reducing `tensor` in place; synchronize gives `tensor`."""
    return _call(name or "allreduce", "ALLREDUCE", lambda: _allreduce(
        tensor, average, name, op, prescale_factor, postscale_factor,
        process_set, inplace=True), False)


def allreduce_(tensor: torch.Tensor, average: Optional[bool] = None,
               name: Optional[str] = None, op=None,
               prescale_factor: float = 1.0,
               postscale_factor: float = 1.0,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Reduce `tensor` across the set in place; returns `tensor`."""
    return _call(name or "allreduce", "ALLREDUCE", lambda: _allreduce(
        tensor, average, name, op, prescale_factor, postscale_factor,
        process_set, inplace=True), True)


def _fused(tensors, average, op, prescale, postscale, process_set,
           reverse: Optional[bool], name, inplace: bool = False) -> Handle:
    """Start a group's reduction: Adasum tensor by tensor (its dots are
    per tensor), every other op in ≤-threshold buckets, one collective
    per bucket, packed in submission order (reverse False) or backward
    production order (None: HOROVOD_BUCKET_REVERSE). `inplace` writes
    the results into `tensors` and gives that list."""
    ps = _resolve(process_set)
    rop = _normalize_op(average, op)
    start = _launch(rop, prescale, postscale, ps)
    if tensors:
        dispatch(_describe_fused(tensors, rop, ps, reverse),
                 ps, name or ("grouped_allreduce" if reverse is not None
                              else "bucketed_allreduce"))

    def go() -> Handle:
        if not tensors:
            return Handle(None, [])
        if rop == T.ReduceOp.ADASUM:
            if inplace:
                return _joined([_into(t, start(t.contiguous()))
                                for t in tensors])
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

        # In place, the buckets unpack straight into the caller's
        # contiguous tensors; the others take a copy at the end.
        outs = [t if t.is_contiguous() else torch.empty_like(
            t, memory_format=torch.contiguous_format) for t in tensors] \
            if inplace else None
        finish = fusion.fused_launch(list(tensors), launch, thresh,
                                     reverse=rev, outs=outs)
        if not inplace:
            return Handle(None, None, lambda _: finish())

        def write(_):
            for t, o in zip(tensors, finish()):
                if o is not t:
                    t.copy_(o)
            return list(tensors)

        return Handle(None, None, write)

    return _meta(_named(name, go), ps, tensors, len(tensors))


def _describe_fused(tensors, rop: T.ReduceOp, ps: ProcessSet,
                    reverse: Optional[bool]) -> str:
    """A grouped call's descriptor; a bucketed one (reverse None) names
    its threshold and plan, unless it is one the JAX package sends as a
    grouped call (one tensor, Adasum, the hierarchical path)."""
    cfg = topology.config()
    hier = _hier_for(ps, cfg.hierarchical_allreduce) \
        if rop in (T.ReduceOp.SUM, T.ReduceOp.AVERAGE) else None
    if reverse is not None or len(tensors) == 1 \
            or rop == T.ReduceOp.ADASUM or hier is not None:
        return describe_grouped(tensors, rop, ps)
    thresh = fusion.effective_threshold(cfg.fusion_threshold_bytes,
                                        cfg.bucket_cap_bytes)
    plan = fusion.plan_buckets([(tuple(t.shape), t.dtype) for t in tensors],
                               thresh, reverse=cfg.bucket_reverse)
    return describe_bucketed([tuple(t.shape) for t in tensors], rop, thresh,
                             plan, ps)


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


def grouped_allreduce_async_(tensors: Sequence[torch.Tensor],
                             average: Optional[bool] = None,
                             name: Optional[str] = None, op=None,
                             prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0,
                             process_set: Optional[ProcessSet] = None
                             ) -> Handle:
    """Start grouped_allreduce_; synchronize gives the list `tensors`,
    each holding its result."""
    return _call(name or "grouped_allreduce", "ALLREDUCE", lambda: _fused(
        tensors, average, op, prescale_factor, postscale_factor,
        process_set, False, name, inplace=True), False)


def grouped_allreduce_(tensors: Sequence[torch.Tensor],
                       average: Optional[bool] = None,
                       name: Optional[str] = None, op=None,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       process_set: Optional[ProcessSet] = None
                       ) -> List[torch.Tensor]:
    """grouped_allreduce written into `tensors`; returns that list."""
    return _call(name or "grouped_allreduce", "ALLREDUCE", lambda: _fused(
        tensors, average, op, prescale_factor, postscale_factor,
        process_set, False, name, inplace=True), True)


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
        """(wire bytes, seconds) per bucket, in launch order; resets.
        `spans` then holds each bucket's (start, end) in seconds."""
        out = []
        self.spans: List[Tuple[float, float]] = []
        for nbytes, t0, t1 in self._recs:
            if self._cuda:
                t1.synchronize()
                base = self._recs[0][1]
                b = base.elapsed_time(t0) / 1e3
                e = base.elapsed_time(t1) / 1e3
            elif t1 is not None:
                b, e = t0, t1
            else:
                continue
            out.append((nbytes, e - b))
            self.spans.append((b, e))
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
    guarded_wait(_all_gather_single(rows, mine, group=ps.group,
                                    async_op=True), "size_exchange")
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
        guarded_wait(_all_gather_single(g1, x, group=hier.local_group,
                                        async_op=True),
                     "hierarchical_allgather/local")
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
    dispatch(describe_allgather(tensor, ps), ps, name or "allgather")

    def go() -> Handle:
        sizes = [r[0] for r in _exchange_rows([tensor.shape[0]], ps)]
        return _gather_start(tensor, sizes, ps)

    return _meta(_named(name, go), ps, [tensor])


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


def _grouped_allgather(tensors, name, process_set) -> Handle:
    ps = _resolve(process_set)
    for t in tensors:
        _check_dims(t, "allgather")
    if tensors:
        dispatch(describe_grouped_allgather(tensors, ps), ps,
                 name or "grouped_allgather")

    def go() -> Handle:
        if not tensors:
            return Handle(None, [])
        rows = _exchange_rows([t.shape[0] for t in tensors], ps)
        return _joined([_gather_start(t, [r[i] for r in rows], ps)
                        for i, t in enumerate(tensors)])

    return _meta(_named(name, go), ps, tensors, len(tensors))


def grouped_allgather_async(tensors: Sequence[torch.Tensor],
                            name: Optional[str] = None,
                            process_set: Optional[ProcessSet] = None
                            ) -> Handle:
    """Start grouped_allgather; one handle for the group, which gives the
    list of results."""
    return _call(name or "grouped_allgather", "ALLGATHER",
                 lambda: _grouped_allgather(tensors, name, process_set),
                 False)


def grouped_allgather(tensors: Sequence[torch.Tensor],
                      name: Optional[str] = None,
                      process_set: Optional[ProcessSet] = None
                      ) -> List[torch.Tensor]:
    """allgather of each tensor, with one size exchange for the group;
    every gather is in flight before the first is waited on."""
    return _call(name or "grouped_allgather", "ALLGATHER",
                 lambda: _grouped_allgather(tensors, name, process_set),
                 True)


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
    _check_dims(tensor, "reducescatter")
    dispatch(describe_reducescatter(tensor, rop, ps), ps,
             name or "reducescatter")
    return _meta(_named(name, lambda: _rs_start(
        tensor, rop, prescale_factor, postscale_factor, ps)), ps, [tensor])


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


def _grouped_rs(tensors, op, name, prescale_factor, postscale_factor,
                process_set) -> Handle:
    ps = _resolve(process_set)
    rop = _rs_op(op)
    if tensors:
        dispatch(describe_grouped(tensors, rop, ps, "grouped_reducescatter"),
                 ps, name or "grouped_reducescatter")
    return _meta(_named(name, lambda: _joined([
        _rs_start(t, rop, prescale_factor, postscale_factor, ps)
        for t in tensors])), ps, tensors, len(tensors))


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor],
                                op=T.ReduceOp.AVERAGE,
                                name: Optional[str] = None,
                                prescale_factor: float = 1.0,
                                postscale_factor: float = 1.0,
                                process_set: Optional[ProcessSet] = None
                                ) -> Handle:
    """Start grouped_reducescatter; one handle for the group, which gives
    the list of results."""
    return _call(name or "grouped_reducescatter", "REDUCESCATTER",
                 lambda: _grouped_rs(tensors, op, name, prescale_factor,
                                     postscale_factor, process_set), False)


def grouped_reducescatter(tensors: Sequence[torch.Tensor],
                          op=T.ReduceOp.AVERAGE,
                          name: Optional[str] = None,
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          process_set: Optional[ProcessSet] = None
                          ) -> List[torch.Tensor]:
    """reducescatter of each tensor, all in flight before the first is
    waited on."""
    return _call(name or "grouped_reducescatter", "REDUCESCATTER",
                 lambda: _grouped_rs(tensors, op, name, prescale_factor,
                                     postscale_factor, process_set), True)


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
    dispatch(describe_allgather(tensor, ps, "alltoall"), ps,
             name or "alltoall")

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

    return _meta(_named(name, go), ps, [tensor])


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

def _broadcast(tensor, root_rank, name, process_set,
               inplace: bool = False) -> Handle:
    ps = _resolve(process_set)
    root = ps.rank_index(root_rank)  # the root must be a member
    dispatch(describe_broadcast(tensor, root, ps), ps, name or "broadcast")

    def go() -> Handle:
        out = tensor.contiguous() if inplace else tensor.clone()
        h = Handle(dist.broadcast(out, src=root_rank, group=ps.group,
                                  async_op=True), out)
        return _into(tensor, h) if inplace else h

    return _meta(_named(name, go), ps, [tensor])


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


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> Handle:
    """Start broadcasting the root's tensor into `tensor` on every member;
    synchronize gives `tensor`."""
    return _call(name or "broadcast", "BROADCAST", lambda: _broadcast(
        tensor, root_rank, name, process_set, inplace=True), False)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """In-place broadcast of `tensor` from the root rank (a global rank,
    a member of the set); returns `tensor`."""
    return _call(name or "broadcast", "BROADCAST", lambda: _broadcast(
        tensor, root_rank, name, process_set, inplace=True), True)


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Block until every member reaches the barrier: a one-element
    all-reduce on the collective's device, read back."""
    ps = _resolve(process_set)
    with instrument("barrier", "BARRIER"):
        dispatch(describe_barrier(ps), ps)
        one = torch.ones(1, dtype=torch.int32, device=topology.device())
        guarded_wait(dist.all_reduce(one, group=ps.group, async_op=True),
                     "barrier")
        one.item()


def synchronize(handle: Handle):
    """Wait for an async collective and return its result."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """True once the collective behind `handle` has completed."""
    return handle.work is None or handle.work.is_completed()
