"""hvdtrace: causal distributed tracing, HOROVOD_TRACE (counterpart of
horovod_tpu/observability/tracing.py; the span records are the JAX
package's).

* A span model (``trace_id`` / ``span_id`` / parent) propagated in
  process through a ``contextvars.ContextVar`` and across processes as
  a small dict (`current_context`, `adopt`).
* A bounded store of completed trace fragments (one append per finished
  span under a short lock).
* Head sampling (``HOROVOD_TRACE_SAMPLE``) plus tail-based always-keep:
  error, timeout and requeued fragments and the N slowest roots survive
  ring eviction.
* KV-tail persistence on the metrics exporter's cadence (scope
  ``trace``, keyed ``rank-<r>.r<round>``), persisted by the launchers at
  the job's end (`persist_kv_spans`), and an atexit dump to
  ``HOROVOD_FLIGHT_DIR`` (``trace-<rank|pid>[.rN].json``).

The training plane gets a ``train.step`` root span per perfscope step
(`step_begin`/`step_end`), with a child span per collective from the
collectives' instrumented windows (`collective_span`) and a dispatch
marker from their choke point (`record_dispatch`). The step's span is
kept per process, not per thread: on a card the gradient hooks launch
their buckets on autograd's device thread. The serving plane records
its spans here too: serve/frontend.py opens a `serve.request` root per
request from the client's context (`request_context`, `record_span`)
and serve/engine.py an `engine.execute` child per batch; hvddoctor
(observability/doctor.py `--trace`) merges the dumps into one
timeline.

Knobs: ``HOROVOD_TRACE=0`` swaps the tracer for a no-op shell;
``HOROVOD_TRACE_SAMPLE`` is the head sampling probability;
``HOROVOD_TRACE_CAPACITY`` bounds retained fragments;
``HOROVOD_TRACE_KV_TAIL`` bounds spans per pushed tail;
``HOROVOD_TRACE_SLOW_KEEP`` sizes the slowest-roots keep set.
"""

from __future__ import annotations

import atexit
import contextvars
import heapq
import json
import os
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from horovod_tpu_torch.common.config import _env_on

TRACE_ENV = "HOROVOD_TRACE"
TRACE_SAMPLE_ENV = "HOROVOD_TRACE_SAMPLE"
TRACE_CAPACITY_ENV = "HOROVOD_TRACE_CAPACITY"
TRACE_KV_TAIL_ENV = "HOROVOD_TRACE_KV_TAIL"
TRACE_SLOW_KEEP_ENV = "HOROVOD_TRACE_SLOW_KEEP"

#: Dumps land next to the flight dumps — one evidence directory.
DIR_ENV = "HOROVOD_FLIGHT_DIR"

#: Rendezvous-KV scope the compact span tails are pushed under.
SCOPE = "trace"

#: Schema tag in every dump/tail so the doctor can reject fragments it
#: does not understand instead of mis-merging them.
TRACE_VERSION = 1

DEFAULT_SAMPLE = 1.0
DEFAULT_CAPACITY = 256
DEFAULT_KV_TAIL = 96
DEFAULT_SLOW_KEEP = 8

#: Per-trace span bound: a runaway loop inside one sampled step must
#: not evict every other fragment's evidence.
MAX_SPANS_PER_TRACE = 256

#: Wire keys of the cross-process context dict (one byte each — the
#: dict rides every traced RPC frame).
CTX_TRACE = "t"   # trace id
CTX_SPAN = "s"    # the sender's span id (the receiver's parent)
CTX_LINKS = "l"   # extra trace ids sharing a batch-execution span

#: The ambient (trace_id, span_id) parent for this execution context.
_ctx_var: contextvars.ContextVar = \
    contextvars.ContextVar("hvdtrace_ctx", default=None)

#: The in-flight training step's span and its (trace_id, span_id): one
#: per process, as perfscope keeps one in-flight step per scope. On a
#: card autograd runs the gradient hooks, and so the bucket launches, on
#: its own device thread, where no context variable of the training
#: thread is visible; the collective choke points fall back to this.
_step_span = None
_step_ctx: Optional[Tuple[str, str]] = None


def _ambient() -> Optional[Tuple[str, str]]:
    return _ctx_var.get() or _step_ctx

# Reentrancy guard (flight convention): the KV tail push goes through
# KVClient whose instrumentation must not trace its own flush traffic.
_tls = threading.local()


def suppressed() -> bool:
    """True while this thread is inside a dump/push — instrumentation
    hooks must not trace their own flush traffic."""
    return getattr(_tls, "busy", False)


class _Suppress:
    def __enter__(self):
        _tls.busy = True
        return self

    def __exit__(self, *exc):
        _tls.busy = False
        return False


def _new_id() -> str:
    return f"{random.getrandbits(64):016x}"


class _NoopSpan:
    """Shared do-nothing span (disabled tracer / unsampled trace)."""

    __slots__ = ()

    trace_id = ""
    span_id = ""

    def context(self) -> Optional[Dict[str, str]]:
        return None

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def end(self, status: str = "ok", **attrs: Any) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """One live in-process span. Begin/end must happen on the same
    thread when `activate` was used (the contextvar token is reset at
    end); cross-thread lifecycles (serving requests) use the
    retroactive ``Tracer.add_span`` instead and never hold a Span."""

    __slots__ = ("_tracer", "trace_id", "span_id", "parent_id", "name",
                 "t0", "attrs", "root", "_token", "_ended")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, t0: float,
                 attrs: Dict[str, Any], root: bool, token) -> None:
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.attrs = attrs
        self.root = root
        self._token = token
        self._ended = False

    def context(self) -> Dict[str, str]:
        """The small dict that rides a frame/RPC to name this span as
        the remote side's parent."""
        return {CTX_TRACE: self.trace_id, CTX_SPAN: self.span_id}

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def end(self, status: str = "ok", **attrs: Any) -> None:
        if self._ended:
            return
        self._ended = True
        if attrs:
            self.attrs.update(attrs)
        if self._token is not None:
            try:
                _ctx_var.reset(self._token)
            except ValueError:
                _ctx_var.set(None)
        self._tracer._span_finished(
            {"tid": self.trace_id, "sid": self.span_id,
             "psid": self.parent_id, "name": self.name, "t0": self.t0,
             "dur": max(0.0, self._tracer._wall() - self.t0),
             "status": status, "attrs": self.attrs},
            root=self.root)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is not None:
            self.end("error", error=f"{et.__name__}: {ev}")
        else:
            self.end("ok")
        return False


class Tracer:
    """Bounded per-process store of trace fragments (see module
    docstring).

    Span finish is the hot path: one dict append and counter bumps
    under a short lock (HVD103: nothing slow runs under it). A
    "fragment" is the set of spans one process recorded for one
    trace_id; the doctor joins fragments across processes. A fragment
    completes when its *local root* span ends — the span the recording
    process owns the retention decision for (the client request span,
    the frontend request span, the replica batch span, the train step
    span) — at which point the tail-keep rules run.

    `clock` is injectable for the fake-clock unit tests (defaults to
    wall time so cross-process spans align on one axis).
    """

    def __init__(self, capacity: Optional[int] = None,
                 kv_tail: Optional[int] = None,
                 sample: Optional[float] = None,
                 slow_keep: Optional[int] = None,
                 clock=None) -> None:
        def _int_env(env: str, dflt: int) -> int:
            try:
                return int(os.environ.get(env, "") or dflt)
            except ValueError:
                return dflt
        if capacity is None:
            capacity = _int_env(TRACE_CAPACITY_ENV, DEFAULT_CAPACITY)
        if kv_tail is None:
            kv_tail = _int_env(TRACE_KV_TAIL_ENV, DEFAULT_KV_TAIL)
        if slow_keep is None:
            slow_keep = _int_env(TRACE_SLOW_KEEP_ENV, DEFAULT_SLOW_KEEP)
        if sample is None:
            try:
                sample = float(os.environ.get(TRACE_SAMPLE_ENV, "")
                               or DEFAULT_SAMPLE)
            except ValueError:
                sample = DEFAULT_SAMPLE
        self.capacity = max(8, capacity)
        self.kv_tail = max(8, kv_tail)
        self.slow_keep = max(0, slow_keep)
        self.sample = min(1.0, max(0.0, sample))
        self._wall = clock or time.time
        self._lock = threading.Lock()
        # tid -> {"tid", "spans": [...], "done", "dur", "kept"},
        # insertion-ordered for FIFO eviction.  guarded-by: _lock
        self._traces: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        # (dur, tid) min-heap of the slowest completed local roots;
        # stale entries are tolerated (checked against _traces on
        # demotion).  guarded-by: _lock
        self._slow: List[Tuple[float, str]] = []
        self._started = 0  # guarded-by: _lock
        self._finished = 0  # guarded-by: _lock
        self._unsampled = 0  # guarded-by: _lock
        self._spans = 0  # guarded-by: _lock
        self._evicted = 0  # guarded-by: _lock
        self._kv = None
        self._kv_dead = False

    # --------------------------------------------------------- sampling
    def _sampled(self) -> bool:
        r = self.sample
        return r >= 1.0 or (r > 0.0 and random.random() < r)

    # ------------------------------------------------------- live spans
    def start_span(self, name: str, parent: Any = None,
                   root: bool = False, new: bool = False,
                   activate: bool = True,
                   attrs: Optional[Dict[str, Any]] = None):
        """Begin a live span.

        `parent` is an explicit context (the dict off a frame, a
        (tid, sid) tuple, or a Span); None falls back to the thread's
        ambient context. `new=True` ignores both and head-samples a
        fresh trace (the per-step training root). `root` marks this
        span as the fragment's local root — its `end` runs the
        retention decision. Returns NOOP_SPAN when the trace is
        unsampled."""
        if new:
            ctx = None
        else:
            ctx = parent if parent is not None else _ctx_var.get()
        trace_id = parent_id = None
        if isinstance(ctx, Span):
            trace_id, parent_id = ctx.trace_id, ctx.span_id
        elif isinstance(ctx, dict):
            trace_id = ctx.get(CTX_TRACE)
            parent_id = ctx.get(CTX_SPAN)
        elif isinstance(ctx, tuple) and len(ctx) == 2:
            trace_id, parent_id = ctx
        if not trace_id:
            if not self._sampled():
                with self._lock:
                    self._unsampled += 1
                return NOOP_SPAN
            trace_id, parent_id, root = _new_id(), None, True
            with self._lock:
                self._started += 1
        sid = _new_id()
        token = _ctx_var.set((trace_id, sid)) if activate else None
        return Span(self, trace_id, sid, parent_id, name, self._wall(),
                    dict(attrs or {}), root, token)

    # ------------------------------------------------ retroactive spans
    def add_span(self, name: str, t0: float, dur: float, trace_id: str,
                 span_id: Optional[str] = None,
                 parent_id: Optional[str] = None, status: str = "ok",
                 attrs: Optional[Dict[str, Any]] = None,
                 root: bool = False) -> str:
        """Record an already-measured span (the serving plane: request
        lifecycles cross threads, so stamps are collected on the
        Request and turned into spans at completion). `span_id` may be
        pre-allocated (``request_context``) so children recorded
        earlier already parent on it."""
        sid = span_id or _new_id()
        self._span_finished(
            {"tid": trace_id, "sid": sid, "psid": parent_id,
             "name": name, "t0": t0, "dur": max(0.0, dur),
             "status": status, "attrs": dict(attrs or {})},
            root=root)
        return sid

    def request_context(self, incoming: Any = None
                        ) -> Optional[Dict[str, str]]:
        """Admission-time context for one serving request: adopt the
        client's context when one rode the RPC, head-sample a fresh
        trace otherwise. The returned dict's "s" is the request span's
        own pre-allocated id — children (queue, dispatch) parent on it
        and the retroactive serve.request span claims it at
        completion; "p" is the client's span id when known."""
        trace_id = parent = None
        if isinstance(incoming, dict) and incoming.get(CTX_TRACE):
            trace_id = str(incoming[CTX_TRACE])
            parent = incoming.get(CTX_SPAN)
        if trace_id is None:
            if not self._sampled():
                with self._lock:
                    self._unsampled += 1
                return None
            trace_id = _new_id()
        with self._lock:
            self._started += 1
        out = {CTX_TRACE: trace_id, CTX_SPAN: _new_id()}
        if parent:
            out["p"] = str(parent)
        return out

    # ---------------------------------------------------- span storage
    def _span_finished(self, rec: Dict[str, Any], root: bool) -> None:
        tid = rec["tid"]
        with self._lock:
            tr = self._traces.get(tid)
            if tr is None:
                tr = {"tid": tid, "spans": [], "done": False,
                      "dur": None, "kept": None}
                self._traces[tid] = tr
            if len(tr["spans"]) < MAX_SPANS_PER_TRACE:
                tr["spans"].append(rec)
                self._spans += 1
            if root:
                tr["done"] = True
                tr["dur"] = max(tr["dur"] or 0.0, rec["dur"])
                self._finished += 1
                kept = self._keep_reason_locked(tr, rec)
                if kept and not tr["kept"]:
                    tr["kept"] = kept
            self._evict_locked()

    def _keep_reason_locked(self, tr: Dict[str, Any],
                            root_rec: Dict[str, Any]) -> Optional[str]:
        """Tail-based always-keep: why this completed fragment is
        pinned against eviction (None = evictable)."""
        if root_rec["status"] != "ok":
            return root_rec["status"]  # "error" / "timeout"
        try:
            if int(root_rec["attrs"].get("requeues", 0) or 0) > 0:
                return "requeued"
        except (TypeError, ValueError):
            pass
        if any(sp["status"] != "ok" for sp in tr["spans"]):
            return "error"
        if self.slow_keep <= 0:
            return None
        dur = root_rec["dur"]
        if len(self._slow) < self.slow_keep:
            heapq.heappush(self._slow, (dur, tr["tid"]))
            return "slow"
        if dur > self._slow[0][0]:
            _, old = heapq.heapreplace(self._slow, (dur, tr["tid"]))
            otr = self._traces.get(old)
            if otr is not None and otr.get("kept") == "slow":
                otr["kept"] = None  # demoted: evictable again
            return "slow"
        return None

    def _evict_locked(self) -> None:
        while len(self._traces) > self.capacity:
            victim = None
            for k, v in self._traces.items():
                if not v.get("kept"):
                    victim = k
                    break
            if victim is None:
                # every fragment is kept: FIFO even the kept ones —
                # bounded memory beats perfect retention
                victim = next(iter(self._traces))
            self._traces.pop(victim)
            self._evicted += 1  # hvdlint: disable=HVD101 -- _evict_locked is only called from _span_finished inside the `with self._lock` critical section

    # --------------------------------------------------------- snapshot
    def snapshot(self) -> List[Dict[str, Any]]:
        """Retained fragments, oldest first (copies — safe to mutate)."""
        with self._lock:
            return [{"tid": t["tid"], "done": t["done"], "dur": t["dur"],
                     "kept": t["kept"], "spans": list(t["spans"])}
                    for t in self._traces.values()]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"started": self._started,
                    "finished": self._finished,
                    "unsampled": self._unsampled,
                    "spans": self._spans,
                    "evicted": self._evicted}

    # ------------------------------------------------------------ dump
    def _identity(self) -> Dict[str, Any]:
        rank = size = None
        try:
            from horovod_tpu_torch.core import topology
            rank = topology.rank_or_none()
            st = topology.raw_state()
            size = st.size if st.initialized else None
        except Exception:
            pass
        if rank is None:
            v = os.environ.get("HOROVOD_RANK", "")
            rank = int(v) if v.strip().isdigit() else None
        if size is None:
            v = os.environ.get("HOROVOD_SIZE", "")
            size = int(v) if v.strip().isdigit() else None
        v = os.environ.get("HOROVOD_ELASTIC_ROUND", "")
        return {"rank": rank, "size": size,
                "round": int(v) if v.strip().isdigit() else 0,
                "hostname": os.environ.get("HOROVOD_HOSTNAME", ""),
                "pid": os.getpid()}

    def payload(self, tail_spans: Optional[int] = None
                ) -> Dict[str, Any]:
        """The serializable fragment set: identity + retained traces
        (kept fragments always included; with `tail_spans` the rest are
        newest-first within the span budget — the KV tail shape)."""
        body = self._identity()
        traces = self.snapshot()
        stats = self.stats()
        if tail_spans is not None:
            keep = [t for t in traces if t.get("kept")]
            rest = [t for t in traces if not t.get("kept")]
            budget = tail_spans - sum(len(t["spans"]) for t in keep)
            picked: List[Dict[str, Any]] = []
            for t in reversed(rest):
                n = len(t["spans"])
                if n <= budget:
                    picked.append(t)
                    budget -= n
                if budget <= 0:
                    break
            traces = keep + list(reversed(picked))
        body.update({"version": TRACE_VERSION, "wall_time": time.time(),
                     "stats": stats, "traces": traces})
        return body

    def dump(self, trigger: str, push_kv: bool = True) -> Optional[str]:
        """Atomic local dump to HOROVOD_FLIGHT_DIR (when set) as
        ``trace-<rank|pid>[.r<round>].json``, plus a best-effort KV
        tail push. Never raises (flight convention: dumps ride exit
        paths that must stay failable)."""
        if suppressed():
            return None
        with _Suppress():
            path = None
            d = os.environ.get(DIR_ENV, "")
            if d:
                body = self.payload()
                body["trigger"] = trigger
                ident = body.get("rank")
                stem = f"{ident if ident is not None else os.getpid()}"
                if body.get("round"):
                    stem += f".r{body['round']}"
                path = os.path.join(d, f"trace-{stem}.json")
                try:
                    os.makedirs(d, exist_ok=True)
                    tmp = f"{path}.tmp.{os.getpid()}"
                    with open(tmp, "w") as f:
                        json.dump(body, f)
                    os.replace(tmp, path)
                except OSError:
                    path = None
            if push_kv:
                self._push_tail_locked_out()
            return path

    # ---------------------------------------------------------- KV tail
    def _kv_client(self):
        if self._kv is None and not self._kv_dead:
            try:
                from horovod_tpu_torch.common import config as C
                from horovod_tpu_torch.common.resilience import RetryPolicy
                from horovod_tpu_torch.runner.rendezvous import KVClient
                addr = os.environ.get(C.HOROVOD_RENDEZVOUS_ADDR, "")
                port = os.environ.get(C.HOROVOD_RENDEZVOUS_PORT, "")
                if not addr or not port:
                    self._kv_dead = True
                    return None
                # Telemetry budget (flight convention): one attempt,
                # 2 s transport cap — a missed push is superseded by
                # the next exporter tick.
                self._kv = KVClient(
                    addr, int(port),
                    retry_policy=RetryPolicy(max_attempts=1),
                    request_timeout=2.0)
            except Exception:
                self._kv_dead = True
        return self._kv

    def _push_tail_locked_out(self) -> bool:
        kv = self._kv_client()
        if kv is None:
            return False
        body = self.payload(tail_spans=self.kv_tail)
        if body.get("rank") is None:
            return False  # mid-reset: an unkeyable tail would linger
        if not body["traces"]:
            return False
        # Keyed by (rank, round) like the flight tails: elastic resets
        # REUSE rank numbers, and a survivor's next-round tail must not
        # clobber a dead rank's last evidence.
        try:
            kv.put(SCOPE, f"rank-{body['rank']}.r{body['round']}",
                   json.dumps(body).encode("utf-8"))
            return True
        except Exception:
            return False

    def push_tail(self) -> bool:
        """Best-effort compact-tail push (exporter cadence + replica
        heartbeat). Returns True when the put landed."""
        if suppressed():
            return False
        with _Suppress():
            return self._push_tail_locked_out()


class _NoopTracer:
    """HOROVOD_TRACE=0 shell: every hook is a cheap no-op."""

    capacity = 0
    sample = 0.0

    def start_span(self, name, parent=None, root=False, new=False,
                   activate=True, attrs=None):
        return NOOP_SPAN

    def add_span(self, name, t0, dur, trace_id, span_id=None,
                 parent_id=None, status="ok", attrs=None,
                 root=False) -> str:
        return ""

    def request_context(self, incoming=None):
        return None

    def snapshot(self) -> List[Dict[str, Any]]:
        return []

    def stats(self) -> Dict[str, int]:
        return {"started": 0, "finished": 0, "unsampled": 0,
                "spans": 0, "evicted": 0}

    def payload(self, tail_spans=None) -> Dict[str, Any]:
        return {}

    def dump(self, trigger: str, push_kv: bool = True) -> Optional[str]:
        return None

    def push_tail(self) -> bool:
        return False


NOOP = _NoopTracer()

_tracer: Optional[object] = None
_tracer_lock = threading.Lock()
_atexit_installed = False


def enabled() -> bool:
    return _env_on(TRACE_ENV, True)


def _install_atexit() -> None:
    global _atexit_installed
    if _atexit_installed:
        return
    _atexit_installed = True

    def _atexit_dump() -> None:
        t = _tracer
        if isinstance(t, Tracer) and os.environ.get(DIR_ENV, ""):
            # No KV push at exit (flight convention): the rendezvous
            # server may already be gone and the 2 s transport cap
            # would tax every clean exit.
            t.dump("atexit", push_kv=False)

    atexit.register(_atexit_dump)


def get():
    """The process-wide tracer (NOOP shell under HOROVOD_TRACE=0)."""
    global _tracer
    t = _tracer
    if t is not None:
        return t
    with _tracer_lock:
        if _tracer is None:
            if not enabled():
                _tracer = NOOP
            else:
                _install_atexit()
                _tracer = Tracer()
        return _tracer


def reset_for_tests() -> None:
    """Drop the process-wide tracer so the next get() re-reads env.
    Also clears this thread's ambient context and step span."""
    global _tracer
    global _step_span, _step_ctx
    with _tracer_lock:
        _tracer = None
    _ctx_var.set(None)
    _step_span = _step_ctx = None


# ------------------------------------------------------------- context

def current_context() -> Optional[Dict[str, str]]:
    """The ambient context as an injectable dict (None when no sampled
    trace is live on this thread) — what ``_send_frame`` rides on the
    wire."""
    cur = _ctx_var.get()
    if cur is None:
        return None
    return {CTX_TRACE: cur[0], CTX_SPAN: cur[1]}


def active() -> bool:
    """Cheap hot-path gate: is a sampled trace live on this thread?
    The collectives choke points check this before building any span
    attributes."""
    return _ambient() is not None and not suppressed()


def adopt(ctx: Any):
    """Install a remote context as this thread's ambient parent
    (``_recv_frame`` on a wrapped frame; the replica's batch handler).
    Returns a token for ``clear``; None when `ctx` is not a context."""
    if not isinstance(ctx, dict) or not ctx.get(CTX_TRACE):
        return None
    if get() is NOOP:
        return None
    return _ctx_var.set((str(ctx[CTX_TRACE]),
                         str(ctx.get(CTX_SPAN) or "")))


def clear(token=None) -> None:
    """Drop this thread's ambient context (server loops call this after
    each handled request so a traced request cannot leak its context
    into the next one on the same connection)."""
    if token is not None:
        try:
            _ctx_var.reset(token)
            return
        except ValueError:
            pass
    _ctx_var.set(None)


# --------------------------------------------------------- module hooks

def span(name: str, attrs: Optional[Dict[str, Any]] = None):
    """Ambient-child live span: a child of this thread's current
    context, NOOP when none is live (an untraced engine warmup call
    records nothing)."""
    if _ctx_var.get() is None or suppressed():
        return NOOP_SPAN
    return get().start_span(name, attrs=attrs)


def start_trace(name: str, attrs: Optional[Dict[str, Any]] = None):
    """Head-sampled fresh root span (the client side of a serving
    request; ad-hoc tracing). Not activated: callers inject
    ``.context()`` explicitly."""
    t = get()
    if t is NOOP:
        return NOOP_SPAN
    return t.start_span(name, new=True, root=True, activate=False,
                        attrs=attrs)


def collective_span(name: str, activity: str, dur: float,
                    nbytes: Optional[float] = None) -> None:
    """Per-collective child span from the ``_instrument`` choke point
    (ops/collectives.py): called with the measured duration after the
    dispatch returned. No-op unless a sampled trace is ambient."""
    cur = _ambient()
    if cur is None or suppressed():
        return
    t = get()
    if t is NOOP:
        return
    attrs: Dict[str, Any] = {"activity": activity}
    if nbytes:
        attrs["nbytes"] = nbytes
    t.add_span(f"collective.{name or activity}", time.time() - dur, dur,
               trace_id=cur[0], parent_id=cur[1], attrs=attrs)


def record_dispatch(desc: str, name: str) -> None:
    """Instant dispatch marker from the ``_consistency`` choke point —
    the ordering record for collectives whose duration the host cannot
    see (compiled-path dispatches). No-op unless a sampled trace is
    ambient."""
    cur = _ambient()
    if cur is None or suppressed():
        return
    t = get()
    if t is NOOP:
        return
    t.add_span("dispatch", time.time(), 0.0, trace_id=cur[0],
               parent_id=cur[1],
               attrs={"desc": desc[:160], "op": name})


# ------------------------------------------------------- training plane

def step_begin() -> None:
    """perfscope hook: open the per-step root span (head-sampled, fresh
    trace per step). It is not made the training thread's ambient
    context: the collective choke points find it through `_ambient`
    from any thread, the autograd device thread's hook launches
    included."""
    global _step_span, _step_ctx
    t = get()
    if t is NOOP or suppressed() or _step_span is not None:
        return
    if _ctx_var.get() is not None:
        # An ambient trace already covers this step: a fresh train.step
        # trace here would clobber it.
        return
    sp = t.start_span("train.step", new=True, root=True, activate=False)
    _step_span = sp
    if sp is not NOOP_SPAN:
        _step_ctx = (sp.trace_id, sp.span_id)


def step_end(status: str = "ok") -> None:
    """perfscope hook: close the per-step span (step boundary, explicit
    step end, or a scope reset abandoning the step)."""
    global _step_span, _step_ctx
    sp = _step_span
    if sp is None:
        return
    _step_span = _step_ctx = None
    sp.end(status)


# ---------------------------------------------------------- KV persist

def push_tail() -> bool:
    """Exporter-cadence KV push (observability/export.py)."""
    return get().push_tail()


def dump(trigger: str, push_kv: bool = True) -> Optional[str]:
    return get().dump(trigger, push_kv=push_kv)


def persist_kv_spans(store, out_dir: Optional[str] = None) -> List[str]:
    """Launcher-side: write every pushed ``trace/`` tail the rendezvous
    server holds to `out_dir` (default HOROVOD_FLIGHT_DIR, next to the
    flight tails) as ``trace-kv-<key>.json``, so span fragments from
    SIGKILL'd workers survive the server's shutdown and the doctor can
    join them offline."""
    out_dir = out_dir or os.environ.get(DIR_ENV, "")
    if not out_dir:
        return []
    try:
        items = store.scope_items(SCOPE)
    except Exception:
        return []
    written: List[str] = []
    for key, raw in sorted(items.items()):
        safe = key.replace("/", "_")
        path = os.path.join(out_dir, f"trace-kv-{safe}.json")
        try:
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(raw)
            os.replace(tmp, path)
            written.append(path)
        except OSError:
            continue
    return written
