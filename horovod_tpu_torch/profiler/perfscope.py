"""perfscope: the always-on step-phase profiler (counterpart of
horovod_tpu/profiler/perfscope.py).

Every training step's wall time is split into phases, and a rolling
per-rank summary answers "where does a step go": `hvd.perfscope()`
reads it in process, and each rank pushes it to the rendezvous KV
(scope ``perf``), from where the launcher persists it into
HOROVOD_FLIGHT_DIR at the job's end.

Phases
------

``input_wait``      the host blocked on the next batch (DeviceFeed, or a
                    user's ``phase("input_wait")``)
``compile``         the first-use nvcc build of the CUDA kernels
                    (kernels/__init__.py)
``dispatch``        host-side Python and kernel launches: the
                    unattributed remainder of a step (the base phase)
``device_compute``  the host blocked on device results (user-marked)
``comms``           eager collective calls and DistributedOptimizer's
                    wait for its buckets
``optimizer``       the wrapped optimizer's ``step``
``checkpoint``      the device-to-host snapshot of an async save (its
                    producer comes with ROADMAP A10)

On a card, kernel launches and NCCL's ``work.wait()`` return before the
device has finished, so ``comms`` is the host's window of launches and
stream waits, not the transfer itself, and the device's work lands in
whichever phase the host next waits in. The device's time per kernel
category comes from profiler/device_profile.py.

Accounting is one switching timer: a step has exactly one active phase,
``phase(name)`` switches it, and the remainder lands in ``dispatch``,
so the phases sum to the step's wall time by construction; `attribute`
re-attributes time from inside the active phase and keeps that sum.

One step is in flight per scope: the training thread's. It is guarded
by the scope's lock, because on a card autograd runs the backward pass,
and with it DistributedOptimizer's gradient hooks and their bucket
launches, on its own device thread: their `attribute("comms", ...)`
lands in the training thread's step and is taken out of its active
phase (the one it is blocked in inside ``backward()``).

Steps are delimited explicitly (``with scope.step():``) or implicitly:
``DistributedOptimizer.step()`` closes one step per call that applies
gradients (step N runs from the end of optimizer call N-1 to the end of
call N), with ``comms`` and ``optimizer`` split out.

MFU follows the PaLM paper: model FLOPs per step over wall time over
the card's peak (profiler/flops.py).

Knobs: ``HOROVOD_PERFSCOPE=0`` swaps the scope for a no-op shell;
``HOROVOD_PERFSCOPE_WINDOW`` sizes the rolling window;
``HOROVOD_METRICS_PUSH_INTERVAL`` (seconds, default 5) paces the KV
pushes, which happen at a step boundary at most once per interval and
at ``hvd.shutdown()``. The metrics gauges and tracing spans the JAX
scope also feeds, and the exporter thread that paces its pushes, come
with observability (ROADMAP A13).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from horovod_tpu_torch.common import config as C

PERFSCOPE_ENV = C.HOROVOD_PERFSCOPE
PERFSCOPE_WINDOW_ENV = C.HOROVOD_PERFSCOPE_WINDOW

#: Rendezvous-KV scope the per-rank summaries are pushed under.
SCOPE = "perf"

#: Schema tag in every pushed or persisted summary.
SUMMARY_VERSION = 1

DEFAULT_WINDOW = 512
DEFAULT_PUSH_INTERVAL = 5.0

#: Canonical phase names (free-form names are accepted; these order the
#: reports).
PHASES = ("input_wait", "compile", "dispatch", "device_compute",
          "comms", "optimizer", "checkpoint")

#: The unattributed remainder of a step.
BASE_PHASE = "dispatch"

#: Phases that mean "waiting on peers", left out of a rank's *local*
#: time, which straggler attribution compares.
WAIT_PHASES = frozenset({"comms"})


class _StepState:
    """Accounting for the in-flight step (guarded by the scope's lock)."""

    __slots__ = ("t0", "phases", "cur", "since", "pending_sub", "stack",
                 "implicit", "weight", "attributed")

    def __init__(self, t0: float, implicit: bool, weight: float) -> None:
        self.t0 = t0
        self.phases: Dict[str, float] = {}
        self.cur = BASE_PHASE
        self.since = t0
        self.pending_sub = 0.0   # re-attributed out of the current window
        self.stack: List[str] = []
        self.implicit = implicit
        self.weight = weight
        self.attributed = 0.0    # cumulative re-attributed seconds

    def flush(self, now: float) -> None:
        el = now - self.since - self.pending_sub
        if el > 0.0:
            self.phases[self.cur] = self.phases.get(self.cur, 0.0) + el
        self.since = now
        self.pending_sub = 0.0


class _NullCtx:
    """Shared do-nothing context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class _PhaseCtx:
    __slots__ = ("scope", "name", "active")

    def __init__(self, scope: "PerfScope", name: str) -> None:
        self.scope = scope
        self.name = name

    def __enter__(self):
        self.active = self.scope._phase_begin(self.name)
        return self

    def __exit__(self, *exc):
        if self.active:
            self.scope._phase_end()
        return False


class _StepCtx:
    __slots__ = ("scope", "weight", "active")

    def __init__(self, scope: "PerfScope", weight: float) -> None:
        self.scope = scope
        self.weight = weight

    def __enter__(self):
        self.active = self.scope._step_begin(implicit=False,
                                             weight=self.weight)
        return self

    def __exit__(self, *exc):
        if self.active:
            self.scope._step_end()
        return False


class PerfScope:
    """Step-phase profiler (see the module docstring). `clock` is
    injectable for tests."""

    def __init__(self, window: Optional[int] = None, clock=None) -> None:
        if window is None:
            try:
                window = int(os.environ.get(PERFSCOPE_WINDOW_ENV, "")
                             or DEFAULT_WINDOW)
            except ValueError:
                window = DEFAULT_WINDOW
        self._clock = clock or time.perf_counter
        self._lock = threading.Lock()
        self._step: Optional[_StepState] = None  # guarded-by: _lock
        # (wall, {phase: sec}) per recorded step, most recent last.
        self._recent: collections.deque = \
            collections.deque(maxlen=max(8, window))  # guarded-by: _lock
        self._steps = 0  # guarded-by: _lock
        self._model_flops: Optional[float] = None  # guarded-by: _lock
        self._flops_source: str = "none"  # guarded-by: _lock
        self._comms_axes: Dict[str, float] = {}  # guarded-by: _lock
        self._push_interval = max(C._env_float(
            C.HOROVOD_METRICS_PUSH_INTERVAL, DEFAULT_PUSH_INTERVAL), 0.1)
        self._next_push = 0.0  # time.monotonic() of the next push
        self._kv = None
        self._kv_dead = False

    def set_comms_axes(self, bytes_by_axis: Dict[str, float]) -> None:
        """Record the gradient-reduction bytes a step moves, by the group
        they reduce over; shows up in summary()['comms_axes']."""
        with self._lock:
            self._comms_axes = {str(k): float(v)
                                for k, v in bytes_by_axis.items()}

    # ------------------------------------------------------------ steps
    def step(self, weight: float = 1.0) -> Any:
        """Context manager delimiting one training step. `weight=N`
        declares that the body covers N identical steps: wall and phases
        are divided by N on record."""
        return _StepCtx(self, weight)

    def _step_begin(self, implicit: bool, weight: float = 1.0) -> bool:
        with self._lock:
            st = self._step
            if st is not None and not st.implicit:
                return False  # nested explicit step: the inner one no-ops
            now = self._clock()
            # An explicit step takes over from an implicit one: close the
            # implicit interval so its time is not lost.
            done = st is not None and self._record(st, now)
            self._step = _StepState(self._clock(), implicit, weight)
        self._maybe_push(done)
        return True

    def _step_end(self) -> None:
        with self._lock:
            st = self._step
            if st is None:
                return
            self._step = None
            done = self._record(st, self._clock())
        self._maybe_push(done)

    def step_entry(self) -> None:
        """DistributedOptimizer hook (entry): open an implicit step when
        none is in flight, so comms and optimizer always land in one."""
        with self._lock:
            if self._step is None:
                self._step = _StepState(self._clock(), True, 1.0)

    def step_boundary(self) -> None:
        """DistributedOptimizer hook (exit): an optimizer step ends one
        implicit training step, and the next begins; explicit steps are
        left alone."""
        with self._lock:
            st = self._step
            if st is None or not st.implicit:
                return
            now = self._clock()
            done = self._record(st, now)
            self._step = _StepState(now, True, 1.0)
        self._maybe_push(done)

    # ----------------------------------------------------------- phases
    def phase(self, name: str) -> Any:
        """Context manager switching the step's active phase. No-op
        outside a step."""
        return _PhaseCtx(self, name)

    def _phase_begin(self, name: str) -> bool:
        with self._lock:
            st = self._step
            if st is None:
                return False
            st.flush(self._clock())
            st.stack.append(st.cur)
            st.cur = name
            return True

    def _phase_end(self) -> None:
        with self._lock:
            st = self._step
            if st is None:
                return
            st.flush(self._clock())
            st.cur = st.stack.pop() if st.stack else BASE_PHASE

    def attribute(self, name: str, seconds: float) -> None:
        """Re-attribute `seconds` of the active phase to `name` (the
        collectives and the kernel build call this, from any thread).
        The time is added to `name` and taken out of the active phase's
        window at its next flush, which keeps the sum-to-wall invariant.
        No-op outside a step, for non-positive durations, and when the
        active phase already is `name`."""
        with self._lock:
            st = self._step
            if st is None or seconds <= 0.0:
                return
            st.attributed += seconds
            if st.cur == name:
                return
            st.phases[name] = st.phases.get(name, 0.0) + seconds
            st.pending_sub += seconds

    def attributed_marker(self) -> float:
        """Cumulative re-attributed seconds of the in-flight step: outer
        hooks diff two markers to subtract nested attributions (a kernel
        build inside a collective's window) from their own."""
        with self._lock:
            st = self._step
            return st.attributed if st is not None else 0.0

    # ----------------------------------------------------------- record
    def _record(self, st: _StepState, now: float) -> bool:
        """Close `st` at `now` into the window (caller holds the lock);
        True when a step was recorded."""
        st.flush(now)
        wall = now - st.t0
        if wall <= 0.0:
            return False
        w = st.weight if st.weight > 0 else 1.0
        wall /= w
        phases = {k: v / w for k, v in st.phases.items() if v > 0.0}
        self._recent.append((wall, phases))
        self._steps += 1
        return True

    def _maybe_push(self, recorded: bool) -> None:
        """After a recorded step, push the summary when the interval has
        passed (outside the lock: the push is a KV round trip)."""
        if not recorded or self._kv_dead:
            return
        now = time.monotonic()
        if now < self._next_push:
            return
        self._next_push = now + self._push_interval
        self.push_summary()

    # ---------------------------------------------------------- results
    def set_model_flops(self, flops_per_step: Optional[float],
                        source: str = "fallback") -> None:
        """Declare the model FLOPs one step performs (feeds the summary's
        MFU). `source` is "counted" when FlopCounterMode counted them
        (profiler/flops.py), else "fallback"."""
        with self._lock:
            self._model_flops = float(flops_per_step) \
                if flops_per_step else None
            self._flops_source = source if self._model_flops else "none"

    def reset(self) -> None:
        """Drop accumulated stats and abandon the in-flight step."""
        with self._lock:
            self._step = None
            self._recent.clear()
            self._steps = 0
            self._model_flops = None
            self._flops_source = "none"
            self._comms_axes = {}

    def step_count(self) -> int:
        """Total steps recorded."""
        with self._lock:
            return self._steps

    def summary(self) -> Dict[str, Any]:
        """Rolling summary over the recent window: wall percentiles, mean
        per-phase seconds and fractions, coverage, dominant phases, MFU.
        Empty before the first recorded step."""
        with self._lock:
            recent = list(self._recent)
            steps = self._steps
            flops = self._model_flops
            source = self._flops_source
            comms_axes = dict(self._comms_axes)
        if not recent:
            return {}
        walls = sorted(w for w, _ in recent)
        n = len(walls)
        mean = sum(walls) / n
        p50 = walls[n // 2]
        p95 = walls[min(n - 1, int(n * 0.95))]
        phases: Dict[str, float] = {}
        local = 0.0
        for wall, ph in recent:
            for k, v in ph.items():
                phases[k] = phases.get(k, 0.0) + v
            local += wall - sum(v for k, v in ph.items()
                                if k in WAIT_PHASES)
        phases = {k: v / n for k, v in phases.items()}
        local /= n
        covered = sum(phases.values())
        order = {p: i for i, p in enumerate(PHASES)}
        key = lambda kv: (-kv[1], order.get(kv[0], 99))  # noqa: E731
        dominant = min(phases.items(), key=key)[0] if phases else None
        local_phases = {k: v for k, v in phases.items()
                        if k not in WAIT_PHASES}
        dominant_local = min(local_phases.items(), key=key)[0] \
            if local_phases else None
        out: Dict[str, Any] = {
            "steps": steps,
            "window_steps": n,
            "wall": {"mean_s": mean, "p50_s": p50, "p95_s": p95,
                     "max_s": walls[-1]},
            "phases_s": {k: phases[k] for k in
                         sorted(phases, key=lambda p: order.get(p, 99))},
            "phase_fractions": {k: (v / mean if mean else 0.0)
                                for k, v in phases.items()},
            "coverage": covered / mean if mean else 0.0,
            "local_mean_s": local,
            "dominant_phase": dominant,
            "dominant_local_phase": dominant_local,
            "model_flops_per_step": flops,
            "mfu_source": source,
        }
        if comms_axes:
            out["comms_axes"] = comms_axes
        from horovod_tpu_torch.profiler import flops as F
        peak = F.peak_flops_per_chip()
        if peak:
            out["peak_flops_per_chip"] = peak
            if flops and mean > 0:
                out["mfu"] = flops / mean / peak
        return out

    def step_profile(self, name: str, **extra: Any) -> Dict[str, Any]:
        """One structured record: the summary under a name."""
        prof = {"name": name, "perfscope": SUMMARY_VERSION}
        prof.update(self.summary())
        prof.update(extra)
        return prof

    # --------------------------------------------------------- KV push
    def _identity(self) -> Dict[str, Any]:
        from horovod_tpu_torch.core import topology
        rank = topology.rank_or_none()
        size = topology.size() if topology.is_initialized() else None
        if rank is None:
            v = os.environ.get(C.HOROVOD_RANK, "")
            rank = int(v) if v.strip().isdigit() else None
        if size is None:
            v = os.environ.get(C.HOROVOD_SIZE, "")
            size = int(v) if v.strip().isdigit() else None
        v = os.environ.get(C.HOROVOD_ELASTIC_ROUND, "")
        return {"rank": rank, "size": size,
                "round": int(v) if v.strip().isdigit() else 0,
                "hostname": os.environ.get("HOROVOD_HOSTNAME", ""),
                "pid": os.getpid()}

    def kv_payload(self) -> Optional[Dict[str, Any]]:
        """The compact per-rank summary pushed to the rendezvous KV (None
        before the first step, or with no rank to key it by)."""
        s = self.summary()
        if not s:
            return None
        body = self._identity()
        if body["rank"] is None:
            return None
        body["perfscope"] = SUMMARY_VERSION
        body["wall_time"] = time.time()
        body["summary"] = s
        return body

    def _kv_client(self):
        if self._kv is None and not self._kv_dead:
            addr = os.environ.get(C.HOROVOD_RENDEZVOUS_ADDR, "")
            port = os.environ.get(C.HOROVOD_RENDEZVOUS_PORT, "")
            if not addr or not port.strip().isdigit():
                self._kv_dead = True
                return None
            from horovod_tpu_torch.common.resilience import RetryPolicy
            from horovod_tpu_torch.runner.rendezvous import KVClient
            # Telemetry budget: one attempt, a 2 s transport cap; a
            # missed push is superseded by the next one.
            self._kv = KVClient(addr, int(port),
                                retry_policy=RetryPolicy(max_attempts=1),
                                request_timeout=2.0)
        return self._kv

    def push_summary(self) -> bool:
        """Best-effort KV push, keyed by (rank, round): an elastic reset
        reuses rank numbers, and a survivor's next-round summary must not
        overwrite a dead rank's last one."""
        body = self.kv_payload()
        if body is None:
            return False
        kv = self._kv_client()
        if kv is None:
            return False
        try:
            kv.put(SCOPE, f"rank-{body['rank']}.r{body['round']}",
                   json.dumps(body).encode("utf-8"))
            return True
        except Exception:  # best effort: a push never fails a step
            return False


class _NoopScope:
    """HOROVOD_PERFSCOPE=0 shell: every hook is a cheap no-op."""

    __slots__ = ()

    def step(self, weight: float = 1.0):
        return _NULL_CTX

    def phase(self, name: str):
        return _NULL_CTX

    def attribute(self, name: str, seconds: float) -> None:
        pass

    def attributed_marker(self) -> float:
        return 0.0

    def step_entry(self) -> None:
        pass

    def step_boundary(self) -> None:
        pass

    def set_model_flops(self, flops_per_step, source="fallback") -> None:
        pass

    def set_comms_axes(self, bytes_by_axis) -> None:
        pass

    def reset(self) -> None:
        pass

    def summary(self) -> Dict[str, Any]:
        return {}

    def step_count(self) -> int:
        return 0

    def step_profile(self, name: str, **extra: Any) -> Dict[str, Any]:
        return {"name": name, "perfscope": SUMMARY_VERSION, **extra}

    def kv_payload(self) -> Optional[Dict[str, Any]]:
        return None

    def push_summary(self) -> bool:
        return False


NOOP = _NoopScope()

_scope: Optional[object] = None
_scope_lock = threading.Lock()


def enabled() -> bool:
    return C._env_on(PERFSCOPE_ENV, True)


def get():
    """The process-wide scope (the NOOP shell under HOROVOD_PERFSCOPE=0)."""
    global _scope
    s = _scope
    if s is not None:
        return s
    with _scope_lock:
        if _scope is None:
            _scope = PerfScope() if enabled() else NOOP
        return _scope


def attribute(name: str, seconds: float) -> None:
    """Module-level hook (the collectives, the kernel build)."""
    get().attribute(name, seconds)


def attributed_marker() -> float:
    return get().attributed_marker()


def push_summary() -> bool:
    return get().push_summary()


def reset_for_tests() -> None:
    """Drop the process-wide scope so the next get() re-reads the env."""
    global _scope
    with _scope_lock:
        _scope = None


def persist_kv_summaries(store, out_dir: Optional[str] = None
                         ) -> List[str]:
    """Launcher side: write every pushed ``perf/`` summary the
    rendezvous server holds into `out_dir` (default HOROVOD_FLIGHT_DIR)
    as ``perf-rank-<r>.r<round>.json``, so the summaries outlive the
    job, including those of workers that died without a clean exit."""
    if out_dir is None:
        out_dir = os.environ.get(C.HOROVOD_FLIGHT_DIR, "")
    if not out_dir:
        return []
    items = store.scope_items(SCOPE)
    written: List[str] = []
    for key, raw in sorted(items.items()):
        safe = key.replace("/", "_")
        path = os.path.join(out_dir, f"perf-{safe}.json")
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
