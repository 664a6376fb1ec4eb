"""Continuous request batching with bucketed shapes (counterpart of
horovod_tpu/serve/batching.py, the same in behaviour).

The assembler implements the Orca (OSDI '22) admission shape adapted to
single-shot inference: requests stream into a bounded queue and are
formed into batches *continuously* — a batch leaves as soon as it is
full (``HOROVOD_SERVE_MAX_BATCH``) or its oldest member has waited
``HOROVOD_SERVE_MAX_WAIT_MS`` (Clipper's latency-aware deadline,
NSDI '17) — new arrivals simply join the *next* batch; nothing ever
waits for a straggler batch to finish.

Batches are padded up to a small set of batch-size **buckets**
(``HOROVOD_SERVE_BUCKETS``, default powers of two up to the max batch)
so each replica replays one captured CUDA graph per (bucket, item
shape, dtype) — an unpadded free-size batch would force a fresh capture
per distinct size, and the first occurrence of each size would eat a
capture on the serving hot path.

Determinism: the core (`ContinuousBatcher.poll`) is driven by an
injected clock and takes no locks of its own beyond its queue mutex, so
tests pin every flush decision with a fake clock; the blocking
`next_batch` used by the live pool is a thin condition-variable wrapper
over `poll`.

Requeue contract (replica death): `requeue()` puts the in-flight
requests back at the FRONT of the queue in their original arrival
order, ahead of anything accepted later — an accepted request's
position in the service order survives a replica death. Requeues are
exempt from the depth bound (bouncing an already-accepted request
would break the zero-drop guarantee) and are capped per request by
``HOROVOD_SERVE_REQUEUE_LIMIT``; a request over the cap is completed
with an error instead of cycling through dying replicas forever.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple

from horovod_tpu_torch.common.config import _env_float, _env_int

HOROVOD_SERVE_MAX_BATCH = "HOROVOD_SERVE_MAX_BATCH"
HOROVOD_SERVE_MAX_WAIT_MS = "HOROVOD_SERVE_MAX_WAIT_MS"
HOROVOD_SERVE_QUEUE_DEPTH = "HOROVOD_SERVE_QUEUE_DEPTH"
HOROVOD_SERVE_BUCKETS = "HOROVOD_SERVE_BUCKETS"
HOROVOD_SERVE_REQUEUE_LIMIT = "HOROVOD_SERVE_REQUEUE_LIMIT"

DEFAULT_MAX_BATCH = 8
DEFAULT_MAX_WAIT_MS = 10.0
DEFAULT_QUEUE_DEPTH = 1024
DEFAULT_REQUEUE_LIMIT = 3

_rid = itertools.count()


def parse_buckets(spec: Optional[str], max_batch: int) -> Tuple[int, ...]:
    """Batch-size buckets: explicit csv spec, else powers of two up to
    (and always including) `max_batch`. Sorted, deduped, positive."""
    if spec:
        try:
            vals = {int(tok) for tok in spec.split(",") if tok.strip()}
        except ValueError:
            raise ValueError(
                f"{HOROVOD_SERVE_BUCKETS} must be comma-separated ints, "
                f"got {spec!r}")
        if not vals or min(vals) <= 0:
            raise ValueError(
                f"{HOROVOD_SERVE_BUCKETS} must be positive, got {spec!r}")
        # max_batch is ALWAYS in the set (not just when every spec'd
        # bucket is smaller): a full batch must land on an exact bucket
        # — "4,64" with max_batch 8 would otherwise pad every full
        # batch of 5-8 up to 64 rows of mostly zeros.
        vals.add(max_batch)
        return tuple(sorted(vals))
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class Request:
    """One accepted inference request (a single example)."""

    # _hvdrace_token: requests are high-churn, and hvdrace falls back
    # to recycled id() identity on slotted classes — the slot lets the
    # detector stamp its never-reused token (analysis/race.py).
    __slots__ = ("rid", "payload", "t_enqueue", "t_dequeue", "t_done",
                 "event", "result", "error", "requeues", "shape_key",
                 "trace", "_decide", "_clock", "_hvdrace_token")

    def __init__(self, payload: Any, now: float,
                 shape_key: Tuple = (),
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.rid = next(_rid)
        self.payload = payload
        self.t_enqueue = now
        # Lifecycle stamps on the SAME clock as t_enqueue (the
        # batcher's injectable clock, so tests pin them): when the
        # request left the queue in a formed batch, and when its
        # outcome was decided.
        self.t_dequeue: Optional[float] = None
        self.t_done: Optional[float] = None
        # hvdtrace context ({"t": trace_id, "s": request span id,
        # "p": client span id}) or None when the trace was unsampled.
        self.trace: Optional[dict] = None
        self.event = threading.Event()
        # Outcome decision must be an atomic test-and-set: the frontend
        # timeout thread and a dispatch thread can decide concurrently,
        # and exactly ONE may win (status metrics are counted per win).
        self._decide = threading.Lock()
        self.result: Any = None     # guarded-by: _decide (until event)
        self.error: Optional[str] = None  # guarded-by: _decide (until event)
        self.requeues = 0
        self.shape_key = shape_key
        self._clock = clock

    def complete(self, result: Any) -> bool:
        """First outcome wins: a request the frontend already timed out
        (fail) must not double-count as completed, and vice versa.
        Returns whether this call decided the request."""
        with self._decide:
            if self.event.is_set():
                return False
            self.result = result
            self.t_done = self._clock()
            self.event.set()
            return True

    def fail(self, error: str) -> bool:
        with self._decide:
            if self.event.is_set():
                return False
            self.error = error
            self.t_done = self._clock()
            self.event.set()
            return True


class Batch:
    """Requests of one shape group, padded up to a bucket size."""

    __slots__ = ("requests", "bucket", "shape_key", "t_formed")

    def __init__(self, requests: List[Request], bucket: int,
                 now: float) -> None:
        self.requests = requests
        self.bucket = bucket
        self.shape_key = requests[0].shape_key if requests else ()
        self.t_formed = now

    @property
    def padding(self) -> int:
        return self.bucket - len(self.requests)

    def stacked(self):
        """numpy array of shape (bucket, *item_shape): the real rows
        first, zero rows padding up to the bucket. Padding correctness
        is pinned by tests/test_serve.py."""
        import numpy as np
        rows = [np.asarray(r.payload) for r in self.requests]
        arr = np.stack(rows)
        if self.padding:
            pad = np.zeros((self.padding,) + arr.shape[1:], arr.dtype)
            arr = np.concatenate([arr, pad])
        return arr


def shape_key_of(payload: Any) -> Tuple:
    """Group key: (item shape, dtype) — batches never mix shapes."""
    import numpy as np
    arr = np.asarray(payload)
    return (tuple(arr.shape), str(arr.dtype))


class ContinuousBatcher:
    """Bounded request queue + deadline/size-driven batch former."""

    def __init__(self,
                 max_batch: Optional[int] = None,
                 max_wait_s: Optional[float] = None,
                 depth: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 requeue_limit: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        import os
        self.max_batch = max_batch if max_batch is not None \
            else _env_int(HOROVOD_SERVE_MAX_BATCH, DEFAULT_MAX_BATCH)
        self.max_wait_s = max_wait_s if max_wait_s is not None \
            else _env_float(HOROVOD_SERVE_MAX_WAIT_MS,
                            DEFAULT_MAX_WAIT_MS) / 1000.0
        self.depth = depth if depth is not None \
            else _env_int(HOROVOD_SERVE_QUEUE_DEPTH, DEFAULT_QUEUE_DEPTH)
        if buckets:
            # Same invariants as the env path: positive, deduped, and
            # max_batch always present so a full batch lands on an
            # exact bucket instead of padding up to an oversized one.
            vals = {int(b) for b in buckets}
            if min(vals) <= 0:
                raise ValueError(f"buckets must be positive, "
                                 f"got {sorted(vals)}")
            vals.add(self.max_batch)
            self.buckets = tuple(sorted(vals))
        else:
            self.buckets = parse_buckets(
                os.environ.get(HOROVOD_SERVE_BUCKETS, ""), self.max_batch)
        self.requeue_limit = requeue_limit if requeue_limit is not None \
            else _env_int(HOROVOD_SERVE_REQUEUE_LIMIT,
                          DEFAULT_REQUEUE_LIMIT)
        # the largest bucket caps the effective batch
        self.max_batch = min(self.max_batch, self.buckets[-1])
        self.clock = clock
        # _cv's context manager acquires the underlying mutex, so _cv
        # IS the lock name for the guarded-by convention.
        self._cv = threading.Condition(threading.Lock())
        self._pending: deque = deque()  # guarded-by: _cv
        self._closed = False            # guarded-by: _cv
        self._drain = False             # guarded-by: _cv
        # Batches handed out by poll() and not yet task_done()'d. The
        # increment is atomic with the dequeue, so quiesced() can never
        # report idle while a dispatch thread holds an unacknowledged
        # batch (the drain watcher relies on this).
        self._out = 0                   # guarded-by: _cv

    # ------------------------------------------------------------ intake
    def offer(self, payload: Any) -> Optional[Request]:
        """Admit one request; None when the queue is full (the caller
        REJECTS — bounded queue, never unbounded buffering)."""
        from horovod_tpu_torch.serve import telemetry
        now = self.clock()
        mx = telemetry.handles()
        # Payload conversion + Request construction need no shared
        # state — keep the admission critical section (shared with
        # every poll/requeue) down to the checks and the append.
        req = Request(payload, now, shape_key=shape_key_of(payload),
                      clock=self.clock)
        with self._cv:
            # _drain rejects too, atomically with the drain flag: an
            # admission racing the drain watcher past the frontend's
            # own (unlocked) drain check must not slip in after the
            # watcher observed quiesced and released the replicas —
            # that would be an accepted request with nobody to run it.
            if self._closed or self._drain \
                    or len(self._pending) >= self.depth:
                mx["request_status"]["rejected"].inc()
                return None
            self._pending.append(req)
            mx["request_status"]["accepted"].inc()
            mx["queue_depth"].set(len(self._pending))
            self._cv.notify_all()
            return req

    def requeue(self, requests: Sequence[Request]) -> int:
        """Put in-flight requests back at the head, preserving their
        original order (appendleft in reverse). Requests past the
        requeue cap are error-completed instead; requests that already
        have an outcome (frontend timeout) are dropped. Returns how
        many actually went back in the queue — the death postmortem
        reports this number, not the batch size."""
        from horovod_tpu_torch.serve import telemetry
        mx = telemetry.handles()
        accepted: List[Request] = []
        for r in requests:
            if r.event.is_set():
                continue  # already decided (e.g. frontend timeout)
            r.requeues += 1
            if r.requeues > self.requeue_limit:
                if r.fail(f"request failed after {self.requeue_limit} "
                          f"replica retries"):
                    mx["request_status"]["failed"].inc()
            else:
                accepted.append(r)
        with self._cv:
            for r in reversed(accepted):
                self._pending.appendleft(r)
            mx["requeued"].inc(len(accepted))
            mx["queue_depth"].set(len(self._pending))
            self._cv.notify_all()
        return len(accepted)

    # ----------------------------------------------------------- forming
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def poll(self, now: Optional[float] = None) -> Optional[Batch]:
        """Non-blocking, deterministic batch formation (the fake-clock
        test surface): returns a Batch when the flush condition holds
        for the oldest request's shape group, else None."""
        from horovod_tpu_torch.serve import telemetry
        if now is None:
            now = self.clock()
        batch = None
        with self._cv:
            # Purge requests that already have an outcome (frontend
            # timeout): dispatching them would burn replica slots on
            # answers nobody reads — under sustained overload that is
            # congestion collapse, dead work crowding out live work.
            if any(r.event.is_set() for r in self._pending):
                self._pending = deque(r for r in self._pending
                                      if not r.event.is_set())
                # The purge can empty the queue without forming a
                # batch — the depth gauge must not keep reporting the
                # pre-purge depth through exactly the incident
                # (mass frontend timeouts) operators read it for.
                telemetry.handles()["queue_depth"].set(
                    len(self._pending))
            if self._pending:
                # Evaluate every shape group (in arrival order of its
                # oldest member) — a full batch of one shape must not be
                # head-of-line blocked behind a not-yet-due request of
                # another shape.
                groups: dict = {}
                for r in self._pending:
                    groups.setdefault(r.shape_key, []).append(r)
                for group in groups.values():
                    full = len(group) >= self.max_batch
                    due = (now - group[0].t_enqueue) >= self.max_wait_s
                    if full or due or self._drain:
                        take = group[:self.max_batch]
                        for r in take:
                            r.t_dequeue = now
                        taken = set(id(r) for r in take)
                        self._pending = deque(r for r in self._pending
                                              if id(r) not in taken)
                        batch = Batch(take, self.bucket_for(len(take)),
                                      now)
                        self._out += 1
                        telemetry.handles()["queue_depth"].set(
                            len(self._pending))
                        break
        if batch is not None:
            mx = telemetry.handles()
            mx["batch_size"].observe(len(batch.requests))
            for r in batch.requests:
                mx["queue_wait"].observe(max(0.0, now - r.t_enqueue))
            if batch.padding:
                mx["padded_items"].inc(batch.padding)
        return batch

    def next_batch(self, timeout: Optional[float] = None
                   ) -> Optional[Batch]:
        """Blocking form-or-wait used by the live dispatch threads.
        Returns None on timeout or once closed and empty."""
        deadline = None if timeout is None else self.clock() + timeout
        while True:
            now = self.clock()
            batch = self.poll(now)
            if batch is not None:
                return batch
            with self._cv:
                if self._closed and not self._pending:
                    return None
                waits = [self.max_wait_s]  # re-check cadence upper bound
                if self._pending:
                    oldest = self._pending[0]
                    waits.append(oldest.t_enqueue + self.max_wait_s - now)
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        return None
                    waits.append(remaining)
                self._cv.wait(max(0.0005, min(waits)))

    # --------------------------------------------------------- lifecycle
    def depth_now(self) -> int:
        with self._cv:
            return len(self._pending)

    def task_done(self) -> None:
        """Acknowledge one batch handed out by poll()/next_batch() —
        call after its requests are completed, failed, or requeued."""
        with self._cv:
            self._out -= 1
            self._cv.notify_all()

    def quiesced(self) -> bool:
        """Nothing queued AND nothing handed out — safe to drain. The
        dequeue and the handed-out increment are one critical section,
        so there is no window where a batch is in a dispatch thread's
        hands but visible in neither count."""
        with self._cv:
            return not self._pending and self._out == 0

    def set_drain(self, drain: bool = True) -> None:
        """Drain mode: flush partial batches immediately (service
        shutdown — don't make the last requests wait out the deadline)."""
        with self._cv:
            self._drain = drain
            self._cv.notify_all()

    def close(self) -> None:
        """Stop admitting; wake waiters. Pending requests still drain."""
        with self._cv:
            self._closed = True
            self._drain = True
            self._cv.notify_all()
