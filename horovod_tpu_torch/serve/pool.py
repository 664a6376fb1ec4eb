"""Launcher-side replica pool: discovery, routing, failover
(counterpart of horovod_tpu/serve/pool.py, the same in behaviour).

Runs inside the serving launcher (serve/launcher.py), next to the
rendezvous server — so replica discovery is a direct
``RendezvousServer.scope_items("serve")`` scan, no HTTP. Each live
replica gets a dedicated dispatch thread that pulls batches from the
shared `ContinuousBatcher` (work stealing: a slow replica simply pulls
less often — Clipper's replica-pool shape), submits them over one
persistent framed connection, and distributes results to the waiting
frontend requests.

Failure model (the elastic training stack, reused):

* a submit that errors or exceeds ``HOROVOD_SERVE_REPLICA_TIMEOUT``
  marks the replica DEAD: its in-flight requests are requeued at the
  head of the batcher in arrival order (zero accepted requests
  dropped), a flight-recorder ``serve`` event names the replica
  (hvddoctor's serve section renders it), and the pool stops routing
  to it — a SIGKILL'd replica's kernel resets the TCP connection, so
  detection is immediate rather than timeout-bound;
* a dead replica's identity (host, pid, port) is remembered and never
  re-adopted — a stale registration or a flapping process cannot route
  traffic back onto a corpse (breaker semantics; the stale-heartbeat
  cutoff covers registrations whose process died silently);
* marking a replica dead also publishes a pid-pinned ``die`` order in
  the KV: the elastic driver only respawns a slot when its process
  EXITS, so a replica that is alive but dead-marked (one slow submit, a
  healed partition) would otherwise be stranded — told to die, it exits
  nonzero and the driver respawns it with a new pid the pool adopts;
* the elastic driver (which spawned the replicas) notices the process
  exit on its own poll, blacklists the host, and re-admits rejoined
  hosts on a later round — whose fresh registrations (new pid) the
  pool adopts automatically.

Heartbeat freshness is judged skew-immune: a registration's ``hb``
stamp is an OPAQUE advancing value, never compared against this host's
clock (cross-host wall-clock skew would strand a live replica or adopt
a corpse). A registration is stale only once the pool has watched it
for ``STALE_HEARTBEAT_S`` of launcher-monotonic time without the value
advancing.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from horovod_tpu_torch.common.config import _env_float
from horovod_tpu_torch.data.service import (_recv_frame, _require_secret,
                                            _send_frame)

HOROVOD_SERVE_REPLICA_TIMEOUT = "HOROVOD_SERVE_REPLICA_TIMEOUT"
DEFAULT_REPLICA_TIMEOUT = 30.0

#: A registration whose heartbeat is older than this many seconds is
#: treated as dead without waiting for a failed submit.
STALE_HEARTBEAT_S = 5.0

DISCOVERY_INTERVAL = 0.25

#: Dead-identity memory bound: (host, pid, port) triples practically
#: never recur, so evicting the oldest after this many is safe — it
#: keeps weeks-scale churny services from growing without bound.
DEAD_MEMORY = 1024


class _Replica:
    """One live replica: identity + its persistent connection."""

    def __init__(self, body: Dict[str, Any]) -> None:
        self.body = body
        self.rank = int(body.get("rank", -1))
        self.local_rank = int(body.get("local_rank", 0))
        self.host = str(body.get("hostname", "?"))
        self.pid = int(body.get("pid", -1))
        self.addr: Tuple[str, int] = (str(body.get("addr")),
                                      int(body.get("port")))
        self.round = int(body.get("round", 0))
        self.hb = float(body.get("hb", 0.0))
        self.batches = 0
        self._sock = None

    def key(self) -> Tuple:
        """Liveness identity: a respawn on the same slot is a NEW
        replica (new pid/port)."""
        return (self.host, self.pid, self.addr[1])

    def label(self) -> str:
        return (f"rank={self.rank} host={self.host} pid={self.pid} "
                f"addr={self.addr[0]}:{self.addr[1]}")

    def connect(self, timeout: float):
        import socket
        if self._sock is None:
            self._sock = socket.create_connection(self.addr,
                                                  timeout=timeout)
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class ReplicaPool:
    """Routes batches from the batcher to live replicas; requeues on
    death. `store` is the RendezvousServer (anything with
    `scope_items(scope) -> Dict[str, bytes]` and `put(scope, key, v)`)."""

    def __init__(self, store, batcher,
                 secret: Optional[bytes] = None,
                 replica_timeout: Optional[float] = None,
                 discovery_interval: float = DISCOVERY_INTERVAL) -> None:
        self.store = store
        self.batcher = batcher
        self._secret = _require_secret(secret)
        self.replica_timeout = replica_timeout if replica_timeout \
            is not None else _env_float(HOROVOD_SERVE_REPLICA_TIMEOUT,
                                        DEFAULT_REPLICA_TIMEOUT)
        self.discovery_interval = discovery_interval
        self._lock = threading.Lock()
        self._replicas: Dict[Tuple, _Replica] = {}  # guarded-by: _lock
        # insertion-ordered so the oldest identity can be evicted at
        # DEAD_MEMORY; values unused (an ordered set)
        self._dead: Dict[Tuple, None] = {}          # guarded-by: _lock
        # key -> (last seen hb value, monotonic time it last advanced);
        # pruned to the keys present in each scan
        self._hb_seen: Dict[Tuple, Tuple[float, float]] = {}  # guarded-by: _lock
        self._inflight = 0                          # guarded-by: _lock
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.batches_done = 0   # guarded-by: _lock
        self.deaths = 0         # guarded-by: _lock

    # --------------------------------------------------------- discovery
    def start(self) -> None:
        from horovod_tpu_torch.serve import telemetry
        telemetry.preregister_metrics()
        t = threading.Thread(target=self._discovery_loop,
                             name="hvd-serve-discovery", daemon=True)
        t.start()
        self._threads.append(t)

    def _discovery_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._scan_registrations()
            except Exception:
                pass  # a malformed registration must not kill routing
            self._stop.wait(self.discovery_interval)

    def _scan_registrations(self) -> None:
        from horovod_tpu_torch.observability import flight
        from horovod_tpu_torch.serve import SCOPE, telemetry
        try:
            items = self.store.scope_items(SCOPE)
        except Exception:
            return
        mono = time.monotonic()
        adopted: List[_Replica] = []
        stale: List[_Replica] = []
        seen_keys = set()
        with self._lock:
            for key, raw in sorted(items.items()):
                if not key.startswith("replica/"):
                    continue
                try:
                    body = json.loads(raw.decode("utf-8"))
                    rep = _Replica(body)
                except (ValueError, TypeError, KeyError):
                    continue
                k = rep.key()
                seen_keys.add(k)
                if k in self._dead:
                    continue
                # Skew-immune freshness (module docstring): first
                # sighting counts as fresh — a corpse registration is
                # caught by its first failed connect instead.
                prev = self._hb_seen.get(k)
                if prev is None or rep.hb != prev[0]:
                    self._hb_seen[k] = (rep.hb, mono)
                    fresh = True
                else:
                    fresh = mono - prev[1] <= STALE_HEARTBEAT_S
                live = self._replicas.get(k)
                if live is None and fresh:
                    self._replicas[k] = rep
                    adopted.append(rep)
                elif live is not None and not fresh:
                    stale.append(live)
            # A slot's KV key is overwritten by its respawn, so keys
            # absent from the scan are gone for good — prune them, and
            # retire any ADOPTED replica whose registration vanished: a
            # fast respawn inside the stale-heartbeat window replaces
            # the slot's single KV key, so the corpse never shows up as
            # stale — without this it lingers in the pool until a batch
            # is routed to it and eats a full submit timeout.
            for k in [k for k in self._hb_seen if k not in seen_keys]:
                del self._hb_seen[k]
            vanished = [rep for k, rep in self._replicas.items()
                        if k not in seen_keys]
            starved = not self._replicas
        for rep in adopted:
            telemetry.handles()["replicas"].set(self.replica_count())
            flight.record("serve", f"pool: replica {rep.label()} "
                                   f"ADOPTED round={rep.round}")
            # Dispatch threads are daemons that exit on retirement or
            # stop(); deliberately not accumulated in _threads.
            threading.Thread(target=self._dispatch_loop, args=(rep,),
                             name=f"hvd-serve-dispatch-{rep.pid}",
                             daemon=True).start()
        for rep in stale:
            # Dead replicas are detectable BETWEEN batches (replica.py's
            # heartbeat contract), not only on the next failed submit.
            self._retire(rep, f"StaleHeartbeat: no advance in "
                              f"{STALE_HEARTBEAT_S:.0f}s", requeued=0)
        for rep in vanished:
            self._retire(rep, "RegistrationVanished: slot key "
                              "re-registered or removed", requeued=0)
        if starved and self.batcher.depth_now() > 0:
            # Accepted work is waiting and there is nobody to run it —
            # the starvation signal a dashboard alerts on.
            telemetry.handles()["no_replica"].inc()

    # ---------------------------------------------------------- dispatch
    def _dispatch_loop(self, rep: _Replica) -> None:
        """One thread per replica: pull → submit → deliver, until the
        replica dies or the pool stops."""
        from horovod_tpu_torch.serve import telemetry
        mx = telemetry.handles()
        while not self._stop.is_set():
            with self._lock:
                if rep.key() not in self._replicas:
                    return
            batch = self.batcher.next_batch(timeout=0.25)
            if batch is None:
                continue
            with self._lock:
                self._inflight += 1
                inflight = self._inflight
            mx["inflight"].set(inflight)
            try:
                self._submit(rep, batch)
            finally:
                with self._lock:
                    self._inflight -= 1
                    inflight = self._inflight
                mx["inflight"].set(inflight)
                self.batcher.task_done()
        rep.close()

    def _submit(self, rep: _Replica, batch) -> None:
        from horovod_tpu_torch.serve import telemetry
        mx = telemetry.handles()
        t0 = time.perf_counter()
        w0 = time.time()
        ctx = _batch_trace_context(batch)
        try:
            s = rep.connect(self.replica_timeout)
            s.settimeout(self.replica_timeout)
            msg = ("infer_batch", batch.stacked(), ctx) if ctx \
                else ("infer_batch", batch.stacked())
            _send_frame(s, msg, self._secret)
            st = _recv_frame(s, self._secret)
        except Exception as e:
            # Record the failed attempt BEFORE the requeue so a
            # requeued request's trace carries BOTH dispatch attempts
            # (the requeue bumps r.requeues, which numbers the next
            # attempt's span).
            _record_batch_trace(batch, rep, ctx, w0, time.time() - w0,
                                "error", error=f"{type(e).__name__}: {e}")
            self._on_replica_death(rep, batch, e)
            return
        dur = time.time() - w0
        if st[0] != "ok":
            _record_batch_trace(batch, rep, ctx, w0, dur, "error",
                                error=str(st[1]))
            # The replica is alive but the program failed (user infer_fn
            # bug): fail the batch's requests — requeueing a
            # deterministic failure would poison every replica in turn.
            for r in batch.requests:
                if r.fail(f"replica {rep.label()}: {st[1]}"):
                    mx["request_status"]["failed"].inc()
            return
        _record_batch_trace(batch, rep, ctx, w0, dur, "ok")
        out = st[1]
        for i, r in enumerate(batch.requests):
            r.complete(out[i])
        rep.batches += 1
        with self._lock:
            self.batches_done += 1
        mx["batches"].inc()
        mx["batch_seconds"].observe(time.perf_counter() - t0)

    def _on_replica_death(self, rep: _Replica, batch, exc) -> None:
        """Requeue the in-flight batch (head of queue, original order)
        and retire the replica. The postmortem reports how many
        requests actually went back in the queue — not the batch size,
        which also counts requests already decided (frontend timeout)
        or over the requeue cap."""
        from horovod_tpu_torch.observability import flight
        n = self.batcher.requeue(batch.requests)
        if not self._retire(rep, f"{type(exc).__name__}: {exc}", n) and n:
            # A stale-heartbeat eviction raced this failed submit; the
            # requeue still happened — leave a trail the doctor folds
            # into the death's requeued total (the requeued= token).
            flight.record("serve", f"pool: late requeue after eviction "
                                   f"of replica {rep.label()} "
                                   f"requeued={n}")

    def _retire(self, rep: _Replica, reason: str, requeued: int) -> bool:
        """Mark a replica dead exactly once (returns whether this call
        did it): stop routing, never re-adopt, publish its die order,
        record the DEAD postmortem event."""
        from horovod_tpu_torch.observability import flight
        from horovod_tpu_torch.serve import SCOPE, telemetry
        rep.close()
        with self._lock:
            if rep.key() in self._dead:
                return False
            self._replicas.pop(rep.key(), None)
            self._dead[rep.key()] = None
            while len(self._dead) > DEAD_MEMORY:
                del self._dead[next(iter(self._dead))]
            self.deaths += 1
            n = len(self._replicas)
        mx = telemetry.handles()
        mx["replicas"].set(n)
        mx["replica_deaths"].inc()
        # The elastic driver only respawns a slot whose process EXITS;
        # a dead-marked replica that is actually still alive would be
        # stranded without this order. The value pins the pid so a
        # respawned process on the same slot ignores it.
        try:
            self.store.put(SCOPE, f"die/{rep.host}/{rep.local_rank}",
                           str(rep.pid).encode())
        except Exception:
            pass  # KV gone means the whole service is exiting
        flight.record(
            "serve", f"replica {rep.label()} DEAD "
                     f"batches={rep.batches} "
                     f"requeued={requeued} "
                     f"error={reason}")
        print(f"serve: replica {rep.label()} died ({reason}); requeued "
              f"{requeued} in-flight request(s) onto survivors",
              flush=True)
        return True

    # --------------------------------------------------------- lifecycle
    def replica_count(self) -> int:
        with self._lock:
            return len(self._replicas)

    def wait_for_replicas(self, n: int, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.replica_count() >= n:
                return
            time.sleep(0.1)
        raise TimeoutError(
            f"only {self.replica_count()} serving replica(s) registered "
            f"before timeout (wanted {n})")

    def idle(self) -> bool:
        """No queued requests and no batch handed out — drain complete.
        `quiesced()` counts the handed-out batch atomically with the
        dequeue, so a batch a dispatch thread just pulled (but has not
        yet submitted) keeps the pool non-idle — the drain watcher must
        never release the replicas out from under it."""
        return self.batcher.quiesced()

    def publish_shutdown(self) -> None:
        """Tell every replica to exit 0 (serve/shutdown key)."""
        from horovod_tpu_torch.serve import SCOPE
        self.store.put(SCOPE, "shutdown", b"1")

    def stop(self) -> None:
        self._stop.set()
        self.batcher.close()
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            rep.close()


def _batch_trace_context(batch):
    """Cross-process trace context for a dispatched batch. The batch
    executes ONCE for every request in it, so there is exactly one
    batch-execution span: it joins the PRIMARY (first sampled) request's
    trace with a pre-allocated span id, and carries the other sampled
    requests' trace ids as links so the doctor and the Perfetto flow
    events can stitch their shared device time back to each of them.
    None when no request in the batch is sampled (the replica then
    records nothing — its span helpers are ambient-gated)."""
    from horovod_tpu_torch.observability import tracing
    try:
        sampled = [r.trace for r in batch.requests if r.trace]
        if not sampled:
            return None
        primary = sampled[0]
        ctx = {tracing.CTX_TRACE: primary[tracing.CTX_TRACE],
               tracing.CTX_SPAN: tracing._new_id(),
               "p": primary[tracing.CTX_SPAN]}
        links = [c[tracing.CTX_TRACE] for c in sampled[1:]]
        if links:
            ctx[tracing.CTX_LINKS] = links
        return ctx
    except Exception:
        return None


def _record_batch_trace(batch, rep, ctx, w0: float, dur: float,
                        status: str, error: Optional[str] = None) -> None:
    """Retroactively record one dispatch attempt: a per-request
    ``serve.dispatch`` child span (parented on that request's
    pre-allocated admission span) plus the shared ``serve.batch`` span
    the replica's fragment nests under. Called once per ATTEMPT — a
    requeued request accumulates one dispatch span per replica tried,
    numbered by its ``attempt`` attribute."""
    if ctx is None:
        return
    from horovod_tpu_torch.observability import tracing
    try:
        tr = tracing.get()
        label = f"{rep.host}:{rep.pid}"
        for r in batch.requests:
            rctx = r.trace
            if not rctx:
                continue
            attrs = {"replica": label, "attempt": r.requeues,
                     "batch": ctx[tracing.CTX_SPAN]}
            if error:
                attrs["error"] = error
            tr.add_span("serve.dispatch", w0, dur,
                        trace_id=rctx[tracing.CTX_TRACE],
                        parent_id=rctx[tracing.CTX_SPAN],
                        status=status, attrs=attrs)
        battrs: Dict[str, Any] = {"replica": label,
                                  "size": len(batch.requests)}
        links = ctx.get(tracing.CTX_LINKS)
        if links:
            battrs["links"] = links
        if error:
            battrs["error"] = error
        tr.add_span("serve.batch", w0, dur,
                    trace_id=ctx[tracing.CTX_TRACE],
                    span_id=ctx[tracing.CTX_SPAN],
                    parent_id=ctx.get("p"),
                    status=status, attrs=battrs)
    except Exception:
        pass  # tracing must never fail a dispatch
