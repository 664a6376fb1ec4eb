"""Replica-side serving worker (counterpart of
horovod_tpu/serve/replica.py). The replica's engine runs on
`cuda:<local_rank>` (serve/engine.py serve_device).

A replica is an elastic worker process spawned by the serving launcher
(serve/launcher.py → ElasticDriver). Unlike a training worker it joins
NO collective ring — data-parallel inference replicas are independent —
so it skips `hvd.init()` entirely and only talks to the launcher's
rendezvous KV:

* registers its (addr, port, pid) under the ``serve`` scope, keyed by
  its slot (``replica/<hostname>/<local_rank>``) — the slot key is what
  the elastic driver preserves across rounds, so a surviving replica's
  registration stays valid through a reset while a respawned process on
  the same slot shows up as a new pid (the pool keys liveness on pid);
* heartbeats that registration (and its perfscope summary + flight
  tail) on a sub-second cadence so a dead replica is detectable even
  between batches;
* serves ``("infer_batch", array)`` RPCs on a framed TCP server (the
  data/service.py wire format, HMAC-authenticated);
* exits 0 when the launcher publishes the ``serve/shutdown`` key
  (drain) — the elastic loop reads that unanimous clean exit as job
  success.

Each batch runs under a perfscope step (``device_compute`` phase from
the engine, queue-to-dispatch gap in ``dispatch``), so `hvddoctor`'s
perf section attributes a slow replica the same way it attributes a
slow training rank.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from horovod_tpu_torch.data.service import (_require_secret,
                                            _routable_local_addr, _serve)

HEARTBEAT_INTERVAL = 0.5
SHUTDOWN_POLL_INTERVAL = 0.25


def _slot_identity() -> Dict[str, Any]:
    return {
        "hostname": os.environ.get("HOROVOD_HOSTNAME", "localhost"),
        "local_rank": int(os.environ.get("HOROVOD_LOCAL_RANK", "0") or 0),
        "rank": int(os.environ.get("HOROVOD_RANK", "0") or 0),
        "round": int(os.environ.get("HOROVOD_ELASTIC_ROUND", "0") or 0),
        "pid": os.getpid(),
    }


class ReplicaServer:
    """One replica: engine + framed server + KV registration loop."""

    def __init__(self, engine, kv=None,
                 secret: Optional[bytes] = None) -> None:
        self.engine = engine
        self._secret = _require_secret(secret)
        self.kv = kv if kv is not None else self._kv_from_env()
        self.ident = _slot_identity()
        self.port: Optional[int] = None
        self.batches = 0   # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._srv = None
        self._hb_thread: Optional[threading.Thread] = None

    @staticmethod
    def _kv_from_env():
        from horovod_tpu_torch.common import config as C
        from horovod_tpu_torch.runner.rendezvous import KVClient
        addr = os.environ.get(C.HOROVOD_RENDEZVOUS_ADDR, "")
        port = os.environ.get(C.HOROVOD_RENDEZVOUS_PORT, "")
        if not addr or not port:
            raise RuntimeError(
                "replica needs the launcher's rendezvous KV "
                "(HOROVOD_GLOO_RENDEZVOUS_ADDR/_PORT); run under "
                "`python -m horovod_tpu_torch.serve`")
        return KVClient(addr, int(port))

    # --------------------------------------------------------- lifecycle
    def start(self) -> int:
        from horovod_tpu_torch.observability import flight
        from horovod_tpu_torch.serve import telemetry
        telemetry.preregister_metrics()
        self._srv, self.port = _serve(self._handle, self._secret)
        self._register()
        flight.record(
            "serve", f"replica rank={self.ident['rank']} "
                     f"host={self.ident['hostname']} "
                     f"pid={self.ident['pid']} UP port={self.port} "
                     f"round={self.ident['round']}")
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="hvd-serve-heartbeat",
            daemon=True)
        self._hb_thread.start()
        print(f"SERVE_REPLICA_UP rank={self.ident['rank']} "
              f"host={self.ident['hostname']} pid={self.ident['pid']} "
              f"port={self.port}", flush=True)
        return self.port

    def _reg_key(self) -> str:
        return (f"replica/{self.ident['hostname']}/"
                f"{self.ident['local_rank']}")

    def _register(self) -> None:
        from horovod_tpu_torch.serve import SCOPE
        with self._lock:
            served = self.batches
        body = dict(self.ident)
        # Advertise the address of the route the KV actually uses (see
        # data/service.py DataWorker.start for the multi-NIC rationale).
        body.update({"addr": self._adv_addr, "port": self.port,
                     "hb": time.time(), "batches": served})
        self.kv.put(SCOPE, self._reg_key(), json.dumps(body).encode())

    def _heartbeat_loop(self) -> None:
        from horovod_tpu_torch.observability import flight, tracing
        from horovod_tpu_torch.profiler import perfscope
        while not self._stop.is_set():
            try:
                self._register()
                perfscope.push_summary()
                flight.push_tail()
                tracing.push_tail()
            except Exception:
                pass  # launcher restarting; next tick retries
            self._stop.wait(HEARTBEAT_INTERVAL)

    @property
    def _adv_addr(self) -> str:
        if not hasattr(self, "_adv_cache"):
            self._adv_cache = _routable_local_addr(
                (self.kv.base.split("//")[1].rsplit(":", 1)[0],
                 int(self.kv.base.rsplit(":", 1)[1])))
        return self._adv_cache

    def wait_for_shutdown(self, poll: float = SHUTDOWN_POLL_INTERVAL
                          ) -> int:
        """Block until the launcher publishes ``serve/shutdown`` (drain
        — returns 0) or the pool publishes a die order for THIS pid
        (returns 1). A dead-marked replica that is actually alive must
        exit nonzero: the elastic driver only respawns a slot whose
        process exits, and the pool never routes to a dead-marked pid
        again — exiting is how the slot heals. The order is pid-pinned,
        so a respawned process on the same slot ignores it."""
        from horovod_tpu_torch.serve import SCOPE
        die_key = (f"die/{self.ident['hostname']}/"
                   f"{self.ident['local_rank']}")
        my_pid = str(self.ident["pid"]).encode()
        while not self._stop.is_set():
            try:
                if self.kv.get(SCOPE, "shutdown", timeout=0.0):
                    return 0
                if self.kv.get(SCOPE, die_key, timeout=0.0) == my_pid:
                    return 1
            except Exception:
                pass
            self._stop.wait(poll)
        return 0

    def stop(self) -> None:
        self._stop.set()
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None

    # ----------------------------------------------------------- handler
    def _handle(self, req):
        kind = req[0]
        if kind == "infer_batch":
            # Optional third element: the pool's hvdtrace batch context
            # (observability/tracing.py) — absent from older pools.
            return self._infer_batch(req[1],
                                     req[2] if len(req) > 2 else None)
        if kind == "ping":
            return ("ok", self.ident["pid"])
        return ("error", f"unknown request {kind!r}")

    def _infer_batch(self, batch, ctx=None) -> Tuple[str, Any]:
        from horovod_tpu_torch.observability import tracing
        from horovod_tpu_torch.profiler import perfscope
        from horovod_tpu_torch.serve import telemetry
        mx = telemetry.handles()
        t0 = time.perf_counter()
        # Adopt the pool's batch context (present iff some request in
        # the batch was sampled) so this fragment nests under the
        # serve.batch span; replica.infer_batch is this process's local
        # root, and the engine's execute span becomes its ambient child.
        tok = tracing.adopt(ctx)
        sp = tracing.get().start_span("replica.infer_batch", root=True) \
            if tok is not None else tracing.NOOP_SPAN
        scope = perfscope.get()
        try:
            with sp:
                with scope.step():
                    out = self.engine.infer(batch)
        finally:
            if tok is not None:
                tracing.clear(tok)
        dt = time.perf_counter() - t0
        with self._lock:
            self.batches += 1
        mx["replica_batches"].inc()
        mx["replica_batch_seconds"].observe(dt)
        return ("ok", out)


def serve_replica(engine, secret: Optional[bytes] = None) -> int:
    """Replica main: start, serve until the launcher drains (returns 0;
    the elastic loop reads unanimous zero exits as job success) or the
    pool dead-marks this pid (returns 1 so the elastic driver respawns
    the slot). The body of a user's replica script:

        engine = InferenceEngine.from_checkpoint(path, infer_fn, like)
        engine.warmup(item_shape, dtype, buckets)
        sys.exit(serve_replica(engine))
    """
    from horovod_tpu_torch.observability import flight
    r = ReplicaServer(engine, secret=secret)
    r.start()
    rc = 0
    try:
        rc = r.wait_for_shutdown()
    finally:
        with r._lock:
            served = r.batches
        state = "DRAINED" if rc == 0 else "EVICTED (exiting for respawn)"
        flight.record(
            "serve", f"replica rank={r.ident['rank']} "
                     f"host={r.ident['hostname']} pid={r.ident['pid']} "
                     f"{state} batches={served}")
        r.stop()
    print(f"SERVE_REPLICA_DONE rank={r.ident['rank']} "
          f"batches={served} rc={rc}", flush=True)
    return rc
