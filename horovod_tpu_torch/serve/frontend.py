"""Serving frontend: authenticated framed-TCP request router
(counterpart of horovod_tpu/serve/frontend.py; the frames are the same,
so either package's client talks to either frontend).

Rides the `data/service.py` wire format (length-prefixed pickled frames,
mandatory per-job HMAC — see `_require_secret` there for why auth is not
optional on a pickle transport) so one trust model covers the whole
control/data plane.

Admission is a bounded queue (`ContinuousBatcher.offer`): on overload
the frontend REJECTS with a typed response instead of buffering without
bound — a rejected request was never accepted, so it does not count
against the zero-drop guarantee the pool maintains for accepted ones.

Protocol (request → response):

  ("infer", payload[, trace_ctx])
                      → ("ok", result) | ("rejected", why) | ("error", why)
  ("stats",)          → ("ok", {...})
  ("shutdown",)       → ("ok", None)      # begin drain; launcher finishes

The optional third ``infer`` element is the hvdtrace context dict
(``observability/tracing.py``) — older clients simply omit it, so the
protocol is backward compatible in both directions.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from horovod_tpu_torch.common.config import _env_float
from horovod_tpu_torch.data.service import (_recv_frame, _require_secret,
                                            _send_frame, _serve)
from horovod_tpu_torch.observability import tracing

HOROVOD_SERVE_PORT = "HOROVOD_SERVE_PORT"
HOROVOD_SERVE_PORT_FILE = "HOROVOD_SERVE_PORT_FILE"
HOROVOD_SERVE_REQUEST_TIMEOUT = "HOROVOD_SERVE_REQUEST_TIMEOUT"

DEFAULT_REQUEST_TIMEOUT = 60.0


def announce_port(port: int) -> None:
    """Write the frontend port to HOROVOD_SERVE_PORT_FILE (when set) so
    out-of-band clients/load generators can find an OS-assigned port —
    same shape as the rendezvous port file."""
    path = os.environ.get(HOROVOD_SERVE_PORT_FILE, "")
    if not path:
        return
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, path)


class Frontend:
    """Accepts requests into the batcher and blocks each connection
    thread until its request completes (request/response semantics over
    the persistent framed connection)."""

    def __init__(self, batcher, secret: Optional[bytes] = None,
                 port: Optional[int] = None,
                 request_timeout: Optional[float] = None) -> None:
        self.batcher = batcher
        self._secret = _require_secret(secret)
        self.port = port if port is not None \
            else int(os.environ.get(HOROVOD_SERVE_PORT, "0") or 0)
        self.request_timeout = request_timeout if request_timeout is not None \
            else _env_float(HOROVOD_SERVE_REQUEST_TIMEOUT,
                            DEFAULT_REQUEST_TIMEOUT)
        self.drain_requested = threading.Event()
        self._srv = None
        self.accepted = 0   # guarded-by: _lock
        self.completed = 0  # guarded-by: _lock
        self.failed = 0     # guarded-by: _lock
        self.rejected = 0   # guarded-by: _lock
        self._lock = threading.Lock()

    def start(self) -> int:
        from horovod_tpu_torch.serve import telemetry
        telemetry.preregister_metrics()
        self._srv, self.port = _serve(self._handle, self._secret,
                                      port=self.port)
        announce_port(self.port)
        return self.port

    def stop(self) -> None:
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None

    # ---------------------------------------------------------- handler
    def _handle(self, req):
        kind = req[0]
        if kind == "infer":
            return self._infer(req[1], req[2] if len(req) > 2 else None)
        if kind == "stats":
            return ("ok", self.stats())
        if kind == "shutdown":
            # Order matters: close admission (batcher _drain, checked
            # under its lock by offer()) BEFORE waking the drain
            # watcher — the reverse order has a window where the
            # watcher sees quiesced and releases the replicas while an
            # in-flight _infer can still be accepted.
            self.batcher.set_drain(True)
            self.drain_requested.set()
            return ("ok", None)
        return ("error", f"unknown request {kind!r}")

    def _infer(self, payload, ctx=None) -> Tuple[str, Any]:
        from horovod_tpu_torch.serve import telemetry
        mx = telemetry.handles()
        t0 = time.perf_counter()
        if self.drain_requested.is_set():
            # Admission closes the moment drain is requested: a request
            # accepted after the queue flushes would have no replica
            # left to serve it and starve into a timeout — an
            # accepted-but-dropped request, which the zero-drop
            # guarantee forbids. A REJECTED request was never accepted.
            mx["request_status"]["rejected"].inc()
            with self._lock:
                self.rejected += 1
            return ("rejected", "service draining")
        r = self.batcher.offer(payload)
        if r is None:
            with self._lock:
                self.rejected += 1
            # offer() also rejects (atomically, under its lock) once
            # drain is set — name the real reason for a request that
            # raced past the unlocked check above.
            why = "service draining" if self.drain_requested.is_set() \
                else "queue full"
            return ("rejected", why)
        # Admission-time trace context: adopt the client's (when one
        # rode the RPC) or head-sample a fresh trace. The request's
        # span id is pre-allocated here so the queue/dispatch children
        # recorded by other threads already parent on it.
        r.trace = tracing.get().request_context(ctx)
        with self._lock:
            self.accepted += 1
        if not r.event.wait(self.request_timeout):
            # First outcome wins: if fail() loses a race with a
            # completion landing right now, the client still gets the
            # timeout, but the status counter is not double-booked.
            if r.fail("request timed out in the service"):
                mx["request_status"]["failed"].inc()
            # The worst-tail samples belong in the latency histogram
            # most of all — a failover p99 that excluded its timeouts
            # would look bounded through the very incident the metric
            # exists to expose.
            mx["request_seconds"].observe(time.perf_counter() - t0)
            with self._lock:
                self.failed += 1
            _record_request_trace(r, "timeout")
            return ("error", "request timed out")
        dt = time.perf_counter() - t0
        mx["request_seconds"].observe(dt)
        err = r.error  # hvdlint: disable=HVD101 -- published by event.set(); event.wait() above gives the happens-before
        if err is not None:
            with self._lock:
                self.failed += 1
            _record_request_trace(r, "error", error=err)
            return ("error", err)
        mx["request_status"]["completed"].inc()
        with self._lock:
            self.completed += 1
        _record_request_trace(r, "ok")
        return ("ok", r.result)  # hvdlint: disable=HVD101 -- published by event.set(); event.wait() above gives the happens-before

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            counts = {"accepted": self.accepted,
                      "completed": self.completed,
                      "failed": self.failed,
                      "rejected": self.rejected}
        counts["queue_depth"] = self.batcher.depth_now()
        return counts


def _record_request_trace(r, status: str,
                          error: Optional[str] = None) -> None:
    """Turn a decided request's lifecycle stamps into spans (the
    request lifecycle crosses threads, so spans are recorded
    retroactively — observability/tracing.py). The serve.request span
    claims the pre-allocated id from admission and is the local root:
    its end runs the tail-keep decision (error/timeout/requeued
    fragments survive ring eviction)."""
    ctx = r.trace
    if not ctx:
        return
    try:
        tr = tracing.get()
        # Request stamps are on the batcher's (monotonic, injectable)
        # clock; spans live on the wall clock so cross-process
        # fragments align — anchor the conversion at "now".
        now_m = r._clock()
        now_w = time.time()

        def wall(m: float) -> float:
            return now_w - (now_m - m)

        tid = ctx[tracing.CTX_TRACE]
        sid = ctx[tracing.CTX_SPAN]
        if r.t_dequeue is not None:
            tr.add_span("serve.queue", wall(r.t_enqueue),
                        max(0.0, r.t_dequeue - r.t_enqueue),
                        trace_id=tid, parent_id=sid)
        end_m = r.t_done if r.t_done is not None else now_m
        attrs: Dict[str, Any] = {"rid": r.rid, "requeues": r.requeues}
        if error:
            attrs["error"] = error
        tr.add_span("serve.request", wall(r.t_enqueue),
                    max(0.0, end_m - r.t_enqueue), trace_id=tid,
                    span_id=sid, parent_id=ctx.get("p"), status=status,
                    attrs=attrs, root=True)
    except Exception:
        pass  # tracing must never fail a request


class ServeClient:
    """Client handle: one persistent framed connection per instance
    (NOT thread-safe — load generators use one client per thread)."""

    def __init__(self, addr: Tuple[str, int],
                 secret: Optional[bytes] = None,
                 timeout: float = 90.0) -> None:
        self.addr = (addr[0], int(addr[1]))
        self._secret = _require_secret(secret)
        self.timeout = timeout
        self._sock = None

    def _conn(self):
        import socket
        if self._sock is None:
            self._sock = socket.create_connection(self.addr,
                                                  timeout=self.timeout)
        return self._sock

    def _call(self, req):
        s = self._conn()
        try:
            _send_frame(s, req, self._secret)
            return _recv_frame(s, self._secret)
        except (OSError, ConnectionError):
            self.close()
            raise

    def infer(self, payload) -> Any:
        """Submit one example; returns the result or raises on
        rejection/error (caller decides whether to retry a rejection)."""
        st = self.infer_raw(payload)
        if st[0] == "ok":
            return st[1]
        raise ServeRequestError(st[0], str(st[1]))

    def infer_raw(self, payload):
        """The raw (status, value) pair — load generators that count
        rejections separately from failures use this. Opens the
        client-side root span and rides its context on the request so
        the service's spans join the same trace."""
        sp = tracing.start_trace("serve.client")
        ctx = sp.context()
        req = ("infer", payload, ctx) if ctx else ("infer", payload)
        try:
            st = self._call(req)
        except BaseException as e:
            sp.end("error", error=f"{type(e).__name__}: {e}")
            raise
        sp.end("ok" if st and st[0] == "ok" else "error",
               outcome=st[0] if st else "?")
        return st

    def stats(self) -> Dict[str, Any]:
        st = self._call(("stats",))
        if st[0] != "ok":
            raise ServeRequestError(st[0], str(st[1]))
        return st[1]

    def shutdown(self) -> None:
        """Ask the service to drain and exit (authenticated)."""
        st = self._call(("shutdown",))
        if st[0] != "ok":
            raise ServeRequestError(st[0], str(st[1]))

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class ServeRequestError(RuntimeError):
    """A request the service rejected or failed."""

    def __init__(self, status: str, detail: str) -> None:
        super().__init__(f"{status}: {detail}")
        self.status = status
        self.detail = detail


def wait_for_port_file(path: str, timeout: float = 60.0) -> int:
    """Poll HOROVOD_SERVE_PORT_FILE until the launcher announces the
    frontend port (test/ops tooling)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                txt = f.read().strip()
            if txt:
                return int(txt)
        except (OSError, ValueError):
            pass
        time.sleep(0.1)
    raise TimeoutError(f"no serving port announced in {path}")


__all__ = ["Frontend", "ServeClient", "ServeRequestError",
           "announce_port", "wait_for_port_file"]
