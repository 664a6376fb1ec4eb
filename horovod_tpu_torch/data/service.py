"""Standalone data-preprocessing service (counterpart of
horovod_tpu/data/service.py; the wire format is the same, so a client
of either package reads a worker of the other).

Reference: horovod/tensorflow/data/compute_service.py (+compute_worker.py)
— a tf.data service (dispatcher + N workers) runs inside/alongside the
training job so input preprocessing scales independently of the trainers.

Trainers on the card must never stall on host preprocessing; the
service is framework-free (numpy batches over length-prefixed TCP
frames) and `device_stream` stages its batches onto the card through
data/data_loader.DeviceFeed. Topology follows the reference's two-sided
split:

  * `DataDispatcher` — registry only (worker addresses + pickled dataset
    fns). Batches never flow through it, so it is never a bandwidth
    bottleneck (the reference dispatcher likewise only coordinates).
  * `DataWorker` — owns shard `i of n` of a registered dataset: runs the
    user's `dataset_fn(shard, num_shards)` generator and serves batches
    to clients on demand, with a small prefetch queue per stream.
  * `DataServiceClient.stream(name)` — iterator over all shards'
    batches, fanned in round-robin from every worker.

All frames carry the job's HMAC digest (runner/secret.py); a secret is
REQUIRED (frames are pickled — see _require_secret) — same trust model
as the rendezvous KV.
"""

from __future__ import annotations

import pickle
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from horovod_tpu_torch.runner import secret as secret_mod

_LEN = struct.Struct("!I")
_MAX_FRAME = 1 << 30


class DataServiceError(RuntimeError):
    pass


def _require_secret(secret: Optional[bytes]) -> bytes:
    """Authentication is NOT optional: frames are pickled (and
    register_dataset ships cloudpickled callables by design), so an
    unauthenticated listener on 0.0.0.0 is arbitrary code execution for
    anyone who can reach the port. The reference's service wire protocol
    likewise requires the per-job secret unconditionally
    (runner/common/service/*, secret-keyed wire). Falls back to the job
    secret in HOROVOD_SECRET_KEY (set by the launcher)."""
    secret = secret or secret_mod.secret_from_env()
    if not secret:
        raise ValueError(
            "the data service requires an HMAC secret: pass secret=..., "
            "or run under the launcher / set HOROVOD_SECRET_KEY "
            "(see horovod_tpu_torch.runner.secret.make_secret_key)")
    return secret


# ----------------------------------------------------------------------
# framing
# ----------------------------------------------------------------------

def _send_frame(sock: socket.socket, obj: Any,
                secret: Optional[bytes]) -> None:
    # hvdtrace context propagation: when a sampled trace is ambient on
    # this thread, the frame object is wrapped so the causal identifier
    # crosses the process boundary. No wire-format change — the whole
    # object is pickled either way, and _recv_frame unwraps
    # transparently (observability/tracing.py).
    try:
        from horovod_tpu_torch.observability import tracing
        ctx = tracing.current_context()
        if ctx is not None and not tracing.suppressed():
            obj = {"__hvdtrace__": ctx, "o": obj}
    except Exception:
        pass  # tracing must never break the data plane
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    digest = (secret_mod.compute_digest(secret, "FRAME", "data", payload)
              .encode() if secret else b"")
    head = _LEN.pack(len(digest)) + digest + _LEN.pack(len(payload))
    sock.sendall(head + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


_MAX_DIGEST = 256  # hex sha256 is 64 bytes; anything bigger is hostile


def _recv_frame(sock: socket.socket, secret: Optional[bytes]) -> Any:
    dlen = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    if dlen > _MAX_DIGEST:
        raise DataServiceError(f"digest length {dlen} exceeds bound")
    digest = _recv_exact(sock, dlen) if dlen else b""
    plen = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    if plen > _MAX_FRAME:
        raise DataServiceError(f"frame too large: {plen}")
    payload = _recv_exact(sock, plen)
    if secret:
        if not secret_mod.check_digest(secret, "FRAME", "data", payload,
                                       digest.decode() if digest else None):
            raise DataServiceError("bad or missing frame HMAC")
    obj = pickle.loads(payload)
    if isinstance(obj, dict) and "__hvdtrace__" in obj and "o" in obj:
        # A trace context rode this frame: make it the receiving
        # thread's ambient parent, then hand the caller the original
        # object. Server loops clear the ambient context after each
        # handled request (_serve) so it cannot leak across requests.
        try:
            from horovod_tpu_torch.observability import tracing
            tracing.adopt(obj["__hvdtrace__"])
        except Exception:
            pass
        obj = obj["o"]
    return obj


def _routable_local_addr(peer: Tuple[str, int]) -> str:
    """The local address of the route to `peer` (no traffic sent)."""
    try:
        with socket.create_connection(peer, timeout=10) as s:
            return s.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())


def _rpc(addr: Tuple[str, int], obj: Any, secret: Optional[bytes],
         timeout: float = 30.0) -> Any:
    with socket.create_connection(addr, timeout=timeout) as s:
        _send_frame(s, obj, secret)
        return _recv_frame(s, secret)


class _FrameServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


def _serve(handler: Callable[[Any], Any], secret: Optional[bytes],
           port: int = 0) -> Tuple[_FrameServer, int]:
    class H(socketserver.BaseRequestHandler):
        def handle(self):
            # Persistent connections: serve request/response pairs until
            # the peer hangs up — the client's stream iterator holds one
            # socket per worker instead of reconnecting per batch.
            while True:
                try:
                    req = _recv_frame(self.request, secret)
                except (ConnectionError, OSError):
                    return
                except Exception as e:
                    # bad HMAC, unpicklable payload, oversized digest …:
                    # reply with a diagnosable error, then drop the peer
                    try:
                        _send_frame(self.request,
                                    ("error",
                                     f"{type(e).__name__}: {e}"), secret)
                    except (ConnectionError, OSError):
                        pass
                    return
                try:
                    resp = handler(req)
                except Exception as e:
                    resp = ("error", f"{type(e).__name__}: {e}")
                try:
                    _send_frame(self.request, resp, secret)
                except (ConnectionError, OSError):
                    return
                finally:
                    # A traced request's adopted context must not leak
                    # into the NEXT request on this persistent
                    # connection (the reply above still rides it).
                    try:
                        from horovod_tpu_torch.observability import tracing
                        tracing.clear()
                    except Exception:
                        pass

    srv = _FrameServer(("0.0.0.0", port), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


# ----------------------------------------------------------------------
# dispatcher
# ----------------------------------------------------------------------

class DataDispatcher:
    """Coordination point (reference: compute_service.py dispatcher side).

    Holds worker registrations and pickled dataset definitions; assigns
    shard ids first-come-first-served per dataset.
    """

    def __init__(self, expected_workers: int,
                 secret: Optional[bytes] = None):
        self.expected_workers = expected_workers
        self._secret = _require_secret(secret)
        self._lock = threading.Lock()
        self._workers: List[Tuple[str, int]] = []
        self._datasets: Dict[str, bytes] = {}
        self._shard_next: Dict[str, int] = {}
        self._srv = None
        self.port: Optional[int] = None

    def start(self) -> int:
        self._srv, self.port = _serve(self._handle, self._secret)
        return self.port

    def stop(self) -> None:
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None

    def _handle(self, req):
        kind = req[0]
        with self._lock:
            if kind == "register_worker":
                addr = tuple(req[1])
                if addr not in self._workers:
                    self._workers.append(addr)
                return ("ok", len(self._workers))
            if kind == "register_dataset":
                _, name, blob = req
                self._datasets[name] = blob
                self._shard_next.setdefault(name, 0)
                return ("ok", None)
            if kind == "get_dataset":
                _, name = req
                blob = self._datasets.get(name)
                if blob is None:
                    return ("pending", None)
                shard = self._shard_next[name]
                if shard >= self.expected_workers:
                    # All shards assigned: a late/restarted worker gets
                    # none — serving a wrapped shard id would silently
                    # duplicate data into training.
                    return ("exhausted", None)
                self._shard_next[name] = shard + 1
                return ("ok", (blob, shard, self.expected_workers))
            if kind == "workers":
                ready = len(self._workers) >= self.expected_workers
                return ("ok", (list(self._workers), ready))
            if kind == "datasets":
                return ("ok", list(self._datasets))
        return ("error", f"unknown request {kind!r}")


# ----------------------------------------------------------------------
# worker
# ----------------------------------------------------------------------

class DataWorker:
    """Owns one shard per registered dataset and serves its batches.

    `dataset_fn(shard, num_shards)` must return an iterator/generator of
    batches (any picklable object — typically dict of numpy arrays).
    A prefetch thread keeps `prefetch` batches ready per stream so client
    latency hides preprocessing time (reference analog: tf.data service
    workers prefetch; here it is explicit).
    """

    def __init__(self, dispatcher: Tuple[str, int],
                 secret: Optional[bytes] = None, prefetch: int = 4,
                 poll_interval: float = 0.1,
                 dispatcher_timeout: float = 300.0,
                 advertise_addr: Optional[str] = None):
        self.dispatcher = dispatcher
        self._secret = _require_secret(secret)
        self.advertise_addr = advertise_addr
        self.prefetch = prefetch
        self.poll_interval = poll_interval
        self.dispatcher_timeout = dispatcher_timeout
        self._streams: Dict[str, "_Stream"] = {}
        self._lock = threading.Lock()
        self._srv = None
        self.port: Optional[int] = None

    def start(self) -> int:
        self._srv, self.port = _serve(self._handle, self._secret)
        # Advertise the address the DISPATCHER route actually uses — on
        # multi-NIC/container hosts gethostbyname(gethostname()) commonly
        # resolves to 127.0.0.1 or an unroutable NIC (the silent failure
        # runner/network.py exists to fix).
        host = self.advertise_addr or _routable_local_addr(self.dispatcher)
        st = _rpc(self.dispatcher,
                  ("register_worker", (host, self.port)), self._secret)
        if st[0] != "ok":
            raise DataServiceError(f"worker registration failed: {st}")
        # Discover datasets proactively so prefetch starts at
        # registration time, not at the first client request.
        self._stopping = threading.Event()
        self._poller = threading.Thread(target=self._poll_datasets,
                                        daemon=True)
        self._poller.start()
        return self.port

    def _poll_datasets(self) -> None:
        while not self._stopping.is_set():
            try:
                st = _rpc(self.dispatcher, ("datasets",), self._secret,
                          timeout=5.0)
                if st[0] == "ok":
                    for name in st[1]:
                        self._stream(name)
            except (OSError, ConnectionError, DataServiceError):
                pass  # dispatcher restarting/stopping; retry
            self._stopping.wait(self.poll_interval)

    def stop(self) -> None:
        if getattr(self, "_stopping", None):
            self._stopping.set()
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None
        with self._lock:
            for s in self._streams.values():
                s.stop()

    def _stream(self, name: str) -> "_Stream":
        with self._lock:
            st = self._streams.get(name)
            if st is None:
                st = _Stream(self, name)
                self._streams[name] = st
            return st

    def _handle(self, req):
        if req[0] == "next_batch":
            _, name = req
            return self._stream(name).next_response()
        return ("error", f"unknown request {req[0]!r}")


class _Stream:
    """One dataset shard's produced-batch queue on a worker."""

    def __init__(self, worker: DataWorker, name: str):
        import queue

        self.name = name
        self.q: "queue.Queue" = queue.Queue(maxsize=worker.prefetch)
        self._done = False
        self._stop = threading.Event()
        self._worker = worker
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded-queue put that stays responsive to stop().

        A plain q.put() blocks FOREVER once the prefetch queue is full
        and the consumer is gone — the exact shape of an abrupt client
        disconnect: the handler thread dies with the connection, nobody
        drains the queue, and the producer thread leaks blocked in put()
        past worker.stop(). Poll with a short timeout instead, so the
        producer notices the stop flag and exits promptly.
        """
        import queue

        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        w = self._worker
        deadline = None  # armed at the FIRST failed poll, reset on success
        while not self._stop.is_set():  # wait for the dataset definition
            try:
                st = _rpc(w.dispatcher, ("get_dataset", self.name),
                          w._secret)
                deadline = None
            except (OSError, ConnectionError, DataServiceError) as e:
                # transient dispatcher outage: keep polling, but bounded —
                # dying silently here would leave clients blocked in
                # next_batch with no 'end'/'error' sentinel ever queued
                if deadline is None:
                    deadline = time.monotonic() + w.dispatcher_timeout
                if time.monotonic() > deadline:
                    self._put(("error",
                               f"dispatcher unreachable: {e}"))
                    self._put(("end", None))
                    return
                time.sleep(w.poll_interval)
                continue
            if st[0] == "ok":
                blob, shard, num_shards = st[1]
                break
            if st[0] == "exhausted":
                # late/restarted worker: no shard left — empty stream
                self._put(("end", None))
                return
            time.sleep(w.poll_interval)
        else:
            return
        try:
            # A cloudpickle blob names cloudpickle's own loaders, which
            # pickle imports as it reads them.
            fn = pickle.loads(blob)
            for batch in fn(shard, num_shards):
                if self._stop.is_set():
                    return
                if not self._put(("batch", batch)):
                    return  # stopped while the queue was full
        except Exception as e:  # surface preprocessing errors to clients
            self._put(("error", f"{type(e).__name__}: {e}"))
        self._put(("end", None))

    def next_response(self):
        item = self.q.get()
        if item[0] == "end":
            self._done = True
            self.q.put(item)  # keep returning end to later requests
        return item

    def stop(self):
        self._stop.set()


# ----------------------------------------------------------------------
# client
# ----------------------------------------------------------------------

class DataServiceClient:
    """Training-side handle (reference: compute_service.py's
    send_to_data_service / TfDataServiceConfig round trip)."""

    def __init__(self, dispatcher: Tuple[str, int],
                 secret: Optional[bytes] = None):
        self.dispatcher = dispatcher
        self._secret = _require_secret(secret)

    def register_dataset(self, name: str,
                         dataset_fn: Callable[[int, int], Iterator[Any]]
                         ) -> None:
        from horovod_tpu_torch.runner import _dumps

        # cloudpickle where installed (lambdas, closures); else plain
        # pickle, which sends a module-level function by import path.
        st = _rpc(self.dispatcher,
                  ("register_dataset", name, _dumps(dataset_fn)),
                  self._secret)
        if st[0] != "ok":
            raise DataServiceError(f"register_dataset failed: {st}")

    def wait_for_workers(self, timeout: float = 60.0) -> List[Tuple[str,
                                                                    int]]:
        deadline = time.monotonic() + timeout
        while True:
            st = _rpc(self.dispatcher, ("workers",), self._secret)
            workers, ready = st[1]
            if ready:
                return [tuple(w) for w in workers]
            if time.monotonic() > deadline:
                raise DataServiceError(
                    f"only {len(workers)} data workers registered "
                    f"before timeout")
            time.sleep(0.1)

    def device_stream(self, name: str, device=None, depth: int = 2,
                      timeout: float = 60.0):
        """`stream(name)` through the double-buffered device feed
        (data/data_loader.DeviceFeed; `device` defaults to hvd.device(),
        the card): the feed's prefetch thread pulls the next batch off
        the workers AND copies it to the card on its own stream while
        the current step runs, so the trainer pays neither worker
        latency nor the host-to-device copy on the critical path, and
        any residual starvation is measured as perfscope
        ``input_wait``. Call `.close()` when done (stops the prefetch
        thread; the worker connections close when the wrapped stream
        iterator is collected)."""
        from horovod_tpu_torch.data.data_loader import DeviceFeed

        return DeviceFeed(self.stream(name, timeout=timeout),
                          device=device, depth=depth)

    def stream(self, name: str, timeout: float = 60.0) -> Iterator[Any]:
        """Yield batches from every worker's shard, round-robin fan-in.

        One persistent connection per worker for the whole stream — this
        is the training hot path, so per-batch connect/teardown churn
        (latency + ephemeral ports) is not acceptable.
        """
        workers = self.wait_for_workers(timeout)
        conns: Dict[Tuple[str, int], socket.socket] = {}
        try:
            for addr in workers:
                try:
                    conns[addr] = socket.create_connection(
                        addr, timeout=timeout)
                except OSError as e:
                    raise DataServiceError(
                        f"cannot connect to data worker {addr}: {e}")
            live = list(workers)
            while live:
                for addr in list(live):
                    s = conns[addr]
                    _send_frame(s, ("next_batch", name), self._secret)
                    st = _recv_frame(s, self._secret)
                    if st[0] == "batch":
                        yield st[1]
                    elif st[0] == "end":
                        live.remove(addr)
                    elif st[0] == "error":
                        raise DataServiceError(
                            f"data worker {addr} failed: {st[1]}")
        finally:
            for s in conns.values():
                try:
                    s.close()
                except OSError:
                    pass


def run_worker(dispatcher_addr: str, secret: Optional[bytes] = None
               ) -> DataWorker:
    """Convenience entry (reference: compute_worker.py main): start one
    worker against `host:port` and return it running."""
    host, port = dispatcher_addr.rsplit(":", 1)
    w = DataWorker((host, int(port)),
                   secret=secret or secret_mod.secret_from_env())
    w.start()
    return w
