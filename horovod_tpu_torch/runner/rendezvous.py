"""HTTP key-value rendezvous server and client (counterpart of
horovod_tpu/runner/rendezvous.py, after horovod's KVStoreServer /
RendezvousServer).

Protocol, the same as the JAX package's, so either package's client
talks to either package's server:
  PUT    /<scope>/<key>   body = value bytes
  GET    /<scope>/<key>   200 + bytes | 404
  DELETE /<scope>/<key>

With a job secret (HOROVOD_SECRET_KEY, runner/secret.py) every request
must carry the HMAC digest header; a request without a valid one gets
403.

Observability: `GET /metrics` serves the whole job's metrics as
Prometheus text: the launcher's own registry (KV request counts and
latency, the elastic driver's counters) merged with every worker
snapshot the exporters pushed into the `metrics/` scope
(observability/export.py), a `rank` label telling the series apart,
and ranks that stopped pushing aged out. The route is read-only and
exempt from the HMAC check so a stock Prometheus scraper can reach it;
it serves telemetry only, never KV contents.

The client retries transient failures under the KV RetryPolicy and,
given several endpoints (HOROVOD_RENDEZVOUS_ADDRS, the replicated
control plane of runner/kv_ha.py), fails over to the replica that
claims the primary role. Its requests are the `kv.request`
fault-injection site (testing/faults.py) and flight-recorder events.
"""

from __future__ import annotations

import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.runner import secret as secret_mod

METRICS_SCOPE = "metrics"   # KV scope worker snapshots are pushed under
HOROVOD_RENDEZVOUS_PORT_FILE = "HOROVOD_RENDEZVOUS_PORT_FILE"
# Replica endpoint list for the replicated control plane (runner/kv_ha.py):
# "host:port[,host:port...]". Clients fold it into their endpoint set so
# exhausted retries against the current endpoint fail over to the next.
HOROVOD_RENDEZVOUS_ADDRS = "HOROVOD_RENDEZVOUS_ADDRS"

_kv_mx = None


def _metrics():
    """Lazy KV-server instrument handles (refreshed if the registry is
    reset under test)."""
    global _kv_mx
    from horovod_tpu_torch.observability import metrics as m
    reg = m.registry()
    if _kv_mx is None or _kv_mx[0] is not reg:
        _kv_mx = (reg, {
            "requests": reg.counter(
                "horovod_kv_requests_total",
                "KV requests served by the rendezvous server",
                labelnames=("method",)),
            "seconds": reg.histogram(
                "horovod_kv_request_seconds",
                "Rendezvous KV request service time",
                labelnames=("method",), buckets=m.TIME_BUCKETS),
            "scrapes": reg.counter(
                "horovod_metrics_scrapes_total",
                "GET /metrics scrapes served"),
        })
    return _kv_mx[1]


def announce_endpoints(endpoints: List[str]) -> None:
    """Write the rendezvous endpoint list ("host:port[,host:port...]")
    to HOROVOD_RENDEZVOUS_PORT_FILE (when set) so out-of-band tooling —
    a Prometheus scraper, `hvdtop`, `doctor --kv` — can find a job whose
    port was OS-assigned. Replicated control planes (runner/kv_ha.py)
    announce every replica, primary first."""
    path = os.environ.get(HOROVOD_RENDEZVOUS_PORT_FILE, "")
    if not path:
        return
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(",".join(endpoints))
    os.replace(tmp, path)


def announce_port(port: int) -> None:
    """Single-server announcement (loopback host, matching what the old
    bare-port file format implied to its readers)."""
    announce_endpoints([f"127.0.0.1:{port}"])


def parse_endpoints(text: str) -> List[Tuple[str, int]]:
    """Parse "host:port[,host:port...]"; a legacy bare "port" (the
    pre-HA port-file format) reads as a single loopback endpoint."""
    out: List[Tuple[str, int]] = []
    for part in text.strip().split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host:
            host, port = "127.0.0.1", part
        out.append((host, int(port)))
    return out


def read_endpoints(path: str) -> List[Tuple[str, int]]:
    """Read a HOROVOD_RENDEZVOUS_PORT_FILE announcement (either format)."""
    with open(path) as f:
        return parse_endpoints(f.read())


class _KVHandler(BaseHTTPRequestHandler):
    store: Dict[str, bytes] = {}  # guarded-by: lock
    # Server-clock arrival time per metrics/ key: staleness aging in
    # /metrics compares against THIS stamp, not the snapshot's own
    # worker-clock `time`, so cross-host clock skew cannot silently
    # drop a live rank from the scrape.
    put_times: Dict[str, float] = {}  # guarded-by: lock
    lock = threading.Lock()
    secret: Optional[bytes] = None

    def log_message(self, fmt, *args):  # silence request logging
        pass

    def _key(self) -> str:
        return self.path.lstrip("/")

    def _authorized(self, body: bytes) -> bool:
        if self.secret is None:
            return True
        return secret_mod.check_digest(
            self.secret, self.command, self.path, body,
            self.headers.get(secret_mod.DIGEST_HEADER))

    def _reject(self) -> None:
        self.send_response(403)
        self.end_headers()

    def do_PUT(self):
        t0 = time.perf_counter()
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        if not self._authorized(body):
            return self._reject()
        key = self._key()
        with self.lock:
            self.store[key] = body
            if key.startswith(METRICS_SCOPE + "/"):
                self.put_times[key] = time.time()
        self.send_response(200)
        self.end_headers()
        self._observe("PUT", t0)

    def do_GET(self):
        if self.path == "/metrics":
            return self._serve_metrics()
        t0 = time.perf_counter()
        if not self._authorized(b""):
            return self._reject()
        with self.lock:
            val = self.store.get(self._key())
        if val is None:
            self.send_response(404)
            self.end_headers()
            self._observe("GET", t0)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(val)))
        self.end_headers()
        self.wfile.write(val)
        self._observe("GET", t0)

    def do_DELETE(self):
        t0 = time.perf_counter()
        if not self._authorized(b""):
            return self._reject()
        with self.lock:
            self.store.pop(self._key(), None)
            self.put_times.pop(self._key(), None)
        self.send_response(200)
        self.end_headers()
        self._observe("DELETE", t0)

    # -------------------------------------------------------- observability
    def _observe(self, method: str, t0: float) -> None:
        try:
            mx = _metrics()
            mx["requests"].labels(method=method).inc()
            mx["seconds"].labels(method=method).observe(
                time.perf_counter() - t0)
        except Exception:
            pass  # telemetry must never fail a control-plane request

    def _serve_metrics(self) -> None:
        """One Prometheus page for the whole job: launcher registry +
        every pushed worker snapshot (scope `metrics/`)."""
        from horovod_tpu_torch.observability import metrics as m
        _metrics()["scrapes"].inc()
        reg = m.registry()
        snaps = [reg.snapshot()] if reg.enabled else []
        with self.lock:
            pushed = [(v, self.put_times.get(k))
                      for k, v in sorted(self.store.items())
                      if k.startswith(METRICS_SCOPE + "/")]
        worker_snaps = []
        for raw, arrived in pushed:
            snap = m.parse_snapshot(raw)
            if snap is not None:
                # Age against the SERVER-clock arrival stamp when one
                # exists (both HTTP pushes and server-side put() stamp
                # it): worker clock skew must not hide a live rank.
                if arrived is not None:
                    snap["time"] = arrived
                worker_snaps.append(snap)
        # Age out ranks that stopped refreshing their snapshot (evicted
        # or SIGKILL'd workers otherwise render frozen series forever):
        # keep only snapshots pushed within HOROVOD_METRICS_STALE_SECONDS.
        snaps.extend(m.fresh_snapshots(worker_snaps))
        body = m.render_snapshots(snaps).encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class RendezvousServer:
    """Threaded KV store (reference: RendezvousServer, http_server.py:259)."""

    def __init__(self, port: int = 0, secret: Optional[bytes] = None):
        handler = type("Handler", (_KVHandler,),
                       {"store": {}, "put_times": {},
                        "lock": threading.Lock(), "secret": secret})
        self._handler = handler
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True)
        self._thread.start()
        announce_port(self.port)
        return self.port

    def put(self, scope: str, key: str, value: bytes) -> None:
        full = f"{scope}/{key}"
        with self._handler.lock:
            self._handler.store[full] = value
            if full.startswith(METRICS_SCOPE + "/"):
                # Same arrival stamping as the HTTP PUT path: without it
                # launcher-written snapshots would be exempt from
                # HOROVOD_METRICS_STALE_SECONDS aging and a dead
                # launcher-side pusher would render frozen series forever.
                self._handler.put_times[full] = time.time()

    def worker_env(self, ip: str) -> Dict[str, str]:
        """The env entries a worker needs to reach this control plane
        (the HA variant adds the replica endpoint list)."""
        from horovod_tpu_torch.common import config as C
        return {C.HOROVOD_RENDEZVOUS_ADDR: ip,
                C.HOROVOD_RENDEZVOUS_PORT: str(self.port)}

    def get(self, scope: str, key: str) -> Optional[bytes]:
        with self._handler.lock:
            return self._handler.store.get(f"{scope}/{key}")

    def scope_items(self, scope: str) -> Dict[str, bytes]:
        """Every key under `scope/` (key suffix -> value). Used by the
        launcher at job end to persist the flight-recorder tails that
        SIGKILL'd workers pushed (observability/flight.py)."""
        pfx = f"{scope}/"
        with self._handler.lock:
            return {k[len(pfx):]: v for k, v in self._handler.store.items()
                    if k.startswith(pfx)}

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


_FROM_ENV = object()  # sentinel: secret=None must mean "really unsigned"


class KVClient:
    """Worker-side client (reference: http_client.py read_data_from_kvstore).
    By default signs with the job secret from HOROVOD_SECRET_KEY; pass
    secret=None explicitly for an unsigned client, or secret=<bytes> to
    override.

    Every request runs under a RetryPolicy (common/resilience.py, env
    prefix HOROVOD_KV_RETRY): transient transport failures — connection
    refused/reset while the rendezvous server restarts, timeouts, HTTP
    5xx — are retried with jittered exponential backoff up to the policy's
    attempt/deadline bounds. Non-transient responses (403 auth rejection,
    404 missing key) surface immediately: retrying them would mask a real
    error or add latency to the get() not-found poll.

    Multi-endpoint failover (runner/kv_ha.py): when the replicated
    control plane announces more than one endpoint
    (HOROVOD_RENDEZVOUS_ADDRS, or an explicit `endpoints=` list), an
    exhausted retry schedule or a 409 fencing/not-leader rejection
    rotates the client to the next endpoint, rediscovering the primary
    via each replica's unauthenticated `/leader` probe. With a single
    endpoint (the default, non-replicated server) behavior is byte-
    identical to before: RetryError and every HTTP error surface
    unchanged.
    """

    # GET polls for keys that do not exist yet (assignment publication
    # races): back off from POLL_BASE doubling to POLL_CAP instead of the
    # old fixed 50 ms busy-wait.
    POLL_BASE = 0.02
    POLL_CAP = 0.5
    # Pause between failover sweeps that found NO replica claiming the
    # primary role — promotion (kv_ha coordinator) takes a probe
    # interval or two to land.
    FAILOVER_PAUSE = 0.2

    def __init__(self, addr: str, port: int, secret=_FROM_ENV,
                 retry_policy=None, request_timeout: Optional[float] = None,
                 endpoints: Optional[List[str]] = None):
        from horovod_tpu_torch.common import resilience
        eps = [f"{addr}:{port}"]
        if endpoints is None:
            extra = [f"{h}:{p}" for h, p in parse_endpoints(
                os.environ.get(HOROVOD_RENDEZVOUS_ADDRS, ""))]
        else:
            extra = list(endpoints)
        for e in extra:
            if e not in eps:
                eps.append(e)
        self.endpoints = eps
        self.base = f"http://{eps[0]}"
        self.secret = secret_mod.secret_from_env() \
            if secret is _FROM_ENV else secret
        self.retry = retry_policy if retry_policy is not None \
            else resilience.kv_retry_policy()
        # Per-request socket timeout override. The retry DEADLINE only
        # bounds time between attempts — a single blackholed connect
        # otherwise blocks for the full default urlopen timeout (30 s for
        # PUTs), which is what low-latency callers (telemetry pushes
        # inside shutdown) must cap.
        self.request_timeout = request_timeout
        self.attempts = 0   # total request attempts (test observability)
        self.failovers = 0  # endpoint rotations (test observability)

    def _request_once(self, method: str, path: str, data: Optional[bytes]):
        import urllib.request

        from horovod_tpu_torch.testing import faults
        self.attempts += 1
        faults.inject("kv.request")
        req = urllib.request.Request(f"{self.base}{path}", data=data,
                                     method=method)
        if self.secret is not None:
            req.add_header(
                secret_mod.DIGEST_HEADER,
                secret_mod.compute_digest(self.secret, method, path,
                                          data or b""))
        timeout = self.request_timeout if self.request_timeout is not None \
            else (30 if data else 10)
        return urllib.request.urlopen(req, timeout=timeout)

    def _request(self, method: str, path: str, data: Optional[bytes]):
        import urllib.error

        from horovod_tpu_torch.common.resilience import RetryError
        if len(self.endpoints) == 1:
            # Non-replicated control plane: exactly the pre-HA behavior
            # (RetryError and every HTTP error surface to the caller).
            return self.retry.call(self._request_once, method, path, data)
        last: Optional[BaseException] = None
        for _ in range(2 * len(self.endpoints)):
            try:
                return self.retry.call(self._request_once, method, path,
                                       data)
            except RetryError as e:
                last = e      # endpoint dead/unreachable: try the next
            except urllib.error.HTTPError as e:
                if e.code != 409:
                    raise     # 403/404/...: a real answer, not a failover
                last = e      # standby or fenced ex-primary: find leader
            self._failover()
        assert last is not None
        raise last

    def _failover(self) -> None:
        """Rediscover the primary after the current endpoint failed:
        probe every endpoint's unauthenticated `GET /leader` and move the
        replica claiming role=="primary" with the highest epoch to the
        front. If nobody claims leadership yet (promotion in flight),
        rotate blindly and pause FAILOVER_PAUSE before the next sweep."""
        import json
        import urllib.request
        old = self.endpoints[0]
        best = None  # (epoch, endpoint)
        for ep in self.endpoints:
            try:
                with urllib.request.urlopen(f"http://{ep}/leader",
                                            timeout=2) as r:
                    info = json.loads(r.read().decode("utf-8"))
            except Exception:
                continue
            if info.get("role") == "primary":
                e = int(info.get("epoch", 0))
                if best is None or e > best[0]:
                    best = (e, ep)
        self.failovers += 1
        if best is not None:
            self.endpoints.remove(best[1])
            self.endpoints.insert(0, best[1])
        else:
            self.endpoints.append(self.endpoints.pop(0))
            time.sleep(self.FAILOVER_PAUSE)
        self.base = f"http://{self.endpoints[0]}"
        if self.endpoints[0] != old:
            self._flight(f"failover {old} -> {self.endpoints[0]}")

    @staticmethod
    def _flight(desc: str) -> None:
        """KV ops are flight-recorder events (observability/flight.py);
        the recorder suppresses its own flush traffic."""
        try:
            from horovod_tpu_torch.observability import flight
            flight.record("kv", desc)
        except Exception:
            pass

    def put(self, scope: str, key: str, value: bytes) -> None:
        self._flight(f"PUT /{scope}/{key} ({len(value)}B)")
        self._request("PUT", f"/{scope}/{key}", value).read()

    def delete(self, scope: str, key: str) -> None:
        import urllib.error
        self._flight(f"DELETE /{scope}/{key}")
        try:
            self._request("DELETE", f"/{scope}/{key}", None)
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def get(self, scope: str, key: str,
            timeout: float = 30.0) -> Optional[bytes]:
        """Fetch a key, polling through 404 until `timeout` (None after).

        Two distinct waits compose here: transient transport/5xx failures
        retry INSIDE _request under the KV policy (the server is sick);
        404 polls OUT HERE under the caller's timeout with capped
        exponential backoff (the server is healthy, the key just is not
        written yet — e.g. the next round's assignment).
        """
        import time
        import urllib.error
        if timeout > 0:
            # Zero-timeout gets are background pollers (the elastic
            # round watcher, verifier peer probes) ticking at sub-second
            # cadence — recording those would evict the ring history
            # that matters. Blocking gets are decisions worth keeping.
            self._flight(f"GET /{scope}/{key} (timeout={timeout:.0f}s)")
        deadline = time.monotonic() + timeout
        delay = self.POLL_BASE
        while True:
            try:
                return self._request("GET", f"/{scope}/{key}", None).read()
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    raise
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                time.sleep(min(delay, remaining))
                delay = min(delay * 2, self.POLL_CAP)
