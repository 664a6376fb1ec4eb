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

Left out until ROADMAP A13 ports observability and the replicated
control plane: the `GET /metrics` route, the KV request metrics and the
flight-recorder and fault-injection hooks (they only observe), and the
client's failover across replicas (it decides, so a client given more
than one endpoint raises HorovodError).
"""

from __future__ import annotations

import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.common import config as C
from horovod_tpu_torch.common import resilience
from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.runner import secret as secret_mod

HOROVOD_RENDEZVOUS_PORT_FILE = "HOROVOD_RENDEZVOUS_PORT_FILE"
# Replica endpoint list of the replicated control plane ("host:port,...").
HOROVOD_RENDEZVOUS_ADDRS = "HOROVOD_RENDEZVOUS_ADDRS"


def announce_endpoints(endpoints: List[str]) -> None:
    """Write the endpoint list ("host:port[,host:port...]") to
    HOROVOD_RENDEZVOUS_PORT_FILE, when set, so out-of-band tooling can
    find a job whose port the OS assigned."""
    path = os.environ.get(HOROVOD_RENDEZVOUS_PORT_FILE, "")
    if not path:
        return
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(",".join(endpoints))
    os.replace(tmp, path)


def parse_endpoints(text: str) -> List[Tuple[str, int]]:
    """Parse "host:port[,host:port...]"; a bare "port" reads as a
    loopback endpoint."""
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


class _KVHandler(BaseHTTPRequestHandler):
    store: Dict[str, bytes] = {}  # guarded-by: lock
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
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        if not self._authorized(body):
            return self._reject()
        with self.lock:
            self.store[self._key()] = body
        self.send_response(200)
        self.end_headers()

    def do_GET(self):
        if not self._authorized(b""):
            return self._reject()
        with self.lock:
            val = self.store.get(self._key())
        if val is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(val)))
        self.end_headers()
        self.wfile.write(val)

    def do_DELETE(self):
        if not self._authorized(b""):
            return self._reject()
        with self.lock:
            self.store.pop(self._key(), None)
        self.send_response(200)
        self.end_headers()


class RendezvousServer:
    """Threaded KV store on all interfaces, port chosen by the OS unless
    given."""

    def __init__(self, port: int = 0, secret: Optional[bytes] = None):
        handler = type("Handler", (_KVHandler,),
                       {"store": {}, "lock": threading.Lock(),
                        "secret": secret})
        self._handler = handler
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        announce_endpoints([f"127.0.0.1:{self.port}"])
        return self.port

    def put(self, scope: str, key: str, value: bytes) -> None:
        with self._handler.lock:
            self._handler.store[f"{scope}/{key}"] = value

    def get(self, scope: str, key: str) -> Optional[bytes]:
        with self._handler.lock:
            return self._handler.store.get(f"{scope}/{key}")

    def scope_items(self, scope: str) -> Dict[str, bytes]:
        """Every key under `scope/` (key suffix -> value): the launcher
        persists the perfscope summaries the workers pushed."""
        pfx = f"{scope}/"
        with self._handler.lock:
            return {k[len(pfx):]: v for k, v in self._handler.store.items()
                    if k.startswith(pfx)}

    def worker_env(self, ip: str) -> Dict[str, str]:
        """The env entries a worker needs to reach this server."""
        return {C.HOROVOD_RENDEZVOUS_ADDR: ip,
                C.HOROVOD_RENDEZVOUS_PORT: str(self.port)}

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


_FROM_ENV = object()  # sentinel: secret=None must mean "really unsigned"


class KVClient:
    """Worker-side client. Signs with the job secret from
    HOROVOD_SECRET_KEY by default; secret=None gives an unsigned client,
    secret=<bytes> another key. A replica list in HOROVOD_RENDEZVOUS_ADDRS
    naming another endpoint raises HorovodError (failover: ROADMAP A13).

    Every request runs under the KV RetryPolicy (common/resilience.py,
    env prefix HOROVOD_KV_RETRY): connection failures, timeouts and HTTP
    5xx are retried with jittered backoff up to its attempt and deadline
    bounds; 403 and 404 surface at once.
    """

    # GET polls for keys not written yet: back off from POLL_BASE,
    # doubling, up to POLL_CAP.
    POLL_BASE = 0.02
    POLL_CAP = 0.5

    def __init__(self, addr: str, port: int, secret=_FROM_ENV,
                 retry_policy=None, request_timeout: Optional[float] = None):
        primary = f"{addr}:{port}"
        endpoints = [f"{h}:{p}" for h, p in parse_endpoints(
            os.environ.get(HOROVOD_RENDEZVOUS_ADDRS, ""))]
        if any(e != primary for e in endpoints):
            raise HorovodError(
                f"KVClient: failover across rendezvous replicas "
                f"({', '.join(endpoints)}) is not ported yet (ROADMAP A13)")
        self.base = f"http://{primary}"
        self.secret = secret_mod.secret_from_env() \
            if secret is _FROM_ENV else secret
        self.retry = retry_policy if retry_policy is not None \
            else resilience.kv_retry_policy()
        self.request_timeout = request_timeout

    def _request_once(self, method: str, path: str, data: Optional[bytes]):
        req = urllib.request.Request(f"{self.base}{path}", data=data,
                                     method=method)
        if self.secret is not None:
            req.add_header(
                secret_mod.DIGEST_HEADER,
                secret_mod.compute_digest(self.secret, method, path,
                                          data or b""))
        timeout = self.request_timeout
        if timeout is None:
            timeout = 30 if data else 10
        return urllib.request.urlopen(req, timeout=timeout)

    def _request(self, method: str, path: str, data: Optional[bytes]):
        return self.retry.call(self._request_once, method, path, data)

    def put(self, scope: str, key: str, value: bytes) -> None:
        self._request("PUT", f"/{scope}/{key}", value).read()

    def delete(self, scope: str, key: str) -> None:
        try:
            self._request("DELETE", f"/{scope}/{key}", None)
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def get(self, scope: str, key: str,
            timeout: float = 30.0) -> Optional[bytes]:
        """Fetch a key, polling through 404 until `timeout` (None after).

        Transport failures retry inside `_request` under the KV policy;
        a 404 (the key is not written yet) polls here under the caller's
        timeout with capped exponential backoff.
        """
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
