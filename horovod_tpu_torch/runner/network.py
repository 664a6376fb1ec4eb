"""Host/NIC mutual discovery (counterpart of horovod_tpu/runner/network.py).

Multi-NIC hosts publish the wrong control-plane address silently, so
before a multi-host launch the launcher runs one probe service, each
remote host runs `probe_main` once and reports which of the launcher's
addresses it reached, and the launcher takes the first address every
host reached.

Wire format: HMAC-signed, length-prefixed pickle frames, the JAX
package's data-service frames (horovod_tpu/data/service.py), of which
this module keeps its own copy.
"""

from __future__ import annotations

import pickle
import socket
import socketserver
import struct
import threading
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.runner import secret as secret_mod

_LEN = struct.Struct("!I")
_MAX_FRAME = 1 << 30
_MAX_DIGEST = 256  # hex sha256 is 64 bytes; anything bigger is hostile


def _send_frame(sock: socket.socket, obj: Any,
                secret: Optional[bytes]) -> None:
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


def _recv_frame(sock: socket.socket, secret: Optional[bytes]) -> Any:
    dlen = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    if dlen > _MAX_DIGEST:
        raise HorovodError(f"digest length {dlen} exceeds bound")
    digest = _recv_exact(sock, dlen) if dlen else b""
    plen = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    if plen > _MAX_FRAME:
        raise HorovodError(f"frame too large: {plen}")
    payload = _recv_exact(sock, plen)
    if secret:
        if not secret_mod.check_digest(secret, "FRAME", "data", payload,
                                       digest.decode() if digest else None):
            raise HorovodError("bad or missing frame HMAC")
    return pickle.loads(payload)


class _FrameServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


def _serve(handler: Callable[[Any], Any], secret: Optional[bytes],
           port: int = 0) -> Tuple[_FrameServer, int]:
    """Serve request/response frame pairs on each connection until the
    peer hangs up; `handler(request)` gives the response."""
    class H(socketserver.BaseRequestHandler):
        def handle(self):
            while True:
                try:
                    req = _recv_frame(self.request, secret)
                except (ConnectionError, OSError):
                    return
                except Exception as e:
                    # bad HMAC, unpicklable payload, oversized digest:
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

    srv = _FrameServer(("0.0.0.0", port), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


def local_interfaces(include_loopback: bool = False
                     ) -> Dict[str, List[str]]:
    """nic name -> IPv4 addresses on this host (psutil.net_if_addrs).
    Without psutil, the default-route address: one candidate is enough
    for a host with one NIC."""
    try:
        import psutil
    except ImportError:
        from horovod_tpu_torch.runner.launch import _local_ip

        addr = _local_ip()
        if not include_loopback and addr.startswith("127."):
            return {}
        return {"default": [addr]}

    out: Dict[str, List[str]] = {}
    for nic, addrs in psutil.net_if_addrs().items():
        v4 = [a.address for a in addrs if a.family == socket.AF_INET]
        if not include_loopback:
            v4 = [a for a in v4 if not a.startswith("127.")]
        if v4:
            out[nic] = v4
    return out


def _reachable(addr: str, port: int, timeout: float) -> bool:
    try:
        with socket.create_connection((addr, port), timeout=timeout):
            return True
    except OSError:
        return False


class NicProbeService:
    """Launcher-side collector.

    Hosts send their report = (hostname, local NICs, which of the
    launcher's advertised addresses they could reach); the launcher waits
    for all of them, then computes the common routable launcher address
    + per-host NIC map.
    """

    def __init__(self, expected_hosts: int,
                 secret: Optional[bytes] = None):
        self.expected = expected_hosts
        self._secret = secret
        self._reports: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._done = threading.Event()
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
        if req[0] == "report":
            _, hostname, nics, reachable = req
            with self._lock:
                self._reports[hostname] = {
                    "nics": nics, "reachable": list(reachable)}
                if len(self._reports) >= self.expected:
                    self._done.set()
            return ("ok", None)
        if req[0] == "ping":
            return ("ok", None)
        return ("error", f"unknown request {req[0]!r}")

    def wait(self, timeout: float = 60.0) -> Dict[str, dict]:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"only {len(self._reports)}/{self.expected} hosts "
                f"reported NIC probes")
        with self._lock:
            return dict(self._reports)

    def common_launcher_addresses(self,
                                  candidates: List[str]) -> List[str]:
        """Launcher addresses every reported host could reach, in the
        candidate order."""
        with self._lock:
            sets: List[Set[str]] = [set(r["reachable"])
                                    for r in self._reports.values()]
        common = set(candidates).intersection(*sets) if sets else \
            set(candidates)
        return [c for c in candidates if c in common]


def probe_main(service_addrs: List[str], port: int,
               hostname: Optional[str] = None,
               secret: Optional[bytes] = None,
               timeout: float = 5.0) -> List[str]:
    """Host-side probe: test each launcher address, report local NICs + the reachable subset.
    Returns the reachable subset."""
    reachable = [a for a in service_addrs if _reachable(a, port, timeout)]
    if not reachable:
        raise ConnectionError(
            f"none of the launcher addresses {service_addrs} are "
            f"reachable from {hostname or socket.gethostname()}")
    with socket.create_connection((reachable[0], port),
                                  timeout=timeout) as s:
        _send_frame(s, ("report", hostname or socket.gethostname(),
                        local_interfaces(), reachable), secret)
        st = _recv_frame(s, secret)
    if st[0] != "ok":
        raise ConnectionError(f"probe report rejected: {st}")
    return reachable


def discover_common_address(hosts: List[str], ssh_probe,
                            expected_hosts: Optional[int] = None,
                            secret: Optional[bytes] = None,
                            timeout: float = 60.0) -> str:
    """Full flow: start the service, run `ssh_probe(host, addrs, port)`
    per host (injected: tests use threads, the launcher SSHes
    `python -m horovod_tpu_torch.runner.network`), wait for reports, return
    the first launcher address every host can reach.

    Reports are keyed by the launcher's OWN name for each host (the ssh
    target), not the remote's gethostname() — containers and minimal
    images commonly share a default hostname, which would collapse
    distinct hosts onto one report key and hang the wait.

    `ssh_probe` may return a process handle (anything with .poll() →
    None while running, exit code after); probe failures then fail fast
    instead of burning the whole timeout.
    """
    import time as _time

    candidates = [a for addrs in local_interfaces().values()
                  for a in addrs]
    if not candidates:
        candidates = ["127.0.0.1"]
    svc = NicProbeService(expected_hosts or len(hosts), secret=secret)
    port = svc.start()
    handles: Dict[str, object] = {}
    try:
        for h in hosts:
            handles[h] = ssh_probe(h, candidates, port)
        deadline = _time.monotonic() + timeout
        while not svc._done.wait(0.2):
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {len(svc._reports)}/{svc.expected} hosts "
                    f"reported NIC probes")
            with svc._lock:
                reported = set(svc._reports)
            failed = [h for h, p in handles.items()
                      if h not in reported and p is not None
                      and getattr(p, "poll", lambda: None)()
                      not in (None, 0)]
            pending = [h for h in hosts if h not in reported
                       and h not in failed]
            if failed and not pending:
                raise ConnectionError(
                    f"NIC probe failed on host(s) {failed} "
                    f"(ssh or probe-port failure)")
        common = svc.common_launcher_addresses(candidates)
        if not common:
            raise ConnectionError(
                "no launcher address is reachable from every host; "
                "check firewalls or pass --network-interface")
        return common[0]
    finally:
        for p in handles.values():  # reap exited ssh children
            try:
                if p is not None and hasattr(p, "wait"):
                    p.wait(timeout=0.5)
            except Exception:
                pass
        svc.stop()


def _cli() -> None:
    """`python -m horovod_tpu_torch.runner.network <addr,...> <port> [name]` —
    what the launcher SSHes onto each host. `name` is the launcher's ssh
    target for this host, used as the report key (remote gethostname()
    is not unique across containers)."""
    import sys

    from horovod_tpu_torch.runner import secret as secret_mod

    addrs = sys.argv[1].split(",")
    port = int(sys.argv[2])
    name = sys.argv[3] if len(sys.argv) > 3 else None
    got = probe_main(addrs, port, hostname=name,
                     secret=secret_mod.secret_from_env())
    print("reachable:", ",".join(got))


if __name__ == "__main__":
    _cli()
