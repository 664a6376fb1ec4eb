"""Replicated rendezvous control plane: KV failover with epoch fencing
(counterpart of horovod_tpu/runner/kv_ha.py).

Every resilience guarantee of the launcher (elastic round assignments,
the `ckpt/latest` exactly-once resume pointer, the flight/perf/trace
records it persists) funnels through one in-process `RendezvousServer`
(runner/rendezvous.py). This module removes that
single point of failure the same way production coordination services do
(Raft, Ongaro & Ousterhout, USENIX ATC '14; ZooKeeper, Hunt et al.,
USENIX ATC '10): a small replicated log under fenced leadership.

Topology: the launcher spawns HOROVOD_KV_REPLICAS replica subprocesses
(`python -m horovod_tpu_torch.runner.kv_ha`), each a :class:`ReplicaNode` —
the familiar KV HTTP server plus a replication protocol:

* The PRIMARY owns a monotone **epoch** and stamps every accepted
  PUT/DELETE into a sequence-numbered log entry, replicating it
  synchronously to EVERY live standby **before** applying locally and
  acking the client. A write the client saw acknowledged therefore
  exists on every live replica — failover never loses it.
* A standby applies entries in seq order; a gap (it joined late or
  missed traffic while partitioned) answers 412 and the primary catches
  it up from the bounded log tail, falling back to a full snapshot.
* **Fencing**: every entry carries the primary's epoch. A standby that
  has adopted a higher epoch answers 409; the stale primary DEMOTES
  itself and propagates the 409 to its client without applying — a
  paused-then-revived primary cannot split-brain the store, because a
  fenced write is rejected before any replica (including the fenced
  primary itself) applies it.
* Standbys answer client data ops with 409 + a `/leader` hint, so a
  client that wandered to the wrong replica rediscovers the primary
  (KVClient multi-endpoint failover, runner/rendezvous.py).

The launcher-side :class:`HAControlPlane` supervises the replicas: it
promotes replica 0 under epoch 1 at start, polls the subprocess handles
every HOROVOD_KV_PROBE_INTERVAL seconds, and on primary death promotes a
deterministic successor — the live replica with the HIGHEST applied seq,
lowest replica id breaking ties — under epoch+1. Each failover emits a
`kv-failover` flight event and bumps the `horovod_kv_ha_*` metrics family.

`HOROVOD_KV_REPLICAS=1` (the default) never constructs any of this:
:func:`start_control_plane` returns the plain in-process
`RendezvousServer`, byte-identical wire behavior, zero cost.

Chaos hooks (testing/faults.py): the primary's client-write path injects
at `kv_ha.put.r<replica_id>` — a per-replica-id site, so a
`kind=host_kill` rule can SIGKILL exactly the initial primary's process
group without also firing inside its successor. Outbound replication
injects at `kv_ha.replicate.r<replica_id>` with the peer endpoint as
context, so `match=` rules can cut one link (network partition).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.runner import secret as secret_mod
from horovod_tpu_torch.runner.rendezvous import (HOROVOD_RENDEZVOUS_ADDRS,
                                           METRICS_SCOPE, KVClient,
                                           RendezvousServer, _KVHandler,
                                           announce_endpoints)

HOROVOD_KV_REPLICAS = "HOROVOD_KV_REPLICAS"
HOROVOD_KV_PROBE_INTERVAL = "HOROVOD_KV_PROBE_INTERVAL"

#: Replication-log entries kept for tail catch-up; a standby further
#: behind than this gets a full snapshot instead.
LOG_TAIL_MAX = 4096

_ha_mx = None


def _ha_metrics():
    """Lazy `horovod_kv_ha_*` instrument handles (refreshed if the
    registry is reset under test)."""
    global _ha_mx
    from horovod_tpu_torch.observability import metrics as m
    reg = m.registry()
    if _ha_mx is None or _ha_mx[0] is not reg:
        _ha_mx = (reg, {
            "failovers": reg.counter(
                "horovod_kv_ha_failovers_total",
                "Control-plane primary failovers"),
            "epoch": reg.gauge(
                "horovod_kv_ha_epoch",
                "Current control-plane leadership epoch"),
            "replicas": reg.gauge(
                "horovod_kv_ha_replicas_live",
                "Live KV control-plane replicas"),
            "applied": reg.gauge(
                "horovod_kv_ha_applied_seq",
                "Applied replication seq at the current primary"),
            "lag": reg.gauge(
                "horovod_kv_ha_catchup_lag",
                "Entries the promoted primary trailed the best live "
                "replica by at the last failover"),
        })
    return _ha_mx[1]


def _flight(desc: str) -> None:
    """Control-plane lifecycle/failover events for the doctor's
    [control-plane] section."""
    try:
        from horovod_tpu_torch.observability import flight
        flight.record("kv-failover", desc)
    except Exception:
        pass


class _ReplicaHandler(_KVHandler):
    """KV HTTP handler with the replication protocol routes. Client data
    ops are gated on leadership; `store`/`put_times`/`lock` class attrs
    alias the owning ReplicaNode's state so the inherited `/metrics`
    merge route works unchanged."""

    node: "ReplicaNode"

    def _json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _not_leader(self) -> None:
        # 409 (not 503): "you asked the wrong replica / a stale epoch" is
        # a protocol answer the client must act on (leader rediscovery),
        # not a transient server fault RetryPolicy should hammer.
        self._json(409, self.node.leader_info())

    def do_GET(self):
        if self.path == "/leader":
            # Unauthenticated, like /metrics: failover probes must work
            # from tooling that has no job secret, and the payload is
            # role/epoch telemetry, never KV contents.
            return self._json(200, self.node.leader_info())
        if self.path == "/metrics":
            return self._serve_metrics()
        t0 = time.perf_counter()
        if not self._authorized(b""):
            return self._reject()
        if self.path.startswith("/hakv/scope/"):
            scope = self.path[len("/hakv/scope/"):]
            ok, items = self.node.client_scope(scope)
            if not ok:
                return self._not_leader()
            return self._json(200, {
                k: base64.b64encode(v).decode("ascii")
                for k, v in items.items()})
        ok, val = self.node.client_get(self._key())
        if not ok:
            return self._not_leader()
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

    def do_PUT(self):
        t0 = time.perf_counter()
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        if not self._authorized(body):
            return self._reject()
        if not self.node.client_write("put", self._key(), body):
            return self._not_leader()
        self.send_response(200)
        self.end_headers()
        self._observe("PUT", t0)

    def do_DELETE(self):
        t0 = time.perf_counter()
        if not self._authorized(b""):
            return self._reject()
        if not self.node.client_write("delete", self._key(), b""):
            return self._not_leader()
        self.send_response(200)
        self.end_headers()
        self._observe("DELETE", t0)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        if not self._authorized(body):
            return self._reject()
        try:
            msg = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            self.send_response(400)
            self.end_headers()
            return
        routes = {"/replicate": self.node.on_replicate,
                  "/snapshot": self.node.on_snapshot,
                  "/promote": self.node.on_promote,
                  "/config": self.node.on_config}
        fn = routes.get(self.path)
        if fn is None:
            self.send_response(404)
            self.end_headers()
            return
        code, resp = fn(msg)
        self._json(code, resp)


class ReplicaNode:
    """One replica: KV server + replication/fencing state machine.

    Runs standalone inside a replica subprocess (see :func:`replica_main`)
    or in-process for unit tests. All protocol state is guarded by
    `_lock`; whole client writes additionally serialize under
    `_write_lock` (lock order: `_write_lock` then `_lock`) so the
    replicate-to-all-then-apply sequence is atomic with respect to
    concurrent writers — the log is totally ordered without any
    per-entry negotiation, which a single-digit-writes-per-round control
    plane never needs.
    """

    def __init__(self, replica_id: int, port: int = 0,
                 secret: Optional[bytes] = None):
        from http.server import ThreadingHTTPServer
        self.replica_id = replica_id
        self.secret = secret
        # Re-entrant: the self-locking helpers (_apply, _leader_info)
        # compose under an already-held _lock.
        self._lock = threading.RLock()
        self._write_lock = threading.Lock()
        self.store: Dict[str, bytes] = {}       # guarded-by: _lock
        self.put_times: Dict[str, float] = {}   # guarded-by: _lock
        self.role = "standby"                   # guarded-by: _lock
        self.epoch = 0                          # guarded-by: _lock
        self.applied_seq = 0                    # guarded-by: _lock
        self.log: List[dict] = []               # guarded-by: _lock
        self.peers: List[str] = []              # guarded-by: _lock
        self.leader = ""                        # guarded-by: _lock
        self.fenced = False                     # guarded-by: _lock
        handler = type("ReplicaHandler", (_ReplicaHandler,),
                       {"node": self, "store": self.store,
                        "put_times": self.put_times, "lock": self._lock,
                        "secret": secret})
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # ------------------------------------------------------------ leadership
    def _leader_info(self) -> dict:
        with self._lock:
            return {"role": self.role, "replica_id": self.replica_id,
                    "epoch": self.epoch, "applied_seq": self.applied_seq,
                    "leader": self.leader, "pid": os.getpid()}

    def leader_info(self) -> dict:
        return self._leader_info()

    def _is_self(self, endpoint: str) -> bool:
        return endpoint.endswith(f":{self.port}")

    def _demote(self, info: dict) -> None:
        """A peer fenced us (it runs a higher epoch): step down NOW.
        The in-flight write that discovered this is propagated to the
        client as 409 without ever being applied anywhere."""
        with self._lock:
            self.fenced = True
            self.role = "standby"
            self.epoch = max(self.epoch, int(info.get("epoch", 0)))
            if info.get("leader"):
                self.leader = str(info["leader"])

    # ------------------------------------------------------------ client ops
    def client_get(self, key: str) -> Tuple[bool, Optional[bytes]]:
        with self._lock:
            if self.role != "primary" or self.fenced:
                return False, None
            return True, self.store.get(key)

    def client_scope(self, scope: str) -> Tuple[bool, Dict[str, bytes]]:
        pfx = f"{scope}/"
        with self._lock:
            if self.role != "primary" or self.fenced:
                return False, {}
            return True, {k[len(pfx):]: v for k, v in self.store.items()
                          if k.startswith(pfx)}

    def client_write(self, op: str, key: str, value: bytes) -> bool:
        """Primary write path: replicate to every peer BEFORE applying
        locally and acking. False means 409 to the client — either this
        replica is not the primary, or it WAS and a successor's higher
        epoch fenced the write mid-flight."""
        from horovod_tpu_torch.testing import faults
        with self._write_lock:
            head = self._write_head()
            if head is None:
                return False
            wepoch, seq, targets = head
            # Host-level chaos site: a host_kill rule here takes the
            # whole primary process group down mid-write, exactly the
            # window where an un-replicated ack would lose data.
            faults.inject(f"kv_ha.put.r{self.replica_id}")
            entry = {"seq": seq, "epoch": wepoch, "op": op, "key": key,
                     "value": base64.b64encode(value).decode("ascii")}
            for peer in targets:
                if not self._replicate_to(peer, entry):
                    return False    # fenced: never applied, anywhere
            return self._commit(entry, wepoch)

    def _write_head(self) -> Optional[Tuple[int, int, List[str]]]:
        """(epoch, next seq, replication targets), or None when this
        replica may not accept client writes."""
        with self._lock:
            if self.role != "primary" or self.fenced:
                return None
            return (self.epoch, self.applied_seq + 1,
                    [p for p in self.peers if not self._is_self(p)])

    def _commit(self, entry: dict, wepoch: int) -> bool:
        with self._lock:
            if self.epoch != wepoch or self.fenced:
                return False    # deposed while replicating
            self._apply(entry)
            return True

    def _apply(self, entry: dict) -> None:
        with self._lock:
            key = entry["key"]
            if entry["op"] == "put":
                self.store[key] = base64.b64decode(entry["value"])
                if key.startswith(METRICS_SCOPE + "/"):
                    # Same server-clock arrival stamping as the plain
                    # server: staleness aging must not trust worker clocks.
                    self.put_times[key] = time.time()
            else:
                self.store.pop(key, None)
                self.put_times.pop(key, None)
            self.applied_seq = entry["seq"]
            self.log.append(entry)
            if len(self.log) > LOG_TAIL_MAX:
                del self.log[:len(self.log) - LOG_TAIL_MAX]

    # ------------------------------------------------------------ replication
    def _post(self, peer: str, path: str,
              body: bytes) -> Optional[Tuple[int, dict]]:
        """Signed POST to a peer; (status, json) — HTTP errors included —
        or None when the peer is unreachable (dead or partitioned)."""
        from horovod_tpu_torch.testing import faults
        try:
            faults.inject(f"kv_ha.replicate.r{self.replica_id}",
                          context=peer)
            req = urllib.request.Request(f"http://{peer}{path}", data=body,
                                         method="POST")
            if self.secret is not None:
                req.add_header(
                    secret_mod.DIGEST_HEADER,
                    secret_mod.compute_digest(self.secret, "POST", path,
                                              body))
            with urllib.request.urlopen(req, timeout=5) as r:
                return r.status, json.loads(r.read().decode("utf-8")
                                            or "{}")
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read().decode("utf-8") or "{}")
            except Exception:
                msg = {}
            return e.code, msg
        except Exception:
            return None

    def _replicate_to(self, peer: str, entry: dict) -> bool:
        """False ONLY when the peer fenced us (higher epoch). An
        unreachable peer is skipped — the coordinator's next failover
        snapshot-catches it up or replaces it; a lagging peer (412) is
        caught up inline from the log tail, else by full snapshot."""
        resp = self._post(peer, "/replicate",
                          json.dumps(entry).encode("utf-8"))
        if resp is None:
            return True
        code, msg = resp
        if code == 409:
            self._demote(msg)
            return False
        if code == 412:
            self._catch_up(peer, int(msg.get("applied_seq", 0)), entry)
        return True

    def _catch_up(self, peer: str, peer_seq: int, entry: dict) -> bool:
        """Bring a lagging peer to entry['seq']: replay the missing log
        tail when it reaches back far enough, else install a snapshot."""
        with self._lock:
            tail = [e for e in self.log if e["seq"] > peer_seq]
            have_tail = bool(tail) and tail[0]["seq"] == peer_seq + 1
            snap = None
            if not have_tail:
                snap = {"epoch": entry["epoch"], "seq": self.applied_seq,
                        "items": {k: base64.b64encode(v).decode("ascii")
                                  for k, v in self.store.items()}}
        if have_tail:
            for e in tail:
                r = self._post(peer, "/replicate",
                               json.dumps(e).encode("utf-8"))
                if r is None or r[0] != 200:
                    return False
        else:
            r = self._post(peer, "/snapshot",
                           json.dumps(snap).encode("utf-8"))
            if r is None or r[0] != 200:
                return False
        r = self._post(peer, "/replicate",
                       json.dumps(entry).encode("utf-8"))
        return r is not None and r[0] == 200

    # ------------------------------------------------- protocol route bodies
    def on_replicate(self, entry: dict) -> Tuple[int, dict]:
        with self._lock:
            if int(entry["epoch"]) < self.epoch:
                # THE fencing check: a stale primary's entry dies here
                # and the 409 demotes it before its client sees an ack.
                return 409, self._leader_info()
            if int(entry["epoch"]) > self.epoch:
                # A successor exists; whatever we thought we were
                # (including a deposed primary), we follow it now.
                self.epoch = int(entry["epoch"])
                self.role = "standby"
                self.fenced = False
            if int(entry["seq"]) != self.applied_seq + 1:
                return 412, {"applied_seq": self.applied_seq}
            self._apply(entry)
            return 200, {"applied_seq": self.applied_seq}

    def on_snapshot(self, snap: dict) -> Tuple[int, dict]:
        with self._lock:
            if int(snap["epoch"]) < self.epoch:
                return 409, self._leader_info()
            self.epoch = int(snap["epoch"])
            self.role = "standby"
            self.fenced = False
            # Mutate the shared dicts in place: the handler class aliases
            # them for the /metrics merge route.
            self.store.clear()
            for k, v in snap.get("items", {}).items():
                self.store[k] = base64.b64decode(v)
            self.put_times.clear()
            now = time.time()
            for k in self.store:
                if k.startswith(METRICS_SCOPE + "/"):
                    self.put_times[k] = now
            self.applied_seq = int(snap["seq"])
            del self.log[:]
            return 200, {"applied_seq": self.applied_seq}

    def on_promote(self, msg: dict) -> Tuple[int, dict]:
        with self._lock:
            if int(msg["epoch"]) <= self.epoch:
                # Promotion must strictly advance the epoch — replaying a
                # stale promotion cannot resurrect a deposed leader.
                return 409, self._leader_info()
            self.epoch = int(msg["epoch"])
            self.role = "primary"
            self.fenced = False
            if "peers" in msg:
                self.peers = [str(p) for p in msg["peers"]]
            self.leader = str(msg.get("leader", ""))
            return 200, self._leader_info()

    def on_config(self, msg: dict) -> Tuple[int, dict]:
        with self._lock:
            if "peers" in msg:
                self.peers = [str(p) for p in msg["peers"]]
            if "leader" in msg:
                self.leader = str(msg["leader"])
            return 200, self._leader_info()


# ---------------------------------------------------------------- launcher
class HAControlPlane:
    """Launcher-side supervisor + facade over N replica subprocesses.

    The public surface mirrors `RendezvousServer` (`start`/`put`/`get`/
    `scope_items`/`stop`/`port`/`worker_env`) so launchers swap between
    the two via :func:`start_control_plane`. Facade data ops go through
    an internal multi-endpoint :class:`KVClient`, so they ride failover
    exactly like a worker's.
    """

    def __init__(self, secret: Optional[bytes], replicas: int,
                 workdir: Optional[str] = None):
        if replicas < 2:
            raise ValueError("HAControlPlane needs >= 2 replicas; "
                             "use RendezvousServer (via "
                             "start_control_plane) for 1")
        self.secret = secret
        self.n = replicas
        self._dir = workdir or tempfile.mkdtemp(prefix="hvd-kv-ha-")
        self._lock = threading.Lock()
        self._procs: List[subprocess.Popen] = []   # guarded-by: _lock
        self._ports: List[int] = []                # guarded-by: _lock
        self._primary_id = 0                       # guarded-by: _lock
        self._epoch = 0                            # guarded-by: _lock
        self._dead: set = set()                    # guarded-by: _lock
        self._stop_evt = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._pusher: Optional[threading.Thread] = None
        self._client: Optional[KVClient] = None
        self.port = 0   # current primary's port (RendezvousServer parity)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> int:
        env = dict(os.environ)
        if self.secret is not None:
            env[secret_mod.SECRET_ENV] = self.secret.decode()
        # The replicas import this package wherever the launcher runs.
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        procs, port_files = [], []
        for i in range(self.n):
            pf = os.path.join(self._dir, f"replica-{i}.port")
            port_files.append(pf)
            cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.kv_ha",
                   "--replica-id", str(i), "--port-file", pf]
            # Each replica leads its own session (= process group): a
            # host_kill fault inside it takes down only that replica's
            # group, and stop() can killpg without touching the launcher.
            procs.append(subprocess.Popen(cmd, env=env,
                                          start_new_session=True))
        ports: List[int] = []
        deadline = time.monotonic() + 60
        for i, pf in enumerate(port_files):
            while not os.path.exists(pf):
                if procs[i].poll() is not None:
                    raise RuntimeError(
                        f"kv_ha replica {i} exited rc={procs[i].returncode} "
                        f"before announcing its port")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"kv_ha replica {i} never announced its port")
                time.sleep(0.05)
            with open(pf) as f:
                ports.append(int(f.read().strip()))
        addrs = [f"127.0.0.1:{p}" for p in ports]
        if self._post_replica(ports[0], "/promote",
                              {"epoch": 1, "peers": addrs,
                               "leader": addrs[0]}) is None:
            raise RuntimeError("kv_ha replica 0 rejected initial promotion")
        for i in range(1, self.n):
            self._post_replica(ports[i], "/config",
                               {"peers": addrs, "leader": addrs[0]})
        with self._lock:
            self._procs = procs
            self._ports = ports
            self._primary_id = 0
            self._epoch = 1
        self.port = ports[0]
        self._client = KVClient("127.0.0.1", ports[0], secret=self.secret,
                                endpoints=addrs)
        announce_endpoints(self._announce_order())
        _flight(f"control-plane up replicas={self.n} primary=r0 epoch=1")
        mx = _ha_metrics()
        mx["epoch"].set(1)
        mx["replicas"].set(self.n)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="kv-ha-monitor")
        self._monitor.start()
        self._pusher = threading.Thread(target=self._push_loop,
                                        daemon=True, name="kv-ha-push")
        self._pusher.start()
        return self.port

    def stop(self) -> None:
        self._stop_evt.set()
        for t in (self._monitor, self._pusher):
            if t is not None:
                t.join(timeout=5)
        with self._lock:
            final_epoch = self._epoch
            procs = list(self._procs)
        _flight(f"control-plane down epoch={final_epoch}")
        try:
            # HA mode only (the plain server never does this), so
            # HOROVOD_KV_REPLICAS=1 keeps byte-identical behavior: the
            # launcher's own kv-failover timeline must survive the
            # replicas' death for the doctor.
            from horovod_tpu_torch.observability import flight
            flight.dump("kv_ha_stop", push_kv=False)
        except Exception:
            pass
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
            try:
                p.wait(timeout=10)
            except Exception:
                pass

    # ------------------------------------------------------------ facade
    def put(self, scope: str, key: str, value: bytes) -> None:
        self._client.put(scope, key, value)

    def get(self, scope: str, key: str) -> Optional[bytes]:
        return self._client.get(scope, key, timeout=0)

    def scope_items(self, scope: str) -> Dict[str, bytes]:
        raw = self._client._request("GET", f"/hakv/scope/{scope}",
                                    None).read()
        return {k: base64.b64decode(v)
                for k, v in json.loads(raw.decode("utf-8")).items()}

    def worker_env(self, ip: str) -> Dict[str, str]:
        """ADDR/PORT point at the boot-time primary (same keys as the
        plain server); ADDRS carries every replica so clients born
        before OR after a failover can always find the leader."""
        from horovod_tpu_torch.common import config as C
        with self._lock:
            ports = list(self._ports)
            primary = self._primary_id
        return {C.HOROVOD_RENDEZVOUS_ADDR: ip,
                C.HOROVOD_RENDEZVOUS_PORT: str(ports[primary]),
                HOROVOD_RENDEZVOUS_ADDRS:
                    ",".join(f"{ip}:{p}" for p in ports)}

    # ------------------------------------------------------------ supervision
    def _announce_order(self) -> List[str]:
        with self._lock:
            ports = list(self._ports)
            primary = self._primary_id
            dead = set(self._dead)
        order = [f"127.0.0.1:{ports[primary]}"]
        order += [f"127.0.0.1:{p}" for i, p in enumerate(ports)
                  if i != primary and i not in dead]
        return order

    def _post_replica(self, port: int, path: str,
                      msg: dict) -> Optional[dict]:
        body = json.dumps(msg).encode("utf-8")
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=body, method="POST")
        if self.secret is not None:
            req.add_header(
                secret_mod.DIGEST_HEADER,
                secret_mod.compute_digest(self.secret, "POST", path, body))
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                return json.loads(r.read().decode("utf-8") or "{}")
        except Exception:
            return None

    @staticmethod
    def _get_leader(port: int) -> Optional[dict]:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/leader", timeout=2) as r:
                return json.loads(r.read().decode("utf-8"))
        except Exception:
            return None

    def _monitor_loop(self) -> None:
        interval = float(os.environ.get(HOROVOD_KV_PROBE_INTERVAL,
                                        "0.25") or 0.25)
        while not self._stop_evt.wait(interval):
            with self._lock:
                procs = list(enumerate(self._procs))
                primary = self._primary_id
                dead = set(self._dead)
            for i, p in procs:
                if i in dead or p.poll() is None:
                    continue
                with self._lock:
                    self._dead.add(i)
                    live = self.n - len(self._dead)
                _flight(f"replica r{i} died rc={p.returncode}"
                        + (" (primary)" if i == primary else ""))
                _ha_metrics()["replicas"].set(live)
                if i == primary:
                    self._failover(i)

    def _failover(self, dead_primary: int) -> None:
        """Promote the successor: live replica with the highest applied
        seq, lowest id breaking ties, under epoch+1."""
        with self._lock:
            ports = list(self._ports)
            candidates = [i for i in range(self.n) if i not in self._dead]
        infos = {}
        for i in candidates:
            info = self._get_leader(ports[i])
            if info is not None:
                infos[i] = info
        if not infos:
            _flight(f"failover FAILED: no live replica after r"
                    f"{dead_primary} died")
            return
        succ = min(infos,
                   key=lambda i: (-int(infos[i]["applied_seq"]), i))
        succ_seq = int(infos[succ]["applied_seq"])
        lag = max(int(v["applied_seq"]) for v in infos.values()) - succ_seq
        with self._lock:
            new_epoch = self._epoch + 1
            live_addrs = [f"127.0.0.1:{ports[i]}" for i in range(self.n)
                          if i not in self._dead]
        leader_addr = f"127.0.0.1:{ports[succ]}"
        self._post_replica(ports[succ], "/promote",
                           {"epoch": new_epoch, "peers": live_addrs,
                            "leader": leader_addr})
        for i in infos:
            if i != succ:
                self._post_replica(ports[i], "/config",
                                   {"peers": live_addrs,
                                    "leader": leader_addr})
        with self._lock:
            old_epoch = self._epoch
            self._primary_id = succ
            self._epoch = new_epoch
        self.port = ports[succ]
        client = self._client
        if client is not None:
            if leader_addr in client.endpoints:
                client.endpoints.remove(leader_addr)
            client.endpoints.insert(0, leader_addr)
            client.base = f"http://{leader_addr}"
        announce_endpoints(self._announce_order())
        _flight(f"failover: primary r{dead_primary} -> r{succ} "
                f"epoch {old_epoch}->{new_epoch} lag={lag}")
        mx = _ha_metrics()
        mx["failovers"].inc()
        mx["epoch"].set(new_epoch)
        mx["applied"].set(succ_seq)
        mx["lag"].set(lag)

    def _push_loop(self) -> None:
        """Push the launcher registry into the `metrics/` scope: the
        in-process server merged it into /metrics for free, but the
        replicas are subprocesses — the launcher now pushes a rank-less
        snapshot like any worker exporter (observability/export.py)."""
        from horovod_tpu_torch.common import resilience
        from horovod_tpu_torch.common.config import (HOROVOD_METRICS_PUSH_INTERVAL,
                                               _env_float)
        from horovod_tpu_torch.observability import metrics as m
        interval = max(_env_float(HOROVOD_METRICS_PUSH_INTERVAL, 5.0), 0.1)
        with self._lock:
            ports = list(self._ports)
            primary = self._primary_id
        kv = KVClient(
            "127.0.0.1", ports[primary], secret=self.secret,
            endpoints=[f"127.0.0.1:{p}" for p in ports],
            retry_policy=resilience.kv_retry_policy(max_attempts=2,
                                                    deadline=2.0),
            request_timeout=2.0)
        while not self._stop_evt.wait(interval):
            try:
                reg = m.registry()
                if not reg.enabled:
                    continue
                snap = json.dumps(reg.snapshot(None)).encode("utf-8")
                kv.put(METRICS_SCOPE, "launcher", snap)
            except Exception:
                pass    # telemetry is best-effort, next tick supersedes


def start_control_plane(secret: Optional[bytes]):
    """The factory every launcher calls: HOROVOD_KV_REPLICAS <= 1 (the
    default) returns a started plain `RendezvousServer` — byte-identical
    wire behavior, zero new processes; > 1 returns a started
    :class:`HAControlPlane`."""
    n = int(os.environ.get(HOROVOD_KV_REPLICAS, "1") or 1)
    if n <= 1:
        rdv = RendezvousServer(secret=secret)
        rdv.start()
        return rdv
    cp = HAControlPlane(secret=secret, replicas=n)
    cp.start()
    return cp


# ------------------------------------------------------------ replica entry
def replica_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner.kv_ha",
        description="One replicated-rendezvous KV replica (spawned by "
                    "the launcher's HAControlPlane; not run by hand).")
    ap.add_argument("--replica-id", type=int, required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--port-file", required=True)
    args = ap.parse_args(argv)
    node = ReplicaNode(args.replica_id, port=args.port,
                       secret=secret_mod.secret_from_env())
    node.start()
    tmp = f"{args.port_file}.tmp"
    with open(tmp, "w") as f:
        f.write(str(node.port))
    os.replace(tmp, args.port_file)
    print(f"KV_HA_REPLICA_UP id={args.replica_id} port={node.port} "
          f"pid={os.getpid()}", flush=True)
    # A replica leads its own session, so a launcher killed without its
    # cleanup would leave it running: it exits once its parent is gone.
    parent = os.getppid()
    try:
        while os.getppid() == parent:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(replica_main())
