"""The port's replicated rendezvous control plane (runner/kv_ha.py with
HOROVOD_KV_REPLICAS > 1) and its client failover (runner/rendezvous.py)
against the JAX package's, on this host's CPU.

The contract of tests/test_kv_ha.py on in-process replicas: synchronous
replication before the ack, standbys answering 409 with a leader hint,
epoch fencing of a revived stale primary (its write is seen on no
replica), strictly advancing promotions, catch-up from the log tail and
from a snapshot, the client's failover on a 409 and on a dead endpoint,
and the single-endpoint client unchanged. Each protocol case also runs
across the packages: the port's client against the JAX package's
replicas and the JAX client against the port's, so that the replication
protocol is held to the original on the wire. The kv_ha fault sites
fire as in the JAX package. The replica subprocesses and a host_kill
of the primary under a training job are in
tests/test_torch_control_plane.py. Tolerance: exact.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from horovod_tpu.common import resilience as jres
from horovod_tpu.runner import kv_ha as jha
from horovod_tpu.runner import rendezvous as jrdv
from horovod_tpu_torch.common import resilience as tres
from horovod_tpu_torch.runner import kv_ha as tha
from horovod_tpu_torch.runner import rendezvous as trdv
from horovod_tpu_torch.testing import faults
from torch_threads import leftover, snapshot


@pytest.fixture(scope="module", autouse=True)
def threads_at_start():
    return snapshot()


# (replicas, client) module pairs: the port alone, then across packages.
PAIRS = {"port": (tha, trdv, tres), "port-client-jax-replicas":
         (jha, trdv, tres), "jax-client-port-replicas": (tha, jrdv, jres)}


def _policy(res, **kw):
    for k, v in dict(max_attempts=3, base_delay=0.005, max_delay=0.02,
                     jitter=0.0, deadline=5.0).items():
        kw.setdefault(k, v)
    return res.RetryPolicy(**kw)


@pytest.fixture()
def cluster():
    nodes = []

    def make(ha, n=2, first_id=0):
        new = [ha.ReplicaNode(first_id + i, secret=None) for i in range(n)]
        for node in new:
            node.start()
        nodes.extend(new)
        return new

    yield make
    for node in nodes:
        node.stop()


def _promote(nodes, epoch=1):
    peers = [f"127.0.0.1:{n.port}" for n in nodes]
    code, _ = nodes[0].on_promote({"epoch": epoch, "peers": peers,
                                   "leader": peers[0]})
    assert code == 200
    for node in nodes[1:]:
        node.on_config({"peers": peers, "leader": peers[0]})
    return peers


@pytest.mark.parametrize("pair", list(PAIRS))
def test_replication_reaches_standby_before_ack(cluster, pair):
    ha, rdv, res = PAIRS[pair]
    a, b = cluster(ha)
    _promote([a, b])
    c = rdv.KVClient("127.0.0.1", a.port, secret=None,
                     retry_policy=_policy(res))
    c.put("elastic", "round", b"7")
    with b._lock:
        assert b.store.get("elastic/round") == b"7" and b.applied_seq == 1
    assert c.get("elastic", "round", timeout=0) == b"7"
    c.delete("elastic", "round")
    with b._lock:
        assert "elastic/round" not in b.store and b.applied_seq == 2


def test_standby_rejects_client_ops_with_leader_hint(cluster):
    a, b = cluster(tha)
    _promote([a, b])
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{b.port}/elastic/round", data=b"1",
            method="PUT"), timeout=5)
    assert ei.value.code == 409
    hint = json.loads(ei.value.read().decode())
    assert hint["role"] == "standby" and hint["leader"].endswith(
        f":{a.port}")
    info = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{a.port}/leader", timeout=5).read())
    assert info["role"] == "primary" and info["epoch"] == 1


@pytest.mark.parametrize("pair", ["port", "port-client-jax-replicas"])
def test_fencing_revived_stale_primary_write_never_observed(cluster, pair):
    ha, rdv, res = PAIRS[pair]
    a, b = cluster(ha)
    _promote([a, b])
    rdv.KVClient("127.0.0.1", a.port, secret=None,
                 retry_policy=_policy(res)).put("job", "owner", b"epoch1")
    peers = [f"127.0.0.1:{b.port}", f"127.0.0.1:{a.port}"]
    assert b.on_promote({"epoch": 2, "peers": peers,
                         "leader": peers[0]})[0] == 200
    stale = rdv.KVClient("127.0.0.1", a.port, secret=None,
                         retry_policy=_policy(res),
                         endpoints=[f"127.0.0.1:{a.port}"])
    with pytest.raises((res.RetryError, urllib.error.HTTPError)) as ei:
        stale.put("job", "owner", b"SPLIT-BRAIN")
    err = ei.value
    if isinstance(err, res.RetryError):
        err = err.__cause__
    assert isinstance(err, urllib.error.HTTPError) and err.code == 409
    for node in (a, b):
        with node._lock:
            assert node.store.get("job/owner") == b"epoch1"
    with a._lock:
        assert a.fenced and a.role == "standby" and a.epoch == 2


def test_promotion_must_strictly_advance_epoch(cluster):
    a, b = cluster(tha)
    _promote([a, b])
    assert a.on_promote({"epoch": 1, "peers": [], "leader": ""})[0] == 409
    assert b.on_promote({"epoch": 0, "peers": [], "leader": ""})[0] == 409
    code, info = b.on_promote({"epoch": 2, "peers": [f"127.0.0.1:{b.port}"],
                               "leader": f"127.0.0.1:{b.port}"})
    assert code == 200 and info["role"] == "primary"


@pytest.mark.parametrize("evict", [False, True], ids=["tail", "snapshot"])
def test_late_joiner_catches_up(cluster, evict):
    a, b = cluster(tha)
    _promote([a, b])
    (c,) = cluster(tha, 1, first_id=2)
    ca = trdv.KVClient("127.0.0.1", a.port, secret=None,
                       retry_policy=_policy(tres))
    for i in range(3):
        ca.put("seed", f"k{i}", str(i).encode())
    if evict:
        with a._lock:
            del a.log[:]  # as if the joiner were beyond the log tail
    peers = [f"127.0.0.1:{n.port}" for n in (a, b, c)]
    a.on_config({"peers": peers, "leader": peers[0]})
    c.on_config({"peers": peers, "leader": peers[0]})
    ca.put("seed", "k3", b"3")
    with c._lock:
        assert c.applied_seq == 4 and c.role == "standby"
        for i in range(4):
            assert c.store.get(f"seed/k{i}") == str(i).encode()


@pytest.mark.parametrize("pair", list(PAIRS))
def test_client_fails_over_to_new_primary_on_409(cluster, pair):
    ha, rdv, res = PAIRS[pair]
    a, b = cluster(ha)
    eps = _promote([a, b])
    c = rdv.KVClient("127.0.0.1", a.port, secret=None,
                     retry_policy=_policy(res), endpoints=eps)
    c.put("x", "k", b"1")
    b.on_promote({"epoch": 2, "peers": list(reversed(eps)),
                  "leader": eps[1]})
    c.put("x", "k", b"2")
    assert c.failovers >= 1 and c.base.endswith(f":{b.port}")
    with b._lock:
        assert b.store.get("x/k") == b"2"


def test_client_fails_over_on_exhausted_retries_dead_endpoint(cluster):
    a, b = cluster(tha)
    eps = _promote([a, b])
    c = trdv.KVClient("127.0.0.1", a.port, secret=None,
                      retry_policy=_policy(tres, max_attempts=2),
                      endpoints=eps)
    c.put("x", "k", b"1")
    a.stop()
    b.on_promote({"epoch": 2, "peers": [eps[1]], "leader": eps[1]})
    c.put("x", "k", b"2")
    assert c.failovers >= 1
    with b._lock:
        assert b.store.get("x/k") == b"2"


def test_single_endpoint_client_behavior_unchanged():
    c = trdv.KVClient("127.0.0.1", 1, secret=None,
                      retry_policy=_policy(tres, max_attempts=2,
                                           deadline=1.0))
    assert c.endpoints == ["127.0.0.1:1"]
    t0 = time.monotonic()
    with pytest.raises(tres.RetryError):
        c.put("x", "k", b"1")
    assert time.monotonic() - t0 < 3.0 and c.failovers == 0


def test_kv_ha_fault_sites_fire_per_replica(cluster):
    a, b = cluster(tha)
    eps = _promote([a, b])
    prev = faults.install(faults.FaultInjector(faults.parse_spec(
        "site=kv_ha.put.r0,kind=latency,ms=1;"
        f"site=kv_ha.replicate.r0,kind=latency,ms=1,match={eps[1]}")))
    try:
        trdv.KVClient("127.0.0.1", a.port, secret=None,
                      retry_policy=_policy(tres)).put("s", "k", b"v")
        inj = faults.get()
        assert inj.injected == {"kv_ha.put.r0": 1,
                                "kv_ha.replicate.r0": 1}
    finally:
        faults.install(prev)


def test_start_control_plane_default_is_plain_server(monkeypatch):
    monkeypatch.delenv(tha.HOROVOD_KV_REPLICAS, raising=False)
    rdv = tha.start_control_plane(None)
    try:
        assert isinstance(rdv, trdv.RendezvousServer)
        assert trdv.HOROVOD_RENDEZVOUS_ADDRS not in rdv.worker_env("h")
    finally:
        rdv.stop()
    with pytest.raises(ValueError):
        tha.HAControlPlane(secret=None, replicas=1)


def test_no_thread_left_behind(threads_at_start):
    assert not leftover(threads_at_start), leftover(threads_at_start)
