"""The port's fault injector (horovod_tpu_torch/testing/faults.py) and
its sites against the JAX package's, on this host's CPU.

The same (spec, seed) pairs drive both injectors over the same sequence
of hits: which rule fires at each hit, and the hit and injection counts,
must be the same, hit for hit. Then each of the seven kinds does what
tests/test_faults.py says (crash and host_kill in child processes), and
the port's sites fire: `kv.request` in the rendezvous client,
`discovery.poll` in the host manager and the elastic driver's loop,
`data.feed.produce` in DeviceFeed (both depths), `collective.dispatch`
in the collectives' choke point, and the kv_ha sites (in
tests/test_torch_kv_ha.py). Tolerance: exact.
"""

import os
import subprocess
import sys
import time
import urllib.error

import pytest
import torch

from horovod_tpu.testing import faults as jf
from horovod_tpu_torch.common.exceptions import FaultInjectedError, HorovodError
from horovod_tpu_torch.common.resilience import RetryPolicy
from horovod_tpu_torch.testing import faults as tf
from torch_threads import leftover, snapshot


@pytest.fixture(scope="module", autouse=True)
def threads_at_start():
    return snapshot()


@pytest.fixture(autouse=True)
def no_injector(monkeypatch):
    monkeypatch.delenv(tf.FAULT_SPEC_ENV, raising=False)
    prev = tf.install(None)
    yield
    tf.install(prev)


def _schedule(mod, spec, seed, hits):
    """(site, context) -> index of the rule that fired, or None."""
    inj = mod.FaultInjector(mod.parse_spec(spec), seed=seed)
    out = []
    for site, ctx in hits:
        r = inj._pick(site, ctx)
        out.append(None if r is None else inj.rules.index(r))
    return out, dict(inj.hits), dict(inj.injected)


SPECS = [
    "site=kv.request,kind=connect_refused,p=0.3,count=4",
    "site=kv.request,kind=http_5xx,p=0.5,after=3;"
    "site=kv.request,kind=latency,ms=1,p=0.5;"
    "site=discovery.poll,kind=flap,p=0.25",
    "site=kv_ha.replicate.r0,kind=partition,match=:7001,p=0.7;"
    "site=kv_ha.put.r0,kind=host_kill,after=4,count=1;"
    "site=collective.dispatch,kind=latency,ms=1,match=rank1:grad",
]


@pytest.mark.parametrize("spec", SPECS, ids=["single", "multi", "match"])
@pytest.mark.parametrize("seed", [0, 5])
def test_schedule_matches_jax_hit_for_hit(spec, seed):
    sites = ["kv.request", "discovery.poll", "kv_ha.replicate.r0",
             "kv_ha.put.r0", "collective.dispatch"]
    ctxs = [None, "127.0.0.1:7001", "127.0.0.1:7002", "rank1:grad",
            "rank0:grad"]
    hits = [(sites[(i * 7) % 5], ctxs[(i * 3) % 5]) for i in range(200)]
    assert _schedule(tf, spec, seed, hits) == _schedule(jf, spec, seed, hits)
    assert tf.parse_spec(spec) == [tf.FaultRule(**vars(r))
                                   for r in jf.parse_spec(spec)]


def test_kinds_and_bad_specs_match_jax():
    assert tf.KINDS == jf.KINDS and len(tf.KINDS) == 7
    for bad in ("site=x,kind=not_a_kind", "kind=latency",
                "site=x,kind=latency,oops"):
        with pytest.raises(HorovodError):
            tf.parse_spec(bad)


def test_in_process_kinds_raise_what_the_jax_kinds_raise():
    inj = tf.FaultInjector(tf.parse_spec(
        "site=a,kind=connect_refused;site=b,kind=http_5xx,code=502;"
        "site=c,kind=flap;site=d,kind=partition;site=e,kind=latency,ms=30"))
    with pytest.raises(urllib.error.URLError):
        inj.fire("a")
    with pytest.raises(urllib.error.HTTPError) as e:
        inj.fire("b")
    assert e.value.code == 502
    with pytest.raises(FaultInjectedError):
        inj.fire("c")
    with pytest.raises(urllib.error.URLError) as e:
        inj.fire("d", context="peer")
    assert "partition" in str(e.value)
    t0 = time.monotonic()
    inj.fire("e")
    assert time.monotonic() - t0 >= 0.03
    calls = {"n": 0}
    part = tf.FaultInjector([tf.FaultRule("rep", "partition", count=2)])

    def flaky():
        calls["n"] += 1
        part.fire("rep", context="peer")
        return "ok"

    pol = RetryPolicy(max_attempts=5, base_delay=0.001, max_delay=0.002,
                      deadline=None)
    assert pol.call(flaky) == "ok" and calls["n"] == 3


@pytest.mark.parametrize("kind,rc", [("crash", 7), ("host_kill", -9)])
def test_process_kinds_end_the_process(kind, rc):
    code = ("import os, subprocess, sys\n"
            "child = subprocess.Popen([sys.executable, '-c', "
            "'import time; time.sleep(60)'], stdout=subprocess.DEVNULL)\n"
            "print('child', child.pid, flush=True)\n"
            "from horovod_tpu_torch.testing import faults\n"
            "faults.inject('worker.step')\n"
            "print('unreachable', flush=True)\n"
            "child.kill()\n")
    env = dict(os.environ, **{tf.FAULT_SPEC_ENV:
                              f"site=worker.step,kind={kind}"})
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    child = int(out.split()[1])
    try:
        assert proc.returncode == rc and "unreachable" not in out
        if kind == "host_kill":  # the whole group went, the child too
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                try:
                    state = open(f"/proc/{child}/stat").read()
                    if state.split(") ")[-1][0] == "Z":
                        break
                except OSError:
                    break
                time.sleep(0.1)
            else:
                pytest.fail("the child survived host_kill of its group")
    finally:
        try:
            os.kill(child, 9)
        except OSError:
            pass


# ------------------------------------------------------------ the sites

@pytest.fixture()
def server():
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    srv = RendezvousServer()
    srv.start()
    yield srv
    srv.stop()


def test_kv_request_site_rides_out_refusals_and_5xx(server):
    from horovod_tpu_torch.runner.rendezvous import KVClient
    tf.install(tf.FaultInjector([
        tf.FaultRule("kv.request", "connect_refused", count=2),
        tf.FaultRule("kv.request", "http_5xx", after=2, count=1)]))
    c = KVClient("127.0.0.1", server.port, secret=None,
                 retry_policy=RetryPolicy(max_attempts=6, base_delay=0.001,
                                          max_delay=0.002, deadline=None))
    c.put("s", "k", b"v")
    assert c.attempts == 4  # 2 refused, one 5xx, then the put
    assert c.get("s", "k") == b"v"


def test_discovery_poll_site_flaps_and_recovers():
    from horovod_tpu_torch.elastic.discovery import FixedHosts, HostManager
    hm = HostManager(FixedHosts({"a": 2}))
    tf.install(tf.FaultInjector([tf.FaultRule("discovery.poll", "flap",
                                              count=2)]))
    for _ in range(2):
        with pytest.raises(FaultInjectedError):
            hm.update_available_hosts()
    assert hm.update_available_hosts() and hm.available_slots() == 2


def test_discover_loop_backs_off_on_flaps_then_recovers():
    from horovod_tpu_torch.elastic.discovery import FixedHosts, HostManager
    from horovod_tpu_torch.elastic.driver import ElasticDriver
    d = ElasticDriver(HostManager(FixedHosts({"a": 1})),
                      lambda slot, rid: object(), lambda h: None,
                      discovery_interval=0.02,
                      discovery_retry=RetryPolicy(
                          max_attempts=3, base_delay=0.01, max_delay=0.05,
                          jitter=0.0, deadline=None))
    d.start()
    tf.install(tf.FaultInjector([tf.FaultRule("discovery.poll", "flap",
                                              count=4)]))
    try:
        deadline = time.monotonic() + 5.0
        while d.discovery_failures < 4:
            assert time.monotonic() < deadline, "flaps never observed"
            time.sleep(0.01)
        while d.discovery_failures != 0:
            assert time.monotonic() < deadline, "loop never recovered"
            time.sleep(0.01)
    finally:
        d.stop()


@pytest.mark.parametrize("depth", [0, 2])
def test_data_feed_produce_site_delays_every_batch(depth):
    from horovod_tpu_torch.data import DeviceFeed
    tf.install(tf.FaultInjector([tf.FaultRule("data.feed.produce",
                                              "latency", ms=20)]))
    src = [torch.full((2,), float(i)) for i in range(3)]
    feed = DeviceFeed(iter(src), device="cpu", depth=depth)
    try:
        got = [float(b[0]) for b in feed]
    finally:
        feed.close()
    assert got == [0.0, 1.0, 2.0]
    assert tf.get().injected["data.feed.produce"] == 3


def test_collective_dispatch_site_delays_the_matching_rank(tmp_path):
    import horovod_tpu_torch as hvd
    tf.install(tf.FaultInjector(tf.parse_spec(
        "site=collective.dispatch,kind=latency,ms=50,match=rank0:grad")))
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        hvd.allreduce(torch.ones(2), name="other")
        assert tf.get().injected == {}
        t0 = time.monotonic()
        hvd.allreduce(torch.ones(2), name="grad")
        slow = time.monotonic() - t0
    finally:
        hvd.shutdown()
    assert tf.get().injected == {"collective.dispatch": 1}
    assert slow >= 0.05


def test_no_thread_left_behind(threads_at_start):
    assert not leftover(threads_at_start), leftover(threads_at_start)
