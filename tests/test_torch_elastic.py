"""horovod_tpu_torch.elastic against horovod_tpu.elastic: the driver,
discovery, the blacklist, the states and `run` (tests/test_elastic.py),
and the torch states of tests/test_frontend_elastic.py.

The driver cases feed the same hosts and the same worker exits to the
JAX package's ElasticDriver and to the port's, each with its own mock
spawner, and hold their rounds' slot assignments, spawns, stops and
decisions equal. The states run in a world of one on gloo; `run`'s
in-process retry leaves the world and joins it again, and a
DistributedOptimizer built before the reset trains on after it to the
uninterrupted run's weights bit for bit.
"""

import os
import stat
import time

import pytest
import torch

from horovod_tpu.elastic import driver as jdriver
from horovod_tpu.elastic import discovery as jdiscovery
from horovod_tpu.ops import collectives as jcollectives
import horovod_tpu_torch as hvd
from horovod_tpu_torch import kernels
from horovod_tpu_torch.common import config as C
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HostsUpdatedInterrupt)
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.elastic import (ElasticDriver, FixedHosts,
                                       HostDiscoveryScript, HostManager,
                                       ObjectState, run)
from horovod_tpu_torch.elastic import state as te
from horovod_tpu_torch.elastic.discovery import _Blacklist
from horovod_tpu_torch.ops import collectives


@pytest.fixture
def world(monkeypatch):
    """A world of one on gloo."""
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
              "HOROVOD_LOCAL_SIZE", "HOROVOD_COORDINATOR_ADDR",
              "HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_ELASTIC"):
        monkeypatch.delenv(k, raising=False)
    topology.init(device="cpu")
    yield
    topology.shutdown()


# ----------------------------------------------------------------- discovery

def test_discovery_script(tmp_path):
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\necho host1:2\necho host2\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    d = HostDiscoveryScript(str(script), default_slots=4)
    jd = jdiscovery.HostDiscoveryScript(str(script), default_slots=4)
    assert d.find_available_hosts_and_slots() == {"host1": 2, "host2": 4} \
        == jd.find_available_hosts_and_slots()


@pytest.mark.parametrize("cooldown", [None, (1.0, 3.0)])
def test_blacklist_cooldown_backoff(monkeypatch, cooldown):
    t = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: t[0])
    bl, jbl = _Blacklist(cooldown), jdiscovery._Blacklist(cooldown)
    seen = []
    for _ in range(3):  # three failures: the cooldown doubles, capped
        bl.blacklist("h")
        jbl.blacklist("h")
        for dt in (0.0, bl.INIT_COOLDOWN + 0.1, bl.INIT_COOLDOWN + 0.1,
                   2 * bl.INIT_COOLDOWN + 0.1):
            t[0] += dt
            seen.append(bl.is_blacklisted("h"))
            assert seen[-1] == jbl.is_blacklisted("h")
        assert bl.count("h") == jbl.count("h")
    assert seen[:4] == [True, False, False, False]
    assert seen[4:8] == [True, True, False, False]


def test_host_manager_excludes_blacklisted():
    hm = HostManager(FixedHosts({"a": 2, "b": 2}))
    jhm = jdiscovery.HostManager(jdiscovery.FixedHosts({"a": 2, "b": 2}))
    for m in (hm, jhm):
        m.update_available_hosts()
        assert m.available_slots() == 4
        m.blacklist("b")
        m.update_available_hosts()
    assert [h.hostname for h in hm.current_hosts] == ["a"] == \
        [h.hostname for h in jhm.current_hosts]


# -------------------------------------------------------------------- driver

class MockSpawner:
    def __init__(self):
        self.spawned = []   # (slot, round_id)
        self.stopped = []

    def spawn(self, slot, round_id):
        handle = object()
        self.spawned.append((slot, round_id, handle))
        return handle

    def stop(self, handle):
        self.stopped.append(handle)


def _slots(d):
    return [(s.hostname, s.rank, s.size, s.local_rank, s.local_size,
             s.cross_rank, s.cross_size) for s in d.current_slots()]


class Pair:
    """The port's driver and the JAX package's, driven alike."""

    def __init__(self, hosts, **kw):
        self.fixed = [FixedHosts(hosts), jdiscovery.FixedHosts(hosts)]
        self.hms = [HostManager(self.fixed[0]),
                    jdiscovery.HostManager(self.fixed[1])]
        self.sps = [MockSpawner(), MockSpawner()]
        self.ds = [ElasticDriver(self.hms[0], self.sps[0].spawn,
                                 self.sps[0].stop, discovery_interval=0.05,
                                 **kw),
                   jdriver.ElasticDriver(self.hms[1], self.sps[1].spawn,
                                         self.sps[1].stop,
                                         discovery_interval=0.05, **kw)]

    def do(self, fn):
        """fn(driver, host_manager, fixed) on both; equal results."""
        outs = [fn(d, hm, f) for d, hm, f in
                zip(self.ds, self.hms, self.fixed)]
        assert outs[0] == outs[1]
        assert _slots(self.ds[0]) == _slots(self.ds[1])
        assert [(s.hostname, s.rank, r) for s, r, _ in self.sps[0].spawned] \
            == [(s.hostname, s.rank, r) for s, r, _ in self.sps[1].spawned]
        assert len(self.sps[0].stopped) == len(self.sps[1].stopped)
        return outs[0]

    def stop(self):
        for d in self.ds:
            d.stop()


@pytest.fixture
def pair_factory():
    made = []

    def make(hosts, **kw):
        p = Pair(hosts, **kw)
        made.append(p)
        return p
    yield make
    for p in made:
        p.stop()


def test_driver_initial_round_assigns_all_slots(pair_factory):
    p = pair_factory({"a": 2, "b": 2})
    p.do(lambda d, hm, f: d.start())
    slots = p.ds[0].current_slots()
    assert [s.rank for s in slots] == [0, 1, 2, 3]
    assert {s.hostname for s in slots} == {"a", "b"}
    assert all(s.size == 4 for s in slots)


def test_driver_scale_up_preserves_existing_hosts_first(pair_factory):
    p = pair_factory({"a": 2})
    p.do(lambda d, hm, f: d.start())
    assert p.ds[0].world_size == 2

    def grow(d, hm, f):
        f.hosts["b"] = 2
        hm.update_available_hosts()
        d._host_change.set()
        return d.maybe_reset()
    assert p.do(grow)
    slots = p.ds[0].current_slots()
    assert [s.rank for s in slots] == [0, 1, 2, 3]
    assert [s.hostname for s in slots] == ["a", "a", "b", "b"]
    assert len(p.sps[0].spawned) == 4  # the survivors were not respawned


def test_driver_worker_failure_blacklists_and_scales_down(pair_factory):
    p = pair_factory({"a": 2, "b": 2})
    p.do(lambda d, hm, f: d.start())

    def fail(d, hm, f):
        victim = [s for s in d.current_slots() if s.hostname == "b"][0]
        d.handle_worker_exit(victim.rank, 1, host_failure=True)
        hm.update_available_hosts()
        return d.maybe_reset()
    assert p.do(fail)
    slots = p.ds[0].current_slots()
    assert {s.hostname for s in slots} == {"a"}
    assert all(s.size == 2 for s in slots)


def test_driver_reset_limit(pair_factory):
    p = pair_factory({"a": 2}, reset_limit=1)
    p.do(lambda d, hm, f: d.start())

    def reset(d, hm, f):
        d._host_change.set()
        try:
            return d.maybe_reset()
        except Exception as e:
            return type(e).__name__
    assert p.do(reset) is True
    assert p.do(reset) == "ResetLimitExceededError"


def test_driver_respects_max_num_proc(pair_factory):
    p = pair_factory({"a": 4}, max_num_proc=2)
    p.do(lambda d, hm, f: d.start())
    assert p.ds[0].world_size == 2


def test_driver_counts_consecutive_all_failed_rounds(pair_factory):
    p = pair_factory({"a": 2})
    p.do(lambda d, hm, f: d.start())

    def fail_all(d, hm, f):
        for s in d.current_slots():
            d.handle_worker_exit(s.rank, 1, host_failure=True)
        return d.consecutive_failed_rounds
    assert p.do(fail_all) == 1

    def readmit(d, hm, f):
        hm._blacklist._entries.clear()
        hm.update_available_hosts()
        d._host_change.set()
        return d.maybe_reset()
    assert p.do(readmit)
    assert p.do(fail_all) == 2


def test_driver_success_resets_failed_round_counter(pair_factory):
    p = pair_factory({"a": 2})
    p.do(lambda d, hm, f: d.start())

    def mixed(d, hm, f):
        slots = d.current_slots()
        d.handle_worker_exit(slots[0].rank, 1)
        d.handle_worker_exit(slots[1].rank, 0)
        return d.consecutive_failed_rounds
    assert p.do(mixed) == 0


def test_round_publisher_publishes_assignments_then_the_round(monkeypatch):
    """Assignments (with the round's store address) are readable before
    the round bump, and the restore signal is cleared first."""
    from horovod_tpu_torch.elastic.driver import RoundPublisher
    from horovod_tpu_torch.runner.hosts import HostInfo, get_host_assignments

    puts = []

    class Rdv:
        def put(self, scope, key, value):
            puts.append((scope, key, value))

    pub = RoundPublisher(Rdv(), "127.0.0.1")
    slots = get_host_assignments([HostInfo("h", 2)], 2)
    pub.publish(slots, 1)
    pub.publish(slots, 2)
    pub.publish(slots, 3)
    keys = [(s, k) for s, k, _ in puts]
    assert keys[:4] == [("ckpt", "restoring"), ("elastic", "assign/1/h/0"),
                        ("elastic", "assign/1/h/1"), ("elastic", "round")]
    import json
    recs = {k: json.loads(v.decode()) for s, k, v in puts
            if k.startswith("assign/3/")}
    assert [r["rank"] for r in recs.values()] == [0, 1]
    assert {r["coord"] for r in recs.values()} == {pub.round_coords[3]}
    assert sorted(pub.round_coords) == [2, 3]  # round 1's store retired
    host, _, port = pub.round_coords[3].rpartition(":")
    store = torch.distributed.TCPStore(host, int(port), 2, is_master=False)
    store.set("k", "v")  # the round's store serves clients
    assert store.get("k") == b"v"
    pub.close()


# --------------------------------------------------------------------- state

def test_object_state_commit_restore(world):
    s = ObjectState(epoch=3, batch=7)
    s.epoch = 5
    s.restore()
    assert s.epoch == 3 and s.batch == 7
    s.epoch = 5
    s.commit()
    s.epoch = 9
    s.restore()
    assert s.epoch == 5
    s.epoch = 6
    s.sync()  # a world of one: rank 0's live values, then committed
    s.epoch = 1
    s.restore()
    assert s.epoch == 6 and s.batch == 7


def test_torch_state_save_restore_sync(world):
    model = torch.nn.Linear(4, 4)
    s = te.TorchState(model=model, epoch=0)
    w0 = model.weight.detach().clone()
    with torch.no_grad():
        model.weight.mul_(3)
    s.restore()
    assert torch.equal(model.weight, w0)
    s.epoch = 2
    s.commit()
    s.sync()  # a world of one: the broadcast is the identity
    assert s.epoch == 2
    assert torch.equal(model.weight, w0)


def test_elastic_run_retries_on_internal_error(world):
    calls = {"n": 0, "restores": 0, "syncs": 0}

    class S(ObjectState):
        def restore(self):
            calls["restores"] += 1
            super().restore()

        def sync(self):
            calls["syncs"] += 1
            super().sync()

    state = S(step=0)
    before = topology.rendezvous()

    @run
    def train(st):
        calls["n"] += 1
        if calls["n"] == 1:
            raise HorovodInternalError("simulated collective failure")
        return "done"

    assert train(state) == "done"
    assert calls["restores"] == 1
    assert calls["n"] == 2
    assert calls["syncs"] == 2  # initial + post-reset
    # the reset left the world and joined a new one in this process
    assert topology.is_initialized() and topology.rendezvous() != before


def test_elastic_run_hosts_updated_skips_restore(world):
    calls = {"n": 0, "restores": 0}

    class S(ObjectState):
        def restore(self):
            calls["restores"] += 1
            super().restore()

    state = S(step=0)

    @run
    def train(st):
        calls["n"] += 1
        if calls["n"] == 1:
            raise HostsUpdatedInterrupt(False)
        return 42

    assert train(state) == 42
    assert calls["restores"] == 0


def _train_linear(fail_at=None, steps=4):
    """SGD(momentum 0.9) through a DistributedOptimizer in a TorchState
    under run(); with `fail_at`, a HorovodInternalError after that
    step's backward (buckets in flight) once."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 2))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    state = te.TrainLoopState(model=model, optimizer=opt)
    failed = []
    losses = []

    @run
    def train(st):
        while st.step < steps:
            opt.zero_grad()
            loss = model(x).square().mean()
            loss.backward()
            if st.step == fail_at and not failed:
                failed.append(topology.rendezvous())
                raise HorovodInternalError("injected")
            opt.step()
            losses.append(loss.item())
            st.step += 1
            st.commit()
        return st.step

    assert train(state) == steps
    return model, opt, losses, failed


def test_optimizer_survives_the_in_process_reset(world, monkeypatch):
    """A DistributedOptimizer built before the reset reduces over the new
    world after it, with its plan and hooks kept; no kernel library is
    built or loaded again."""
    monkeypatch.setenv(C.HOROVOD_ELASTIC, "1")
    topology.shutdown()
    topology.init(device="cpu")
    libs = dict(kernels._libs)
    ref_model, _, ref_losses, _ = _train_linear()
    model, opt, losses, failed = _train_linear(fail_at=2)
    assert failed and topology.rendezvous() != failed[0]
    assert losses == ref_losses  # step 2 ran once, after the restore
    for a, b in zip(model.parameters(), ref_model.parameters()):
        assert torch.equal(a, b)
    assert opt.hooked and len(opt._hooks) == 4 and len(opt.plan) >= 1
    assert kernels._libs == libs


# ------------------------------------------------- failures in elastic mode

@pytest.mark.parametrize("msg", [
    "Connection closed by peer [127.0.0.1]:1234",
    "[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Read error",
    "Broken pipe", "some value error", "shape mismatch in user code",
    "DEADLINE_EXCEEDED: barrier", "Socket Timeout",
])
def test_comm_failure_markers_agree_with_jax(msg):
    assert collectives.is_comm_failure(RuntimeError(msg)) == \
        jcollectives.is_comm_failure(ValueError(msg))


def test_elastic_mode_converts_transport_failures(world, monkeypatch):
    """In elastic mode a transport failure inside an instrumented window
    or a handle's wait is a HorovodInternalError; outside it, raw."""
    boom = RuntimeError("Connection closed by peer")
    with pytest.raises(RuntimeError, match="closed by peer"):
        with collectives.instrument("x", "ALLREDUCE"):
            raise boom
    topology._state.config.elastic = True
    try:
        with pytest.raises(HorovodInternalError, match="closed by peer"):
            with collectives.instrument("x", "ALLREDUCE"):
                raise boom

        class Work:
            def wait(self):
                raise torch.distributed.DistBackendError("NCCL timed out")
        with pytest.raises(HorovodInternalError):
            collectives.Handle(Work(), None, name="w").wait()
        with pytest.raises(ValueError):  # a user error stays as it is
            with collectives.instrument("x", "ALLREDUCE"):
                raise ValueError("bad shape")
    finally:
        topology._state.config.elastic = False


def test_elastic_init_sets_the_nccl_error_handling(monkeypatch):
    monkeypatch.delenv("TORCH_NCCL_BLOCKING_WAIT", raising=False)
    monkeypatch.delenv("TORCH_NCCL_ASYNC_ERROR_HANDLING", raising=False)
    monkeypatch.setenv(C.HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, "")
    cfg = C.Config.from_env()
    assert topology._elastic_timeout(cfg).total_seconds() == \
        C.DEFAULT_ELASTIC_COLLECTIVE_TIMEOUT_SECONDS
    assert os.environ["TORCH_NCCL_BLOCKING_WAIT"] == "1"
    assert os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] == "0"
    monkeypatch.setenv(C.HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, "7")
    assert topology._elastic_timeout(
        C.Config.from_env()).total_seconds() == 7.0


# -------------------------------------- torch states (test_frontend_elastic)

def test_torch_state_commit_restore(world):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    state = te.TorchState(model=model, optimizer=opt, epoch=0, batch=0)
    w0 = model.weight.detach().clone()
    state.commit()
    with torch.no_grad():
        model.weight += 1.0
    state.epoch = 5
    state.restore()
    assert torch.equal(model.weight, w0)
    assert state.epoch == 0
    model(torch.randn(4, 3)).sum().backward()
    opt.step()
    w1 = model.weight.detach().clone()
    state.commit()
    with torch.no_grad():
        model.weight.zero_()
    state.restore()
    assert torch.equal(model.weight, w1)


def test_torch_state_sync(world):
    model = torch.nn.Linear(2, 2)
    state = te.TorchState(model=model, epoch=3)
    state.sync()  # identical ranks: the broadcast is an identity
    assert state.epoch == 3


def test_elastic_sampler_reshard_and_resume(world):
    k = hvd.size()
    n = 10 * k
    data = list(range(n))
    s = te.ElasticSampler(data, shuffle=False)
    per_rank = n // k
    assert len(s) == per_rank
    assert s.indices == list(range(per_rank))
    s.record_batch(0, 4)
    assert s.processed_indices == [0, 1, 2, 3]
    sd = s.state_dict()
    s2 = te.ElasticSampler(data, shuffle=False)
    s2.load_state_dict(sd)
    assert len(s2) == (n - 4) // k
    assert not set(s2.indices) & {0, 1, 2, 3}
    s2.sync()  # allgather union across (identical) ranks
    assert not set(s2.indices) & {0, 1, 2, 3}
    s2.set_epoch(1)
    assert len(s2) == per_rank


def test_torch_state_setattr_rebinds_handler(world):
    old = te.ElasticSampler(list(range(12)), shuffle=False)
    state = te.TorchState(model=torch.nn.Linear(2, 2), sampler=old)
    assert state._handlers["sampler"].value is old
    new = te.ElasticSampler(list(range(24)), shuffle=False)
    state.sampler = new
    assert state.sampler is new
    assert state._handlers["sampler"].value is new
    new.record_batch(0, 4)
    state.restore()
    assert new.processed_indices == []
    first = new.indices[0]
    new.record_batch(0, 1)
    state.commit()
    new.record_batch(1, 1)
    assert len(new.processed_indices) == 2
    state.restore()
    assert new.processed_indices == [first]
    new_model = torch.nn.Linear(4, 4)
    state.model = new_model
    assert state._handlers["model"].value is new_model
    w0 = new_model.weight.detach().clone()
    with torch.no_grad():
        new_model.weight.add_(1.0)
    state.restore()
    assert torch.equal(new_model.weight, w0)
    late_state = te.TorchState(epoch=0)
    late = torch.nn.Linear(2, 2)
    late_state.model = late
    assert "model" in late_state._handlers
    lw0 = late.weight.detach().clone()
    late_state.commit()
    with torch.no_grad():
        late.weight.add_(1.0)
    late_state.restore()
    assert torch.equal(late.weight, lw0)


def test_torch_state_checkpoint_resume_roundtrip(world, tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    state = te.TorchState(model=model, optimizer=opt, step=0, epoch=0,
                          root=str(tmp_path))
    assert state.checkpointer is not None
    model(torch.randn(4, 3)).sum().backward()
    opt.step()
    state.step, state.epoch = 7, 1
    state.commit()
    assert state.checkpoint(block=True)
    want = {k: v.clone() for k, v in model.state_dict().items()}

    model2 = torch.nn.Linear(3, 2)
    opt2 = torch.optim.SGD(model2.parameters(), lr=0.1, momentum=0.9)
    state2 = te.TorchState(model=model2, optimizer=opt2, step=0, epoch=0,
                           root=str(tmp_path))
    state2.sync()  # resume probe + identity broadcast
    assert state2.last_resume_source == "checkpoint"
    assert (state2.step, state2.epoch) == (7, 1)
    for k, v in want.items():
        assert torch.equal(model2.state_dict()[k], v), k
    for p, q in zip(model.parameters(), model2.parameters()):
        assert torch.equal(opt.state[p]["momentum_buffer"],
                           opt2.state[q]["momentum_buffer"])
    state2.step = 9
    state2.commit()
    assert not state2.maybe_resume()
    assert state2.last_resume_source == "memory"
    assert state2.step == 9


def test_torch_state_maybe_checkpoint_cadence(world, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("HOROVOD_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_CKPT_EVERY", "4")
    state = te.TorchState(model=torch.nn.Linear(2, 2), step=0)
    assert state.every_n == 4
    state.step = 3
    state.commit()
    assert not state.maybe_checkpoint()
    state.step = 4
    state.commit()
    assert state.maybe_checkpoint()
    assert state.checkpointer.wait()


def test_torch_state_handler_registry(world):
    aux = torch.nn.Linear(2, 2)
    sampler = te.ElasticSampler(list(range(12)), shuffle=False)
    dopt = hvd.DistributedOptimizer(torch.optim.SGD(aux.parameters(),
                                                    lr=0.1))
    state = te.TorchState(model=torch.nn.Linear(3, 3),
                          optimizer=torch.optim.SGD(aux.parameters(),
                                                    lr=0.1),
                          aux_model=aux, sampler=sampler, dopt=dopt,
                          epoch=5)
    assert isinstance(state._handlers["aux_model"], te.ModelStateHandler)
    assert isinstance(state._handlers["sampler"], te.SamplerStateHandler)
    assert isinstance(state._handlers["dopt"], te.OptimizerStateHandler)
    assert state.epoch == 5
    state.commit()
    with torch.no_grad():
        aux.weight.add_(1.0)
    changed = aux.weight.detach().clone()
    state.restore()
    assert not torch.equal(changed, aux.weight)

    class Thing:
        def __init__(self):
            self.v = 0

    class ThingHandler(te.StateHandler):
        def save(self):
            self._saved = self.value.v

        def restore(self):
            self.value.v = self._saved

        def sync(self):
            pass

    te.set_handler_registry(te.get_handler_registry()
                            + [(Thing, ThingHandler)])
    try:
        thing = Thing()
        st2 = te.TorchState(thing=thing)
        st2.commit()
        thing.v = 42
        st2.restore()
        assert thing.v == 0
    finally:
        te.set_handler_registry(te._default_registry())
        for h in dopt._hooks:
            h.remove()
