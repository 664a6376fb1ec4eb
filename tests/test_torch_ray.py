"""The port's Ray orchestration (horovod_tpu_torch/ray/) held against the
JAX package's (horovod_tpu/ray/) under the JAX tests' stub `ray`
(tests/test_ray_executor.py: actors whose execute runs in this process,
actor deaths scripted per rank, ray.wait surfacing dead futures first).

Every case runs through both packages' executors with the same script
and must give the same results: per-rank results in rank order, a worker
error naming its rank, an actor death that fails the run and restarts
the ring, elastic restarts within per-rank limits and the give-up past
them, the ring resized from discovery and refused below min_workers,
RayHostDiscovery's slots from the same node records, and placement
groups with one bundle per rank. Beyond the JAX cases: the actors'
environment carries the job secret and the rendezvous KV's address
under the port's names, and a worker function that calls `hvd.init()`
asks for the card (on this host it raises naming the missing card)
unless it asks for the CPU.
"""

import sys
import types

import pytest

import horovod_tpu.ray as jray
import horovod_tpu_torch.ray as tray
from horovod_tpu.runner.results import RemoteJobError as JRemoteJobError
from horovod_tpu_torch.runner.results import RemoteJobError
from test_ray_executor import _nodes_fixture, stub_ray  # noqa: F401

PKGS = {"port": (tray, RemoteJobError), "jax": (jray, JRemoteJobError)}


@pytest.fixture(params=["port", "jax"])
def pkg(request):
    return PKGS[request.param]


def test_run_collects_per_rank_results(stub_ray, pkg):
    mod, _ = pkg
    ex = mod.RayExecutor(num_workers=4)
    ex.start()
    try:
        assert ex.run(lambda rank: rank * 10) == [0, 10, 20, 30]
        assert ex.execute_single(lambda rank: rank + 1, rank=2) == 3
    finally:
        ex.shutdown()


def test_run_surfaces_worker_exception_with_rank(stub_ray, pkg):
    mod, err = pkg

    def fn(rank):
        if rank == 2:
            raise ValueError("boom on two")
        return rank

    ex = mod.RayExecutor(num_workers=3)
    ex.start()
    try:
        with pytest.raises(err) as ei:
            ex.run(fn)
        assert "rank 2 failed" in str(ei.value)
        assert "boom on two" in str(ei.value)
        with pytest.raises(err, match="rank 2 failed"):
            ex.execute_single(fn, rank=2)
    finally:
        ex.shutdown()


def test_run_actor_death_fails_and_restarts_ring(stub_ray, pkg):
    mod, err = pkg
    ex = mod.RayExecutor(num_workers=3)
    ex.start()
    try:
        stub_ray.dead_ranks_this_round[1] = 1
        with pytest.raises(err) as ei:
            ex.run(lambda rank: rank)
        assert "[1]" in str(ei.value)
        assert len(stub_ray.killed) >= 3
        assert ex.run(lambda rank: rank) == [0, 1, 2]
    finally:
        ex.shutdown()


def test_elastic_restarts_within_limits(stub_ray, pkg):
    mod, _ = pkg
    ex = mod.ElasticRayExecutor(num_workers=3, max_restarts=2)
    ex.start()
    try:
        stub_ray.dead_ranks_this_round[2] = 2  # dies twice, then recovers
        assert ex.run(lambda rank: rank + 1) == [1, 2, 3]
        assert ex.policy.restarts(2) == 2 and ex.policy.restarts(0) == 0
    finally:
        ex.shutdown()


def test_elastic_gives_up_past_restart_limit(stub_ray, pkg):
    mod, err = pkg
    ex = mod.ElasticRayExecutor(num_workers=2, max_restarts=1)
    ex.start()
    try:
        stub_ray.dead_ranks_this_round[0] = 5
        with pytest.raises(err, match="exceeded 1 restarts"):
            ex.run(lambda rank: rank)
    finally:
        ex.shutdown()


def test_host_discovery_matches_jax(stub_ray):
    stub_ray.mod.nodes = _nodes_fixture
    cases = [dict(cpus_per_worker=2),
             dict(use_gpu=True, cpus_per_worker=1, gpus_per_worker=1),
             dict(cpus_per_worker=1, tpus_per_worker=4)]
    got = [tray.RayHostDiscovery(**kw).find_available_hosts_and_slots()
           for kw in cases]
    assert got == [jray.RayHostDiscovery(**kw)
                   .find_available_hosts_and_slots() for kw in cases]
    assert got == [{"10.0.0.1": 4, "10.0.0.2": 2}, {"10.0.0.2": 2},
                   {"10.0.0.1": 1}]


def test_elastic_resizes_ring_from_discovery(stub_ray, pkg):
    mod, _ = pkg

    class _Shrinking:
        def find_available_hosts_and_slots(self):
            return {"h1": 2}

    ex = mod.ElasticRayExecutor(3, max_restarts=2, discovery=_Shrinking())
    ex.start()
    assert len(ex._actors) == 3
    stub_ray.dead_ranks_this_round = {2: 1}
    assert ex.run(lambda rank: "ok") == ["ok", "ok"]
    assert ex.num_workers == 2


def test_elastic_resize_below_min_fails(stub_ray, pkg):
    mod, err = pkg

    class _Empty:
        def find_available_hosts_and_slots(self):
            return {}

    ex = mod.ElasticRayExecutor(2, max_restarts=5, discovery=_Empty(),
                                min_workers=2)
    ex.start()
    stub_ray.dead_ranks_this_round = {0: 1}
    with pytest.raises(err, match="below"):
        ex.run(lambda rank: "ok")


def _placement_stubs(monkeypatch):
    created = {}

    class _PG:
        def ready(self):
            class _Ready:
                dead = False
                value = "pg-ready"
            return _Ready()

    def placement_group(bundles, strategy):
        created["bundles"], created["strategy"] = bundles, strategy
        return _PG()

    pg_mod = types.ModuleType("ray.util.placement_group")
    pg_mod.placement_group = placement_group
    pg_mod.remove_placement_group = lambda pg: created.setdefault(
        "removed", True)
    sched_mod = types.ModuleType("ray.util.scheduling_strategies")

    class PlacementGroupSchedulingStrategy:
        def __init__(self, placement_group, placement_group_bundle_index):
            created.setdefault("bundle_indices", []).append(
                placement_group_bundle_index)

    sched_mod.PlacementGroupSchedulingStrategy = \
        PlacementGroupSchedulingStrategy
    monkeypatch.setitem(sys.modules, "ray.util",
                        types.ModuleType("ray.util"))
    monkeypatch.setitem(sys.modules, "ray.util.placement_group", pg_mod)
    monkeypatch.setitem(sys.modules, "ray.util.scheduling_strategies",
                        sched_mod)
    return created


def test_placement_group_scheduling(stub_ray, monkeypatch, pkg):
    mod, _ = pkg
    created = _placement_stubs(monkeypatch)
    ex = mod.RayExecutor(2, cpus_per_worker=3,
                         placement_group_strategy="STRICT_SPREAD")
    ex.start()
    assert created["bundles"] == [{"CPU": 3}, {"CPU": 3}]
    assert created["strategy"] == "STRICT_SPREAD"
    assert created["bundle_indices"] == [0, 1]
    ex.shutdown()
    assert created.get("removed")


def test_actor_env_carries_the_secret_and_rendezvous(stub_ray):
    ex = tray.RayExecutor(num_workers=2, env_vars={"A": "1"})
    ex.start()
    try:
        env = ex.env_vars
        assert env["A"] == "1" and len(env["HOROVOD_SECRET_KEY"]) == 64
        assert int(env["HOROVOD_GLOO_RENDEZVOUS_PORT"]) == ex._rdv.port
        assert env["HOROVOD_GLOO_RENDEZVOUS_ADDR"]
    finally:
        ex.shutdown()
    assert ex._rdv is None


def _init_and_report(device):
    def fn(rank):
        import horovod_tpu_torch as hvd
        hvd.init(device=device)
        try:
            return hvd.size(), str(hvd.device())
        finally:
            hvd.shutdown()
    return fn


def test_workers_ask_for_the_card_unless_asked_for_the_cpu(stub_ray,
                                                           monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = tray.RayExecutor(num_workers=1)
    ex.start()
    try:
        with pytest.raises(RemoteJobError,
                           match="no CUDA device is visible"):
            ex.run(_init_and_report(None))
        assert ex.run(_init_and_report("cpu")) == [(1, "cpu")]
    finally:
        ex.shutdown()


def test_ray_is_required(monkeypatch):
    monkeypatch.setitem(sys.modules, "ray", None)
    with pytest.raises(ImportError, match="requires ray"):
        tray.RayExecutor(1).start()
