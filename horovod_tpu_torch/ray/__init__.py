"""Ray orchestration of the port (counterpart of horovod_tpu/ray/).

Reference: horovod/ray/runner.py RayExecutor (:168) — colocated actor
placement, Gloo rendezvous driven by a Coordinator actor (:45), and an
elastic variant (elastic_v2.py). One Ray actor is one worker process;
rendezvous is the port's KV server on the driver: each actor's
environment carries its rank, the world size and the KV's address
(HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT), and the function it runs calls
`hvd.init()`, whose rank 0 publishes the world's TCPStore through that
KV. `hvd.init()` takes the card, so on a real cluster the actors must
see one (an actor that requests only CPUs sees no GPU and its init
raises); a function that calls `hvd.init(device="cpu")` runs on gloo.

Import-gated: only needs ray when actually used.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


def _require_ray():
    try:
        import ray
        return ray
    except ImportError as e:
        raise ImportError("horovod_tpu_torch.ray requires ray (reference "
                          "extra: horovod[ray])") from e


class RayExecutor:
    """Reference: RayExecutor (ray/runner.py:168) — start() creates the
    worker actors, run() executes a function on all of them, shutdown()
    tears down."""

    def __init__(self, num_workers: int,
                 cpus_per_worker: int = 1,
                 use_current_placement_group: bool = True,
                 placement_group_strategy: Optional[str] = None,
                 env_vars: Optional[dict] = None):
        self.num_workers = num_workers
        self.cpus_per_worker = cpus_per_worker
        # "PACK"/"SPREAD"/"STRICT_PACK"/"STRICT_SPREAD" creates a fresh
        # placement group for the actors (reference: ray/runner.py
        # colocated placement groups); None schedules loose (or inside
        # the caller's current pg, which Ray applies by default).
        self.placement_group_strategy = placement_group_strategy
        self.use_current_placement_group = use_current_placement_group
        self.env_vars = dict(env_vars or {})
        self._actors: List[Any] = []
        self._rdv = None
        self._pg = None
        self._pg_ours = False  # created by us (per-rank bundles) vs
        # the caller's current placement group (no bundle pinning)

    def start(self) -> None:
        ray = _require_ray()

        from horovod_tpu_torch.common import config as C
        from horovod_tpu_torch.runner import secret as secret_mod
        from horovod_tpu_torch.runner.launch import _local_ip
        from horovod_tpu_torch.runner.rendezvous import RendezvousServer

        job_secret = secret_mod.make_secret_key()
        self.env_vars[secret_mod.SECRET_ENV] = job_secret
        self._rdv = RendezvousServer(secret=job_secret.encode())
        self._rdv.start()
        self.env_vars.update(self._rdv.worker_env(_local_ip()))

        @ray.remote(num_cpus=self.cpus_per_worker)
        class Worker:
            def __init__(self, rank: int, size: int, env: dict):
                import os
                os.environ.update(env)
                os.environ[C.HOROVOD_RANK] = str(rank)
                os.environ[C.HOROVOD_SIZE] = str(size)

            def execute(self, fn, *args, **kwargs):
                from horovod_tpu_torch.runner.results import capture
                return capture(fn, *args, **kwargs)

        self._worker_cls = Worker
        if self.placement_group_strategy:
            self._pg = _maybe_placement_group(
                ray, self.num_workers, self.cpus_per_worker,
                self.placement_group_strategy)
            self._pg_ours = True
        elif self.use_current_placement_group:
            # Schedule inside the caller's placement group when one is
            # active (reference: RayExecutor use_current_placement_group).
            try:
                from ray.util import get_current_placement_group
                self._pg = get_current_placement_group()
            except (ImportError, AttributeError):
                self._pg = None
        self._actors = [self._make_actor(i) for i in range(self.num_workers)]

    def _make_actor(self, rank: int):
        cls = self._worker_cls
        if self._pg is not None:
            from ray.util.scheduling_strategies import \
                PlacementGroupSchedulingStrategy

            opts = {"placement_group": self._pg}
            if self._pg_ours:  # our pg has one bundle per rank
                opts["placement_group_bundle_index"] = rank
            cls = cls.options(
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    **opts))
        return cls.remote(rank, self.num_workers, self.env_vars)

    def _collect(self, fn, args, kwargs):
        """Submit `fn` to every actor; gather (results, dead_ranks).

        Uses ray.wait so an actor DEATH is observed even while survivors
        are blocked inside a collective against the dead peer (peer death
        does not reliably surface as an error in the survivors — the same
        reality is_comm_failure handles in the elastic launcher path).
        Returns as soon as a death is seen; the caller decides whether to
        fail the job or restart the ring."""
        ray = _require_ray()

        from horovod_tpu_torch.runner.results import PerRankResults
        futures = {a.execute.remote(fn, *args, **kwargs): rank
                   for rank, a in enumerate(self._actors)}
        collected = PerRankResults(self.num_workers)
        pending = list(futures)
        dead: List[int] = []
        while pending and not dead:
            done, pending = ray.wait(pending, num_returns=1)
            for fut in done:
                rank = futures[fut]
                try:
                    ok, payload = ray.get(fut)
                    collected.add(rank, ok, payload)
                except Exception:  # RayActorError — the actor process died
                    dead.append(rank)
        return collected, dead

    def _restart_ring(self) -> None:
        """Kill every actor and recreate the full ring: survivors may be
        blocked inside a collective against a dead peer and cannot accept
        new work (reference: elastic reset re-forms the whole Gloo ring)."""
        ray = _require_ray()
        for a in self._actors:
            try:
                ray.kill(a)
            except Exception:
                pass
        old_n = self.num_workers
        self._resize_for_restart()
        if self._pg_ours and self.num_workers != old_n:
            # Bundle count must match the ring: recreate the placement
            # group at the new size (stale bundles would either reject
            # out-of-range bundle_index on grow or strand reservations
            # on shrink).
            try:
                from ray.util.placement_group import remove_placement_group
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = _maybe_placement_group(
                ray, self.num_workers, self.cpus_per_worker,
                self.placement_group_strategy)
        self._actors = [self._make_actor(i)
                        for i in range(self.num_workers)]

    def _resize_for_restart(self) -> None:
        """Hook: elastic subclass recomputes num_workers from discovery."""

    def run(self, fn: Callable, args=(), kwargs=None) -> List[Any]:
        """Execute `fn` on every worker; per-rank results in rank order.
        A failing rank raises RemoteJobError naming it with its remote
        traceback (reference: run_remote + ray.get surface task errors)."""
        from horovod_tpu_torch.runner.results import RemoteJobError
        collected, dead = self._collect(fn, args, kwargs or {})
        if dead:
            self._restart_ring()  # unblock survivors; job has failed
            raise RemoteJobError(
                f"worker actor(s) for rank(s) {sorted(dead)} died "
                f"(preemption or crash); surviving workers were restarted")
        return collected.values()

    def execute_single(self, fn: Callable, rank: int = 0,
                       args=(), kwargs=None) -> Any:
        """Run `fn` on one worker (reference: RayExecutor.execute_single)."""
        ray = _require_ray()
        ok, payload = ray.get(
            self._actors[rank].execute.remote(fn, *(args or ()),
                                              **(kwargs or {})))
        if not ok:
            from horovod_tpu_torch.runner.results import RemoteJobError
            raise RemoteJobError(f"rank {rank} failed:\n{payload}")
        return payload

    def shutdown(self) -> None:
        ray = _require_ray()
        for a in self._actors:
            ray.kill(a)
        self._actors = []
        if self._pg_ours and self._pg is not None:
            try:
                from ray.util.placement_group import remove_placement_group
                remove_placement_group(self._pg)
            except Exception:
                pass
        self._pg = None
        self._pg_ours = False
        if self._rdv is not None:
            self._rdv.stop()
            self._rdv = None


class ElasticRayExecutor(RayExecutor):
    """Elastic variant: dead actors are recreated and the function retried
    (reference: ray/elastic_v2.py — workers lost to preemption are
    restarted from the autoscaler pool within retry limits). State recovery
    rides the same hvd.elastic.run/State machinery as the launcher path."""

    def __init__(self, *args, max_restarts: int = 3,
                 discovery: Optional["RayHostDiscovery"] = None,
                 min_workers: int = 1,
                 max_workers: Optional[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        from horovod_tpu_torch.runner.results import RestartPolicy
        self.policy = RestartPolicy(max_restarts=max_restarts)
        # With a discovery object the ring RESIZES on restart to what the
        # cluster currently offers (reference: elastic_v2's autoscaler-
        # driven host set), instead of insisting on the original size.
        self.discovery = discovery
        self.min_workers = max(1, int(min_workers))
        self.max_workers = max_workers

    def _resize_for_restart(self) -> None:
        if self.discovery is None:
            return
        slots = sum(self.discovery.find_available_hosts_and_slots()
                    .values())
        if self.max_workers is not None:
            slots = min(slots, self.max_workers)
        if slots < self.min_workers:
            from horovod_tpu_torch.runner.results import RemoteJobError
            raise RemoteJobError(
                f"cluster offers {slots} worker slots, below "
                f"min_workers={self.min_workers}")
        self.num_workers = slots

    def run(self, fn: Callable, args=(), kwargs=None) -> List[Any]:
        from horovod_tpu_torch.runner.results import RemoteJobError
        kwargs = kwargs or {}
        while True:
            collected, dead = self._collect(fn, args, kwargs)
            if not dead:
                return collected.values()
            for rank in dead:
                if not self.policy.should_restart(rank):
                    raise RemoteJobError(
                        f"rank {rank} exceeded {self.policy.max_restarts} "
                        f"restarts (reference: elastic_v2 retry limits)")
                self.policy.record_restart(rank)
            # The whole ring restarts (survivors are blocked against the
            # dead peer); in-actor state recovers through the user's
            # hvd.elastic.State commit/restore like the launcher path.
            self._restart_ring()


class RayHostDiscovery:
    """Host/slot discovery from Ray's cluster state (reference:
    ray/elastic_v2.py:40 RayHostDiscovery over ray.nodes()).

    Slots per host = available CPUs // cpus_per_worker, optionally clamped
    by GPUs or TPUs per worker (the JAX package's "TPU" resource key, kept
    so that one discovery reads both kinds of cluster).
    Duck-typed to elastic.discovery.HostDiscovery so it drops into
    HostManager unchanged.
    """

    def __init__(self, use_gpu: bool = False, cpus_per_worker: int = 1,
                 gpus_per_worker: int = 1, tpus_per_worker: int = 0):
        self.use_gpu = use_gpu
        self.cpus_per_worker = max(1, int(cpus_per_worker))
        self.gpus_per_worker = max(1, int(gpus_per_worker))
        self.tpus_per_worker = int(tpus_per_worker)

    def find_available_hosts_and_slots(self) -> dict:
        ray = _require_ray()
        mapping: dict = {}
        for node in ray.nodes():
            if not node.get("alive"):
                continue
            res = node.get("Resources", {}) or {}
            slots = int(res.get("CPU", 0)) // self.cpus_per_worker
            if self.use_gpu:
                slots = min(slots,
                            int(res.get("GPU", 0)) // self.gpus_per_worker)
            if self.tpus_per_worker:
                slots = min(slots,
                            int(res.get("TPU", 0)) // self.tpus_per_worker)
            if slots > 0:
                mapping[node["NodeManagerAddress"]] = int(slots)
        return mapping


def _maybe_placement_group(ray, num_workers: int, cpus_per_worker: int,
                           strategy: str):
    """Create (pg, ready) for colocated scheduling (reference:
    ray/runner.py create_placement_group usage in RayExecutor.start)."""
    from ray.util.placement_group import placement_group

    bundles = [{"CPU": cpus_per_worker} for _ in range(num_workers)]
    pg = placement_group(bundles, strategy=strategy)
    ray.get(pg.ready())
    return pg
