"""Spark orchestration of the port (counterpart of horovod_tpu/spark/).

Reference: horovod/spark/__init__.py + spark/runner.py —
`horovod.spark.run(fn, ...)` spawns a Spark job whose tasks each run one
worker (`_task_fn`, runner.py:49), with the driver doing rendezvous.

The Estimator stack (reference: spark/common/estimator.py, store.py,
util.py, params.py + spark/{keras,torch,lightning}/) lives in the sibling
modules: `store` (fsspec-backed Store), `params`, `util` (DataFrame →
parquet + shard readers), `backend` (pluggable Spark/Local execution),
`estimator` (TorchEstimator / KerasEstimator / LightningEstimator and
their models), and `elastic` (run_elastic over long-lived Spark tasks).

Every worker takes the card unless its environment asks for the host
(backend.worker_device). This module needs pyspark only when `run` is
called.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
        return pyspark
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark requires pyspark (reference extra: "
            "horovod[spark])") from e


def task_slot(index: int, addresses: List[str]):
    """The SlotInfo of Spark task `index` among tasks whose executors
    are at `addresses` ("host:port", in task order): each machine's tasks
    take consecutive ranks and local ranks 0..n-1, the machines in the
    order of their first task (reference: the Spark driver groups its
    tasks by host hash, spark/runner.py)."""
    from horovod_tpu_torch.runner.hosts import HostInfo, get_host_assignments

    machines = [a.rsplit(":", 1)[0] for a in addresses]
    order = list(dict.fromkeys(machines))
    slots = get_host_assignments(
        [HostInfo(m, machines.count(m)) for m in order], len(machines))
    mine = machines[index]
    local = machines[:index].count(mine)
    return next(s for s in slots
                if s.hostname == mine and s.local_rank == local)


def run(fn: Callable[[], Any], args=(), kwargs=None,
        num_proc: Optional[int] = None, extra_env: Optional[dict] = None,
        verbose: int = 1) -> List[Any]:
    """Run `fn(*args, **kwargs)` once per Spark task slot (reference:
    spark/runner.py:200) and return each rank's result in rank order.

    Each Spark task becomes one worker. The tasks run as one barrier
    stage, all at once as a world must, and each reads every task's
    executor address from its BarrierTaskContext to find its slot
    (`task_slot`): the tasks on one machine get local ranks 0..n-1 and so
    take cards cuda:0..n-1. The driver starts the rendezvous KV (signed
    with a per-job secret), each task sets its slot and the rendezvous
    address in its environment, and `fn` calls `hvd.init()`, whose rank 0
    publishes the world's store through that KV. A task's exception
    travels back as data, so the driver names the failed ranks with
    their tracebacks (RemoteJobError).
    """
    pyspark = _require_pyspark()

    from horovod_tpu_torch.runner import _dumps
    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.launch import _local_ip
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    from horovod_tpu_torch.runner.results import PerRankResults

    sc = pyspark.SparkContext._active_spark_context
    if sc is None:
        raise RuntimeError("no active SparkContext; create a SparkSession "
                           "first (reference: spark/runner.py checks the "
                           "same)")
    np_ = num_proc or int(sc.defaultParallelism)
    payload = _dumps((fn, tuple(args), dict(kwargs or {})))

    job_secret = secret_mod.make_secret_key()
    rdv = RendezvousServer(secret=job_secret.encode())
    rdv.start()
    env = dict(extra_env or {})
    env[secret_mod.SECRET_ENV] = job_secret
    env.update(rdv.worker_env(_local_ip()))

    def task_fn(index, _it):
        # Reference: _task_fn (spark/runner.py:49) — set worker identity
        # env, then run the user function.
        import os as _os
        import pickle as _pickle

        from pyspark import BarrierTaskContext

        from horovod_tpu_torch.runner.results import capture
        from horovod_tpu_torch.spark import task_slot as _task_slot
        slot = _task_slot(index, [t.address for t in
                                  BarrierTaskContext.get().getTaskInfos()])
        _os.environ.update(env)
        _os.environ.update(slot.to_env())
        f, a, kw = _pickle.loads(payload)
        ok, result = capture(f, *a, **kw)
        yield (slot.rank, ok, result)

    collected = PerRankResults(np_)
    try:
        for rank, ok, result in (sc.parallelize(range(np_), np_).barrier()
                                 .mapPartitionsWithIndex(task_fn)
                                 .collect()):
            collected.add(rank, ok, result)
    finally:
        rdv.stop()
    return collected.values()


# Estimator stack re-exports (reference: horovod.spark.keras.KerasEstimator
# etc. are imported from the subpackages; here one namespace).
from horovod_tpu_torch.spark.backend import (  # noqa: E402,F401
    Backend, LocalBackend, SparkBackend)
from horovod_tpu_torch.spark.estimator import (  # noqa: E402,F401
    HorovodEstimator, HorovodModel, KerasEstimator, KerasModel,
    LightningEstimator, TorchEstimator, TorchModel)
from horovod_tpu_torch.spark.store import (  # noqa: E402,F401
    FilesystemStore, HDFSStore, LocalStore, Store)
from horovod_tpu_torch.spark.elastic import run_elastic  # noqa: E402,F401
