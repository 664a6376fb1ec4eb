"""Pluggable execution backends for the estimator (counterpart of
horovod_tpu/spark/backend.py).

Reference: horovod/spark/common/backend.py — Backend/SparkBackend run the
remote training function on the cluster. Spark is one placement
provider; `LocalBackend` (the port's own launcher, `runner.run`) trains
the same estimator with no Spark installed.

Workers take the card: each calls `hvd.init(device=worker_device())`,
which is the card unless the caller asked for the host by setting
HOROVOD_WORKER_PLATFORM=cpu in the workers' environment
(`LocalBackend(use_cpu=True)` does). A worker that finds no card and
was not asked for the host raises in hvd.init; nothing falls back to
the CPU.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Optional

# The workers' environment variable that asks them for the host (gloo)
# in place of the card (NCCL); the JAX package's spelling.
WORKER_PLATFORM = "HOROVOD_WORKER_PLATFORM"


def worker_device() -> Optional[str]:
    """What a worker passes to `hvd.init(device=...)`: "cpu" when its
    environment asks for the host, else None (the card)."""
    return "cpu" if os.environ.get(WORKER_PLATFORM) == "cpu" else None


class Backend:
    """Reference: backend.py Backend interface (run / num_processes)."""

    def run(self, fn: Callable[..., Any], args=(),
            env: Optional[dict] = None) -> List[Any]:
        raise NotImplementedError()

    def num_processes(self) -> int:
        raise NotImplementedError()


class LocalBackend(Backend):
    """Train with the port's own launcher: one worker process per rank on
    this host, each on its own card (`cuda:<local rank>`), or on the host
    over gloo with use_cpu=True. No Spark required."""

    def __init__(self, num_proc: int = 1,
                 extra_env: Optional[dict] = None,
                 use_cpu: bool = False):
        self._np = num_proc
        self._env = dict(extra_env or {})
        if use_cpu:
            self._env[WORKER_PLATFORM] = "cpu"

    def num_processes(self) -> int:
        return self._np

    def run(self, fn, args=(), env=None) -> List[Any]:
        import functools

        from horovod_tpu_torch import runner

        merged = dict(self._env)
        merged.update(env or {})
        # A partial of a module-level fn pickles without cloudpickle.
        return runner.run(functools.partial(fn, *args), np=self._np,
                          extra_env=merged)


class SparkBackend(Backend):
    """Run the trainer inside Spark tasks (reference: backend.py
    SparkBackend → spark/runner.py run)."""

    def __init__(self, num_proc: Optional[int] = None, verbose: int = 1,
                 extra_env: Optional[dict] = None):
        self._np = num_proc
        self._verbose = verbose
        self._env = dict(extra_env or {})

    def num_processes(self) -> int:
        if self._np is not None:
            return self._np
        import pyspark

        sc = pyspark.SparkContext._active_spark_context
        if sc is None:
            raise RuntimeError("no active SparkContext; pass num_proc")
        return sc.defaultParallelism

    def run(self, fn, args=(), env=None) -> List[Any]:
        from horovod_tpu_torch import spark as hvd_spark

        merged = dict(self._env)
        merged.update(env or {})
        return hvd_spark.run(fn, args=args, num_proc=self.num_processes(),
                             extra_env=merged, verbose=self._verbose)
