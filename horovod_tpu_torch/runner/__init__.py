"""Launcher package (counterpart of horovod_tpu/runner/).

`run(fn, np)` is the interactive API (horovod.run): it launches `fn` on
np worker processes through `launch_static` and returns each rank's
result, in rank order. The function is pickled with cloudpickle where
that is installed and with the standard pickle otherwise, which sends a
module-level function by its import path. Each worker runs it as it is:
the function calls `hvd.init()` itself.
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
from typing import Any, Callable, List, Optional

from horovod_tpu_torch.runner.results import PerRankResults, RemoteJobError


def _dumps(fn: Callable) -> bytes:
    try:
        import cloudpickle
    except ImportError:
        return pickle.dumps(fn)
    return cloudpickle.dumps(fn)


def run(fn: Callable[[], Any], np: int = 1,
        hosts: Optional[str] = None,
        extra_env: Optional[dict] = None,
        stdout=None, timeout: Optional[float] = None) -> List[Any]:
    """Run `fn` on np worker processes; return [fn() result per rank].

    A rank whose `fn` raised, or that returned nothing, makes the call
    raise RemoteJobError with each failed rank's traceback; so does a
    non-zero exit of the workers. With `timeout`, workers still running
    after that many seconds are terminated and TimeoutError is raised.
    """
    # launch is imported here, not at the top: `python -m
    # horovod_tpu_torch.runner.launch` imports this package first.
    from horovod_tpu_torch.runner.launch import launch_static
    spool = tempfile.mkdtemp(prefix="hvd_torch_run_")
    try:
        fn_path = os.path.join(spool, "fn.pkl")
        with open(fn_path, "wb") as f:
            f.write(_dumps(fn))
        env = dict(extra_env or {})
        env["HOROVOD_RUN_FUNC_FILE"] = fn_path
        env["HOROVOD_RUN_RESULT_DIR"] = spool
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.task_runner"]
        rc = launch_static(np, hosts or f"localhost:{np}", cmd, env,
                           stdout=stdout, timeout=timeout)
        results = PerRankResults(np)
        for rank in range(np):
            path = os.path.join(spool, f"rank_{rank}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    results.add(rank, *pickle.load(f))
        values = results.values()
        if rc != 0:
            raise RemoteJobError(f"every rank returned, but the workers "
                                 f"exited with code {rc}")
        return values
    finally:
        shutil.rmtree(spool, ignore_errors=True)
