"""Elastic (fault-tolerant, resizable) training (counterpart of
horovod_tpu/elastic/, after horovod/common/elastic.py and
horovod/runner/elastic/).

Worker-side usage, as the reference's:

    state = hvd.elastic.TrainLoopState(model=model, optimizer=opt)

    @hvd.elastic.run
    def train(state):
        while state.step < total:
            ...one step...
            state.step += 1
            state.commit()
            state.maybe_checkpoint()

Launch it with the elastic launcher:
    python -m horovod_tpu_torch.runner.launch \\
        --host-discovery-script ./discover.sh --min-np 1 \\
        --slots-per-host 1 python train.py
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Callable

from horovod_tpu_torch.common import config as C
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HostsUpdatedInterrupt)
from horovod_tpu_torch.elastic.state import (  # noqa: F401
    CheckpointableState, ElasticSampler, ModelStateHandler, ObjectState,
    OptimizerStateHandler, SamplerStateHandler, State, StateHandler,
    TorchState, TrainLoopState, get_handler_registry, set_handler_registry,
)
from horovod_tpu_torch.elastic.discovery import (  # noqa: F401
    FixedHosts, HostDiscovery, HostDiscoveryScript, HostManager,
)
from horovod_tpu_torch.elastic.driver import ElasticDriver  # noqa: F401
from horovod_tpu_torch.elastic.registration import (  # noqa: F401
    WorkerStateRegistry,
)
from horovod_tpu_torch.elastic import worker as worker_mod


def _reset(state: State) -> None:
    """Re-join the job after a failure or a host change WITHOUT
    restarting the process, so in-memory state survives (reference:
    common/elastic.py reset(); runner/elastic/driver.py:240 keeps running
    workers' slots).

    Moves the committed state to the host, leaves the world (aborting an
    NCCL world's communicators), waits at the rendezvous for the driver's
    next round, adopts its rank, size, local and cross values and
    coordinator, and joins the new world. A worker whose slot was removed
    exits cleanly. With no launcher (no notifier) the reset is a leave
    and a join in the same process."""
    from horovod_tpu_torch.core import topology
    from horovod_tpu_torch.observability import flight
    from horovod_tpu_torch.ops import collectives

    flight.record("elastic", "reset: detaching state and leaving the "
                  "current world")
    state.to_host()
    notifier = worker_mod.get_notifier()
    topology.shutdown(abort=True)
    collectives.forget_inflight_names()

    if notifier is not None:
        timeout = C._env_float(C.HOROVOD_ELASTIC_TIMEOUT,
                               C.DEFAULT_ELASTIC_TIMEOUT_SECONDS)
        new_round = notifier.wait_for_new_round(timeout)
        assignment = notifier.fetch_assignment(new_round)
        if assignment is None:
            from horovod_tpu_torch.common.hvd_logging import get_logger
            get_logger().info(
                "elastic: this slot is not part of round %d; exiting",
                new_round)
            worker_mod.stop_notifier()
            sys.exit(0)
        for env_key, asg_key in [
                (C.HOROVOD_RANK, "rank"), (C.HOROVOD_SIZE, "size"),
                (C.HOROVOD_LOCAL_RANK, "local_rank"),
                (C.HOROVOD_LOCAL_SIZE, "local_size"),
                (C.HOROVOD_CROSS_RANK, "cross_rank"),
                (C.HOROVOD_CROSS_SIZE, "cross_size")]:
            os.environ[env_key] = str(assignment[asg_key])
        if assignment.get("coord"):
            os.environ[C.HOROVOD_COORDINATOR_ADDR] = assignment["coord"]
        os.environ[C.HOROVOD_ELASTIC_ROUND] = str(new_round)
        notifier.advance(new_round)
        flight.set_round(new_round, assignment["rank"])
        # Ranks are reassigned across rounds and the next KV push keys by
        # the NEW (rank, round): drop the old round's perfscope window.
        from horovod_tpu_torch.profiler import perfscope
        perfscope.get().reset()
        flight.record("elastic",
                      f"adopted round {new_round}: rank="
                      f"{assignment['rank']} size={assignment['size']}")

    topology.reinit()
    flight.record("elastic", "re-initialized after reset")


def run(func: Callable) -> Callable:
    """Elastic retry decorator (reference: common/elastic.py run_fn):

    HorovodInternalError  -> restore the last commit, reset, retry;
    HostsUpdatedInterrupt -> reset, sync from rank 0, continue.
    """

    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        worker_mod.maybe_init_notifier()
        skip_sync = False
        while True:
            if not skip_sync:
                state.sync()
            try:
                result = func(state, *args, **kwargs)
                worker_mod.stop_notifier()
                return result
            except HorovodInternalError as e:
                # Dump before recovery tears the evidence down, unless
                # the raising site (the stall watchdog) just dumped with
                # its own trigger.
                from horovod_tpu_torch.observability import flight
                flight.record("elastic", f"HorovodInternalError; "
                              f"restoring last commit: {e}")
                flight.dump_if_stale("internal_error")
                state.restore()
                skip_sync = False
            except HostsUpdatedInterrupt as e:
                from horovod_tpu_torch.observability import flight
                flight.record("elastic", "HostsUpdatedInterrupt: host "
                              "set changed; resetting")
                skip_sync = bool(getattr(e, "skip_sync", False))
            _reset(state)
            state.on_reset()

    return wrapper
