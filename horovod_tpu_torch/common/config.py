"""Environment knobs read by the PyTorch package.

A copy of the part of horovod_tpu/common/config.py that the port reads:
the fusion threshold, the bucket cap and order, and every knob the
launcher writes (`runner/launch.py args_to_env`) or reads to place and
join the workers (rank, size, local and cross topology, rendezvous,
controller, the MPI rank indirection). The knob names and defaults are
the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_CYCLE_TIME = "HOROVOD_CYCLE_TIME"
HOROVOD_CACHE_CAPACITY = "HOROVOD_CACHE_CAPACITY"
HOROVOD_HIERARCHICAL_ALLREDUCE = "HOROVOD_HIERARCHICAL_ALLREDUCE"
HOROVOD_HIERARCHICAL_ALLGATHER = "HOROVOD_HIERARCHICAL_ALLGATHER"
HOROVOD_TIMELINE = "HOROVOD_TIMELINE"
HOROVOD_TIMELINE_MARK_CYCLES = "HOROVOD_TIMELINE_MARK_CYCLES"
HOROVOD_AUTOTUNE = "HOROVOD_AUTOTUNE"
HOROVOD_AUTOTUNE_LOG = "HOROVOD_AUTOTUNE_LOG"
HOROVOD_AUTOTUNE_WARMUP_SAMPLES = "HOROVOD_AUTOTUNE_WARMUP_SAMPLES"
HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE = "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"
HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES = "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"
HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE = "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_STALL_CHECK_TIME_SECONDS = "HOROVOD_STALL_CHECK_TIME_SECONDS"
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS = "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"
HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"
HOROVOD_LOG_HIDE_TIME = "HOROVOD_LOG_HIDE_TIME"
HOROVOD_BUCKET_CAP = "HOROVOD_BUCKET_CAP"
HOROVOD_BUCKET_REVERSE = "HOROVOD_BUCKET_REVERSE"

# Launcher-injected topology and rendezvous (runner/launch.py).
HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_SIZE = "HOROVOD_SIZE"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_CROSS_RANK = "HOROVOD_CROSS_RANK"
HOROVOD_CROSS_SIZE = "HOROVOD_CROSS_SIZE"
HOROVOD_CONTROLLER = "HOROVOD_CONTROLLER"
HOROVOD_RENDEZVOUS_ADDR = "HOROVOD_GLOO_RENDEZVOUS_ADDR"
HOROVOD_RENDEZVOUS_PORT = "HOROVOD_GLOO_RENDEZVOUS_PORT"
HOROVOD_COORDINATOR_ADDR = "HOROVOD_COORDINATOR_ADDR"
# mpirun/jsrun-placed workers: the name of the placer's own rank env var
# (runner/mpi_run.py exports it), read when HOROVOD_RANK is absent.
HOROVOD_MPI_RANK_ENV = "HOROVOD_MPI_RANK_ENV"
HOROVOD_MPI_LOCAL_RANK_ENV = "HOROVOD_MPI_LOCAL_RANK_ENV"
HOROVOD_ELASTIC_ROUND = "HOROVOD_ELASTIC_ROUND"

DEFAULT_FUSION_THRESHOLD_BYTES = 4 * 1024 * 1024
DEFAULT_BUCKET_CAP_BYTES = 4 * 1024 * 1024
DEFAULT_CACHE_CAPACITY = 1024


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        return int(v)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        return float(v)
    except ValueError:
        return default


def _opt_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _env_or_mpi(primary: str, indirect: str) -> Optional[int]:
    """HOROVOD_<primary>, or else the MPI flavour's own variable whose
    name HOROVOD_MPI_*_ENV holds."""
    r = _opt_int(primary)
    if r is not None:
        return r
    alt = os.environ.get(indirect, "")
    return _opt_int(alt) if alt else None


@dataclasses.dataclass
class Config:
    """Snapshot of the knobs the port reads, taken at init(). Of the
    others above, the launcher writes the log knobs, which
    common/hvd_logging.py reads, and the knobs of subsystems not ported
    yet, whose flags it refuses."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    bucket_cap_bytes: int = DEFAULT_BUCKET_CAP_BYTES
    bucket_reverse: bool = True
    cycle_time_ms: float = 0.0
    cache_capacity: int = DEFAULT_CACHE_CAPACITY

    # Topology (launcher-injected); None where the env does not say.
    rank: Optional[int] = None
    size: Optional[int] = None
    local_rank: Optional[int] = None
    local_size: Optional[int] = None
    rendezvous_addr: str = ""
    rendezvous_port: int = 0
    coordinator_addr: str = ""

    @staticmethod
    def from_env() -> "Config":
        return Config(
            fusion_threshold_bytes=_env_int(
                HOROVOD_FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES),
            bucket_cap_bytes=_env_int(
                HOROVOD_BUCKET_CAP, DEFAULT_BUCKET_CAP_BYTES),
            bucket_reverse=_env_bool(HOROVOD_BUCKET_REVERSE, True),
            cycle_time_ms=_env_float(HOROVOD_CYCLE_TIME, 0.0),
            cache_capacity=_env_int(HOROVOD_CACHE_CAPACITY,
                                    DEFAULT_CACHE_CAPACITY),
            rank=_env_or_mpi(HOROVOD_RANK, HOROVOD_MPI_RANK_ENV),
            size=_opt_int(HOROVOD_SIZE),
            local_rank=_env_or_mpi(HOROVOD_LOCAL_RANK,
                                   HOROVOD_MPI_LOCAL_RANK_ENV),
            local_size=_opt_int(HOROVOD_LOCAL_SIZE),
            rendezvous_addr=os.environ.get(HOROVOD_RENDEZVOUS_ADDR, ""),
            rendezvous_port=_env_int(HOROVOD_RENDEZVOUS_PORT, 0),
            coordinator_addr=os.environ.get(
                HOROVOD_COORDINATOR_ADDR, "").strip(),
        )
