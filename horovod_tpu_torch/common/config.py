"""Environment knobs read by the PyTorch package.

A copy of the part of horovod_tpu/common/config.py that the port reads:
the fusion threshold, the bucket cap and order, elastic mode and its
collective timeout, the collectives' modes
(hierarchical allreduce and allgather, the two-level split of
HOROVOD_TPU_MESH_SHAPE, Adasum's vector halving, dynamic process sets),
the three online tuners (HOROVOD_AUTOTUNE*, HOROVOD_BUCKET_AUTOTUNE*,
HOROVOD_LAYOUT_AUTOTUNE*; core/autotune.py), the timeline and the
profilers' knobs (profiler/), the observability and control-plane
knobs (metrics, the stall watchdog, the consistency check, the
fingerprint verifier, the native KV server the launcher starts),
and every knob the launcher writes (`runner/launch.py args_to_env`) or
reads to place and join the workers (rank, size, local and cross
topology, rendezvous, controller, the MPI rank indirection). The knob
names and defaults are the JAX package's.
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
# The step-phase profiler (profiler/perfscope.py): on unless "0", the
# size of its rolling window, and how often a rank pushes its summary to
# the rendezvous KV; the launcher persists the pushed summaries into
# HOROVOD_FLIGHT_DIR at the job's end.
HOROVOD_PERFSCOPE = "HOROVOD_PERFSCOPE"
HOROVOD_PERFSCOPE_WINDOW = "HOROVOD_PERFSCOPE_WINDOW"
HOROVOD_METRICS_PUSH_INTERVAL = "HOROVOD_METRICS_PUSH_INTERVAL"
HOROVOD_FLIGHT_DIR = "HOROVOD_FLIGHT_DIR"
# Model FLOPs (profiler/flops.py): the card's peak and memory, and the
# gate of the counted FLOPs.
HOROVOD_BENCH_PEAK_TFLOPS = "HOROVOD_BENCH_PEAK_TFLOPS"
HOROVOD_BENCH_HBM_GB = "HOROVOD_BENCH_HBM_GB"
HOROVOD_PERFSCOPE_XLA_FLOPS = "HOROVOD_PERFSCOPE_XLA_FLOPS"
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
HOROVOD_DYNAMIC_PROCESS_SETS = "HOROVOD_DYNAMIC_PROCESS_SETS"
HOROVOD_ADASUM_HALVING = "HOROVOD_ADASUM_HALVING"
HOROVOD_BUCKET_AUTOTUNE = "HOROVOD_BUCKET_AUTOTUNE"
HOROVOD_BUCKET_AUTOTUNE_INTERVAL = "HOROVOD_BUCKET_AUTOTUNE_INTERVAL"
HOROVOD_BUCKET_AUTOTUNE_MAX_ADJUSTMENTS = \
    "HOROVOD_BUCKET_AUTOTUNE_MAX_ADJUSTMENTS"
# Online arbitration between the lane-padded and as-declared model
# layouts (ops/layout.py, core/autotune.OnlineLayoutTuner).
HOROVOD_LAYOUT_AUTOTUNE = "HOROVOD_LAYOUT_AUTOTUNE"
HOROVOD_LAYOUT_AUTOTUNE_INTERVAL = "HOROVOD_LAYOUT_AUTOTUNE_INTERVAL"
# The two-level split as "dcn:A,ici:B" or "AxB": dcn is the cross level,
# ici the local one (core/topology.py).
HOROVOD_TPU_MESH_SHAPE = "HOROVOD_TPU_MESH_SHAPE"
# The named-axis mesh ("dp=2,sp=2"; parallel/mesh.py); empty = pure dp.
HOROVOD_MESH = "HOROVOD_MESH"
# Observability (observability/): the metrics registry (on unless "0"),
# its JSON dump, and its label bound.
HOROVOD_METRICS = "HOROVOD_METRICS"
HOROVOD_METRICS_DUMP = "HOROVOD_METRICS_DUMP"
HOROVOD_METRICS_DUMP_INTERVAL = "HOROVOD_METRICS_DUMP_INTERVAL"
HOROVOD_METRICS_LABEL_MAX = "HOROVOD_METRICS_LABEL_MAX"
# Cross-rank call agreement (core/consistency.py) and the rolling
# fingerprint verifier (analysis/verifier.py).
HOROVOD_CONSISTENCY_CHECK = "HOROVOD_CONSISTENCY_CHECK"
HOROVOD_CONSISTENCY_TIMEOUT = "HOROVOD_CONSISTENCY_TIMEOUT"
HOROVOD_CHECK_COLLECTIVES = "HOROVOD_CHECK_COLLECTIVES"
HOROVOD_CHECK_COLLECTIVES_INTERVAL = "HOROVOD_CHECK_COLLECTIVES_INTERVAL"
HOROVOD_CHECK_COLLECTIVES_WINDOW = "HOROVOD_CHECK_COLLECTIVES_WINDOW"
HOROVOD_CHECK_COLLECTIVES_TIMEOUT = "HOROVOD_CHECK_COLLECTIVES_TIMEOUT"
# The native KV/coordination server the launcher starts (native/).
HOROVOD_NATIVE_KV_ADDR = "HOROVOD_NATIVE_KV_ADDR"
HOROVOD_NATIVE_KV_PORT = "HOROVOD_NATIVE_KV_PORT"

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
# Elastic mode (elastic/): set by the elastic launcher for its workers;
# the seconds a reset waits for the driver's next round.
HOROVOD_ELASTIC = "HOROVOD_ELASTIC"
HOROVOD_ELASTIC_TIMEOUT = "HOROVOD_ELASTIC_TIMEOUT"

DEFAULT_FUSION_THRESHOLD_BYTES = 4 * 1024 * 1024
DEFAULT_BUCKET_CAP_BYTES = 4 * 1024 * 1024
DEFAULT_CACHE_CAPACITY = 1024
DEFAULT_ELASTIC_TIMEOUT_SECONDS = 600.0
DEFAULT_STALL_WARNING_SECONDS = 60.0
# In elastic mode a collective that has not completed after this many
# seconds raises (the process group's timeout) where
# HOROVOD_STALL_SHUTDOWN_TIME_SECONDS does not set it: a dead peer under
# NCCL hangs rather than fails (core/topology.py).
DEFAULT_ELASTIC_COLLECTIVE_TIMEOUT_SECONDS = 60.0


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_on(name: str, default: bool) -> bool:
    """Like _env_bool, but an empty or blank value also keeps the
    default: the convention of the always-on gates (HOROVOD_PERFSCOPE),
    where `VAR=` in a wrapper script must not switch the subsystem off."""
    v = os.environ.get(name)
    if v is None or not v.strip():
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
    common/hvd_logging.py reads."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    bucket_cap_bytes: int = DEFAULT_BUCKET_CAP_BYTES
    bucket_reverse: bool = True
    cycle_time_ms: float = 0.0
    cache_capacity: int = DEFAULT_CACHE_CAPACITY
    adasum_halving: bool = False
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    dynamic_process_sets: bool = False
    mesh_shape: str = ""
    mesh_spec: str = ""
    # The online tuners (core/autotune.py): the GP search, and the
    # per-bucket tuner, which the JAX package runs on its bucket pipeline.
    autotune: bool = False
    autotune_log: str = ""
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    autotune_bayes_opt_max_samples: int = 20
    autotune_gaussian_process_noise: float = 0.8
    bucket_autotune: bool = False
    bucket_autotune_interval: int = 20
    bucket_autotune_max_adjustments: int = 4
    # Per-model layout arbitration: padded against as-declared by
    # measured step time; rank 0 decides and broadcasts.
    layout_autotune: bool = False
    layout_autotune_interval: int = 20
    # The Chrome-trace timeline that init() starts on rank 0.
    timeline_path: str = ""
    timeline_mark_cycles: bool = False
    # Elastic mode, and the stall bound that becomes the process group's
    # timeout there (0: DEFAULT_ELASTIC_COLLECTIVE_TIMEOUT_SECONDS).
    elastic: bool = False
    stall_shutdown_seconds: float = 0.0
    # The stall inspector and the collective watchdog (ops/collectives.py).
    stall_check_disable: bool = False
    stall_warning_seconds: float = DEFAULT_STALL_WARNING_SECONDS
    # Observability (observability/metrics.py, export.py).
    metrics_enabled: bool = True
    metrics_dump: str = ""
    metrics_dump_interval: float = 30.0
    metrics_push_interval: float = 5.0
    # Call agreement: on by default where the launcher started the native
    # KV server (a launched job); the checker turns itself off at size 1.
    consistency_check: bool = False
    check_collectives: bool = False
    check_collectives_interval: int = 10
    check_collectives_window: int = 512
    check_collectives_timeout: float = 5.0

    # Topology (launcher-injected); None where the env does not say.
    rank: Optional[int] = None
    size: Optional[int] = None
    local_rank: Optional[int] = None
    local_size: Optional[int] = None
    cross_rank: Optional[int] = None
    cross_size: Optional[int] = None
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
            adasum_halving=_env_bool(HOROVOD_ADASUM_HALVING),
            hierarchical_allreduce=_env_bool(HOROVOD_HIERARCHICAL_ALLREDUCE),
            hierarchical_allgather=_env_bool(HOROVOD_HIERARCHICAL_ALLGATHER),
            dynamic_process_sets=_env_bool(HOROVOD_DYNAMIC_PROCESS_SETS),
            mesh_shape=os.environ.get(HOROVOD_TPU_MESH_SHAPE, ""),
            mesh_spec=os.environ.get(HOROVOD_MESH, "").strip(),
            autotune=_env_bool(HOROVOD_AUTOTUNE),
            autotune_log=os.environ.get(HOROVOD_AUTOTUNE_LOG, ""),
            autotune_warmup_samples=_env_int(
                HOROVOD_AUTOTUNE_WARMUP_SAMPLES, 3),
            autotune_steps_per_sample=_env_int(
                HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE, 10),
            autotune_bayes_opt_max_samples=_env_int(
                HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES, 20),
            autotune_gaussian_process_noise=_env_float(
                HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE, 0.8),
            bucket_autotune=_env_bool(HOROVOD_BUCKET_AUTOTUNE),
            bucket_autotune_interval=_env_int(
                HOROVOD_BUCKET_AUTOTUNE_INTERVAL, 20),
            bucket_autotune_max_adjustments=_env_int(
                HOROVOD_BUCKET_AUTOTUNE_MAX_ADJUSTMENTS, 4),
            layout_autotune=_env_bool(HOROVOD_LAYOUT_AUTOTUNE),
            layout_autotune_interval=_env_int(
                HOROVOD_LAYOUT_AUTOTUNE_INTERVAL, 20),
            timeline_path=os.environ.get(HOROVOD_TIMELINE, ""),
            timeline_mark_cycles=_env_bool(HOROVOD_TIMELINE_MARK_CYCLES),
            elastic=_env_bool(HOROVOD_ELASTIC),
            stall_shutdown_seconds=_env_float(
                HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, 0.0),
            stall_check_disable=_env_bool(HOROVOD_STALL_CHECK_DISABLE),
            stall_warning_seconds=_env_float(
                HOROVOD_STALL_CHECK_TIME_SECONDS,
                DEFAULT_STALL_WARNING_SECONDS),
            metrics_enabled=_env_bool(HOROVOD_METRICS, True),
            metrics_dump=os.environ.get(HOROVOD_METRICS_DUMP, ""),
            metrics_dump_interval=_env_float(
                HOROVOD_METRICS_DUMP_INTERVAL, 30.0),
            metrics_push_interval=_env_float(
                HOROVOD_METRICS_PUSH_INTERVAL, 5.0),
            consistency_check=_env_bool(
                HOROVOD_CONSISTENCY_CHECK,
                default=bool(os.environ.get(HOROVOD_NATIVE_KV_ADDR))),
            check_collectives=_env_bool(HOROVOD_CHECK_COLLECTIVES),
            check_collectives_interval=_env_int(
                HOROVOD_CHECK_COLLECTIVES_INTERVAL, 10),
            check_collectives_window=_env_int(
                HOROVOD_CHECK_COLLECTIVES_WINDOW, 512),
            check_collectives_timeout=_env_float(
                HOROVOD_CHECK_COLLECTIVES_TIMEOUT, 5.0),
            rank=_env_or_mpi(HOROVOD_RANK, HOROVOD_MPI_RANK_ENV),
            size=_opt_int(HOROVOD_SIZE),
            local_rank=_env_or_mpi(HOROVOD_LOCAL_RANK,
                                   HOROVOD_MPI_LOCAL_RANK_ENV),
            local_size=_opt_int(HOROVOD_LOCAL_SIZE),
            cross_rank=_opt_int(HOROVOD_CROSS_RANK),
            cross_size=_opt_int(HOROVOD_CROSS_SIZE),
            rendezvous_addr=os.environ.get(HOROVOD_RENDEZVOUS_ADDR, ""),
            rendezvous_port=_env_int(HOROVOD_RENDEZVOUS_PORT, 0),
            coordinator_addr=os.environ.get(
                HOROVOD_COORDINATOR_ADDR, "").strip(),
        )
