"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

Data-parallel training on NVIDIA GPUs with Horovod's API: the launcher
(`python -m horovod_tpu_torch.runner.launch -np N ...`, or
`horovod_tpu_torch.runner.run(fn, np=N)`) starts one process per GPU,
`hvd.init()` joins them into a torch.distributed world (NCCL; gloo
with `init(device="cpu")`), with process sets and the local/cross split
for the eager collectives (allreduce with Average, Sum, Min, Max,
Product and Adasum, allgather, reducescatter, alltoall, broadcast),
`hvd.broadcast_parameters` syncs the start,
and `hvd.DistributedOptimizer` all-reduces the gradients in buckets
launched during the backward pass (or at the step: groups, Adasum,
sparse gradients), fed to the online tuners of the fusion threshold
under HOROVOD_AUTOTUNE or HOROVOD_BUCKET_AUTOTUNE. `hvd.join`,
`broadcast_object`, `allgather_object` and the training callbacks
(`horovod_tpu_torch.optim.callbacks`) complete the training API. The
ResNet's fused 1x1-conv + BatchNorm (+ReLU) sites run hand-written CUDA
kernels built from `csrc/` at first use. Every step is split into
phases by `hvd.perfscope()` (profiler/perfscope.py), every collective
is a span on the Chrome-trace timeline (HOROVOD_TIMELINE, or
`hvd.start_timeline`), `horovod_tpu_torch.data.DeviceFeed` stages
batches onto the card ahead of the step, and
`horovod_tpu_torch.profiler.device_profile` reads the device's time by
kernel category. `hvd.elastic` is elastic training (`@hvd.elastic.run`
over a `TrainLoopState`; the launcher's --host-discovery-script mode),
and `horovod_tpu_torch.ckpt` the async two-phase checkpointer with
exactly-once resume. Under HOROVOD_MESH ("dp=2,sp=2") init lays the
ranks on named axes (`hvd.mesh_spec()`, `hvd.hybrid_mesh()`,
`hvd.axis_process_set`), over which the transformer LM runs ring or
Ulysses attention, tensor, pipeline and expert parallelism
(`horovod_tpu_torch.parallel`), and `DistributedOptimizer(
sharding_spec=...)` reduces each shard's gradient over the axes it is
replicated on. The in-place forms
(`allreduce_`, `grouped_allreduce_`, `broadcast_` and their `_async_`
forms) write into the caller's tensors; `grouped_allgather_async` and
`grouped_reducescatter_async` give one handle for a group; the build
queries (`nccl_built()`, `cuda_built()`, ...) answer from torch's own
build; `hvd.SyncBatchNorm` is the count-weighted cross-rank BN of the
JAX package (its conventions, not `torch.nn.SyncBatchNorm`'s). The
synthetic benchmark trains ResNet-50/101/152, VGG-16/19 and Inception
V3 (`horovod_tpu_torch.models`, with the MLP). The runtime control
plane and observability are the JAX package's: `hvd.metrics()` and
`metrics_text()` read the process's metrics registry, which the
launcher's rendezvous server serves job-wide at `GET /metrics`; every
rank keeps a flight recorder (dumped into HOROVOD_FLIGHT_DIR on a
stall, a divergence, SIGUSR1 and exit) and a span per training step;
the stall watchdog bounds every collective wait under
--stall-check-shutdown-time-seconds; a launched job checks that its
ranks call the same collectives (CollectiveMismatchError,
VersionMismatchError) and, under HOROVOD_CHECK_COLLECTIVES, their
rolling fingerprints (CollectiveDivergenceError); and
HOROVOD_KV_REPLICAS > 1 replicates the rendezvous control plane. The
package imports neither JAX nor horovod_tpu.
"""

from horovod_tpu_torch.common.types import (  # noqa: F401
    Adasum, Average, Max, Min, Product, ReduceOp, Status, StatusType, Sum,
)
from horovod_tpu_torch.common.exceptions import (  # noqa: F401
    CheckpointCorruptError, CollectiveDivergenceError,
    CollectiveMismatchError, DuplicateNameError, HorovodError,
    HorovodInternalError, HostsUpdatedInterrupt, KernelError,
    TensorShapeMismatchError, VersionMismatchError,
)
from horovod_tpu_torch.core.topology import (  # noqa: F401
    ccl_built, cross_rank, cross_size, cuda_built, ddl_built, device,
    gloo_built, gloo_enabled, hybrid_mesh, init, is_homogeneous,
    is_initialized, local_rank, local_size, local_slot_ranks, mesh_spec,
    mpi_built, mpi_enabled, mpi_threads_supported, nccl_built, rank,
    rocm_built, shutdown, size, start_timeline, stop_timeline, tpu_built,
)
from horovod_tpu_torch.core.join import join, join_steps  # noqa: F401
from horovod_tpu_torch.core.process_sets import (  # noqa: F401
    ProcessSet, add_process_set, axis_process_set, get_process_set,
    global_process_set, remove_process_set,
)
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    Handle, allgather, allgather_async, allreduce, allreduce_,
    bucket_overlap_stats,
    allreduce_async, allreduce_async_, alltoall, alltoall_async, barrier,
    broadcast, broadcast_, broadcast_async, broadcast_async_,
    bucketed_allreduce, bucketed_allreduce_async, grouped_allgather,
    grouped_allgather_async, grouped_allreduce, grouped_allreduce_,
    grouped_allreduce_async, grouped_allreduce_async_,
    grouped_reducescatter, grouped_reducescatter_async, poll,
    reducescatter, reducescatter_async, sparse_allreduce,
    sparse_allreduce_async, synchronize,
)
from horovod_tpu_torch.ops.compression import Compression  # noqa: F401
from horovod_tpu_torch.ops.sync_batch_norm import (  # noqa: F401
    SyncBatchNorm, SyncBatchNormalization,
)
from horovod_tpu_torch.optim.optimizer import (  # noqa: F401
    DistributedOptimizer,
)
from horovod_tpu_torch.optim.functions import (  # noqa: F401
    allgather_object, broadcast_object, broadcast_optimizer_state,
    broadcast_parameters, broadcast_variables,
)

from horovod_tpu_torch import elastic  # noqa: F401,E402

__version__ = "0.1.0"


def metrics() -> dict:
    """This process's metrics registry as a plain-JSON snapshot
    (observability/metrics.py). Works before init(); after init() the
    snapshot carries this process's rank."""
    from horovod_tpu_torch.core import topology
    from horovod_tpu_torch.observability import metrics as m
    return m.registry().snapshot(topology.rank_or_none())


def metrics_text() -> str:
    """This process's metrics in Prometheus text exposition format: what
    the rendezvous server's `/metrics` route serves job-wide."""
    from horovod_tpu_torch.core import topology
    from horovod_tpu_torch.observability import metrics as m
    return m.registry().render(topology.rank_or_none())


def perfscope():
    """The process-wide step-phase profiler (profiler/perfscope.py):
    delimit steps with `with hvd.perfscope().step():` and mark host
    input waits with `.phase("input_wait")`; comms and optimizer time
    are attributed through `DistributedOptimizer`. A no-op shell under
    HOROVOD_PERFSCOPE=0."""
    from horovod_tpu_torch.profiler import perfscope as _ps
    return _ps.get()
