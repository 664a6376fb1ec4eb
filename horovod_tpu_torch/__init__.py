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
kernel category. The package imports neither JAX nor horovod_tpu.
"""

from horovod_tpu_torch.common.types import (  # noqa: F401
    Adasum, Average, Max, Min, Product, ReduceOp, Sum,
)
from horovod_tpu_torch.common.exceptions import (  # noqa: F401
    DuplicateNameError, HorovodError, HorovodInternalError, KernelError,
    TensorShapeMismatchError,
)
from horovod_tpu_torch.core.topology import (  # noqa: F401
    cross_rank, cross_size, device, init, is_homogeneous, is_initialized,
    local_rank, local_size, rank, shutdown, size, start_timeline,
    stop_timeline,
)
from horovod_tpu_torch.core.join import join, join_steps  # noqa: F401
from horovod_tpu_torch.core.process_sets import (  # noqa: F401
    ProcessSet, add_process_set, axis_process_set, get_process_set,
    global_process_set, remove_process_set,
)
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    Handle, allgather, allgather_async, allreduce, allreduce_async,
    alltoall, alltoall_async, barrier, broadcast, broadcast_async,
    bucketed_allreduce, bucketed_allreduce_async, grouped_allgather,
    grouped_allreduce, grouped_allreduce_async, grouped_reducescatter,
    poll, reducescatter, reducescatter_async, sparse_allreduce,
    sparse_allreduce_async, synchronize,
)
from horovod_tpu_torch.ops.compression import Compression  # noqa: F401
from horovod_tpu_torch.optim.optimizer import (  # noqa: F401
    DistributedOptimizer,
)
from horovod_tpu_torch.optim.functions import (  # noqa: F401
    allgather_object, broadcast_object, broadcast_optimizer_state,
    broadcast_parameters,
)

__version__ = "0.1.0"


def perfscope():
    """The process-wide step-phase profiler (profiler/perfscope.py):
    delimit steps with `with hvd.perfscope().step():` and mark host
    input waits with `.phase("input_wait")`; comms and optimizer time
    are attributed through `DistributedOptimizer`. A no-op shell under
    HOROVOD_PERFSCOPE=0."""
    from horovod_tpu_torch.profiler import perfscope as _ps
    return _ps.get()
