"""`horovod.torch` surface (counterpart of horovod_tpu/frontends/torch.py).

The port's top-level package IS the torch frontend; this module
re-exports its Horovod API so that `import
horovod_tpu_torch.frontends.torch as hvd` reads as the JAX package's
`import horovod_tpu.frontends.torch as hvd` does.
"""

from horovod_tpu_torch import (  # noqa: F401
    Adasum, Average, Compression, DistributedOptimizer, Max, Min,
    ProcessSet, Product, Sum, add_process_set, allgather, allgather_async,
    allgather_object, allreduce, allreduce_, allreduce_async,
    allreduce_async_, alltoall, alltoall_async, barrier, broadcast,
    broadcast_, broadcast_async, broadcast_async_, broadcast_object,
    broadcast_optimizer_state, broadcast_parameters, ccl_built, cross_rank,
    cross_size, cuda_built, ddl_built, device, global_process_set,
    gloo_built, gloo_enabled, grouped_allgather, grouped_allgather_async,
    grouped_allreduce, grouped_allreduce_, grouped_allreduce_async,
    grouped_allreduce_async_, grouped_reducescatter,
    grouped_reducescatter_async, init, is_homogeneous, is_initialized,
    join, local_rank, local_size, mpi_built, mpi_enabled,
    mpi_threads_supported, nccl_built, poll, rank, reducescatter,
    reducescatter_async, remove_process_set, rocm_built, shutdown, size,
    sparse_allreduce_async, synchronize, tpu_built,
)
from horovod_tpu_torch.frontends import torch_elastic as elastic  # noqa: F401,E402
