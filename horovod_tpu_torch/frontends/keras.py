"""`horovod.keras` surface of the port (counterpart of
horovod_tpu/frontends/keras.py): re-exports the TF frontend, whose
optimizer wrappers are Keras-3 native. Users migrating `import
horovod.keras as hvd` change one import; everything else
(DistributedOptimizer in `model.compile`, callbacks, load_model,
broadcast helpers) reads the same.
"""

from horovod_tpu_torch.frontends.tensorflow import (  # noqa: F401
    Adasum, Average, Compression, DistributedOptimizer,
    DistributedGradientTape, Max, Min, PartialDistributedGradientTape,
    PartialDistributedOptimizer, Product, ProcessSet, Sum,
    add_process_set, allgather, allgather_object, allreduce, barrier,
    broadcast, broadcast_, broadcast_global_variables, broadcast_object,
    broadcast_object_fn, broadcast_variables, callbacks, ccl_built,
    cross_rank, cross_size, cuda_built, ddl_built, gloo_built,
    gloo_enabled, global_process_set, grouped_allgather,
    grouped_allreduce, grouped_reducescatter, init, is_homogeneous,
    is_initialized, join, load_model, local_rank, local_size, mpi_built,
    mpi_enabled, mpi_threads_supported, nccl_built, rank,
    reducescatter, remove_process_set, rocm_built, shutdown, size,
    tpu_built,
)
