"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

Data-parallel training on NVIDIA GPUs with Horovod's API: `hvd.init()`
joins one process per GPU into a torch.distributed world (NCCL; gloo
with `init(device="cpu")`), `hvd.broadcast_parameters` syncs the start,
and `hvd.DistributedOptimizer` all-reduces the gradients in buckets
launched during the backward pass. The ResNet's fused 1x1-conv +
BatchNorm (+ReLU) sites run hand-written CUDA kernels built from
`csrc/` at first use. The package imports neither JAX nor horovod_tpu.
"""

from horovod_tpu_torch.common.types import Average, ReduceOp, Sum  # noqa: F401
from horovod_tpu_torch.common.exceptions import (  # noqa: F401
    HorovodError, HorovodInternalError, KernelError,
)
from horovod_tpu_torch.core.topology import (  # noqa: F401
    device, init, is_initialized, local_rank, local_size, rank, shutdown,
    size,
)
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    Handle, allreduce, allreduce_async, barrier, broadcast,
    bucketed_allreduce, grouped_allreduce, poll, synchronize,
)
from horovod_tpu_torch.ops.compression import Compression  # noqa: F401
from horovod_tpu_torch.optim.optimizer import (  # noqa: F401
    DistributedOptimizer,
)
from horovod_tpu_torch.optim.functions import (  # noqa: F401
    broadcast_optimizer_state, broadcast_parameters,
)

__version__ = "0.1.0"
