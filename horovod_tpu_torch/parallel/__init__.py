"""Parallelism over the named-axis mesh (counterpart of
horovod_tpu/parallel/): the HOROVOD_MESH mesh, the named-axis
collectives, sequence parallelism by ring and Ulysses attention, the
GPipe pipeline and the top-1 MoE FFN."""

from horovod_tpu_torch.parallel.comm import (  # noqa: F401
    all_to_all_4d, pmax, psum, ring_shift,
)
from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER, MeshSpec, axis_index, axes_process_set,
    build_mesh, current_mesh, mesh_axis_sizes, shard_of, spec_from_env,
    use_mesh,
)
from horovod_tpu_torch.parallel.moe import moe_ffn  # noqa: F401
from horovod_tpu_torch.parallel.pipeline import pipeline_apply  # noqa: F401
from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention, blockwise_attention_reference,
)
from horovod_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
