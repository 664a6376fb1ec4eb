"""Parallelism over the named-axis mesh (counterpart of
horovod_tpu/parallel/): the HOROVOD_MESH mesh and sequence parallelism
by ring and Ulysses attention. The pipeline and the MoE FFN are ROADMAP
A11 part 2."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER, MeshSpec, build_mesh, mesh_axis_sizes, spec_from_env,
)
from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention, blockwise_attention_reference,
)
from horovod_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
