"""The JAX package's reduction rule for the frontend tests of the port
(tests/test_torch_tf_frontend.py, test_torch_mxnet_frontend.py):
`op_reference(stacked, name)` runs horovod_tpu/ops/collectives.py
`_apply_reduce` (Sum, Average, Min, Max, Product) or
horovod_tpu/ops/adasum.py `adasum_reduce_block` (Adasum, no halving, the
default of both packages) under shard_map over one CPU device per row
of `stacked`, in f32, and returns rank 0's result."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.common import types as JT
from horovod_tpu.ops import adasum as jadasum
from horovod_tpu.ops import collectives as jcoll


def op_reference(stacked: np.ndarray, name: str) -> np.ndarray:
    k = stacked.shape[0]
    op = JT.ReduceOp[name.upper()]
    if op == JT.ReduceOp.ADASUM:
        def body(b):
            return jadasum.adasum_reduce_block(b, "hvd", k, halving=False)
    else:
        def body(b):
            return jcoll._apply_reduce(b, op, k, 1.0, 1.0)
    with jax.enable_x64(False):
        mesh = Mesh(np.array(jax.devices()[:k]), ("hvd",))
        fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("hvd"),
                                   out_specs=P("hvd"), check_vma=False))
        y = np.asarray(fn(jnp.asarray(stacked, jnp.float32)))
    return y[0]
