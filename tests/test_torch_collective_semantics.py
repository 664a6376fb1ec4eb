"""The eager collectives' integer Average and scale factors, over two
gloo ranks, bit for bit against the JAX package's reduce body.

Two spawned workers (tests/torch_collective_worker.py, a FileStore
under tmp_path) feed int32 [3, -4, -8] + rank through allreduce,
grouped_allreduce and bucketed_allreduce with the default Average, 4001
bf16 values in [0.1, 50] with prescale 1/3, and the int32 tensor with
postscale 2.5. The reference is horovod_tpu/ops/collectives.py
`_apply_reduce` on the same numpy inputs: an integer Average
floor-divides in the tensor's dtype, and each factor is cast to the
tensor's dtype before it multiplies (bf16 rounds 1/3 to bf16 first;
int32 truncates 2.5 to 2). Every result must equal the reference's bits.

For the integer cases the reference is `_apply_reduce` itself under
shard_map on a 2-device CPU mesh. For bf16 it is the same lines run op
by op in eager jnp, psum as the ranks' rows added in rank order: inside
one jitted program XLA's CPU backend keeps the product and the sum in
f32 and rounds once at the end (excess precision), which no rank of a
real world sees, since each rank rounds its scaled tensor to bf16
before it goes on the wire.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_collective_worker
from torch_world_worker import spawn_world
from horovod_tpu.common import types as JT
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu_torch.ops import collectives as tcoll

K = 2


def _reference(stacked: np.ndarray, dtype, prescale=1.0, postscale=1.0
               ) -> np.ndarray:
    """_apply_reduce (Average) over K ranks under shard_map; `stacked`
    holds one row per rank."""
    mesh = Mesh(np.array(jax.devices()[:K]), ("hvd",))
    body = jax.shard_map(
        lambda b: jcoll._apply_reduce(b, JT.ReduceOp.AVERAGE, K, prescale,
                                      postscale),
        mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd"))
    y = np.asarray(jax.jit(body)(jnp.asarray(stacked, dtype)))
    np.testing.assert_array_equal(y[0], y[1])
    return y[0]


def _reference_eager(stacked: np.ndarray, dtype, prescale=1.0,
                     postscale=1.0) -> np.ndarray:
    """_apply_reduce's Average lines (horovod_tpu/ops/collectives.py:
    505-533) op by op in eager jnp, each op rounding to `dtype`."""
    xs = [jnp.asarray(row, dtype) for row in stacked]
    if prescale != 1.0:
        xs = [x * jnp.asarray(prescale, dtype) for x in xs]
    y = xs[0]
    for x in xs[1:]:
        y = y + x
    if jnp.issubdtype(y.dtype, jnp.integer):
        y = y // jnp.asarray(K, y.dtype)
    else:
        y = y / jnp.asarray(K, y.dtype)
    if postscale != 1.0:
        y = y * jnp.asarray(postscale, y.dtype)
    return np.asarray(y)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _spawn(tmp_path, inputs):
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(K)]
    spawn_world(torch_collective_worker.run,
                [(r, K, store, inputs, outs[r]) for r in range(K)],
                tmp_path, deadline=120)
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ints = np.stack([np.array([3, -4, -8], np.int32) + r for r in range(K)])
    rng = np.random.default_rng(5)
    bf = rng.uniform(0.1, 50.0, (K, 4001)).astype(jnp.bfloat16)
    inputs = {"ints": ints, "bf16_bits": bf.view(np.uint16)}
    got = _spawn(tmp_path_factory.mktemp("coll"), inputs)
    want = {
        "ints": _reference(ints, jnp.int32),
        "bf16_prescale": _bits(_reference_eager(bf, jnp.bfloat16,
                                                prescale=1 / 3)),
        "int_postscale": _reference(ints, jnp.int32, postscale=2.5),
    }
    # The integer lines give the same result op by op as fused.
    np.testing.assert_array_equal(_reference_eager(ints, jnp.int32),
                                  want["ints"])
    np.testing.assert_array_equal(
        _reference_eager(ints, jnp.int32, postscale=2.5),
        want["int_postscale"])
    return got, want


@pytest.mark.parametrize("name", ["allreduce", "grouped", "bucketed"])
def test_integer_average_floors_in_its_dtype(results, name):
    got, want = results
    np.testing.assert_array_equal(want["ints"], [3, -4, -8])
    for r in range(K):
        assert got[r][name].dtype == np.int32, name
        np.testing.assert_array_equal(got[r][name], want["ints"])


@pytest.mark.parametrize("name", ["bf16_prescale", "bf16_prescale_grouped"])
def test_bf16_prescale_matches_jax_bit_for_bit(results, name):
    got, want = results
    for r in range(K):
        np.testing.assert_array_equal(got[r][name], want["bf16_prescale"])


@pytest.mark.parametrize("name", ["int_postscale", "int_postscale_bucketed"])
def test_int_postscale_truncates_factor_like_jax(results, name):
    got, want = results
    np.testing.assert_array_equal(want["int_postscale"], [6, -8, -16])
    for r in range(K):
        assert got[r][name].dtype == np.int32
        np.testing.assert_array_equal(got[r][name], want["int_postscale"])


def test_average_and_scale_helpers_keep_the_dtype():
    """The helpers the collectives and DistributedOptimizer share, on
    one process: floor division for integers, true division for floats,
    and factors cast to the tensor's dtype."""
    s = torch.tensor([7, -7, -15], dtype=torch.int32)
    y = tcoll.average(s, 2)
    assert y.dtype == torch.int32 and y.tolist() == [3, -4, -8]
    f = tcoll.average(torch.tensor([7.0, -7.0]), 2)
    assert f.tolist() == [3.5, -3.5]
    assert tcoll.scale(s, 2.5).tolist() == [14, -14, -30]
    x = torch.tensor([3.0], dtype=torch.bfloat16)
    third = torch.tensor(1 / 3, dtype=torch.bfloat16)
    assert tcoll.scale(x, 1 / 3).item() == (x * third).item()
