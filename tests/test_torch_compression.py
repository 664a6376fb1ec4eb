"""Gradient compression in the PyTorch package's DistributedOptimizer
against the JAX package: fault C6 (ROADMAP §C) and the per-tensor wire
dtype the bucket planner keys on.

C6: the hook path compressed each packed bucket, so the 1 MiB threshold
of Compression.bf16_large was tested against a bucket's bytes and small
gradients packed beside a large one were rounded to bf16. The reference
(horovod_tpu/optim/optimizer.py `_allreduce_grads`) compresses every
gradient on its own before any bucketing. The ROADMAP input: four f32
gradients of 100,000 values (400 KB each) and one of 524,288 (2 MiB),
seed 0, the same on both ranks of a spawned gloo world of 2
(tests/torch_optimizer_worker.py run_c6; one 90 s deadline,
tests/torch_world_worker.py). Against `_allreduce_grads` of the same
gradients on the JAX package's CPU world, bit for bit: the four small
ones come back as they went, the 2 MiB one bf16-rounded, and no bucket
mixes the two wire dtypes. (An average of two equal values is exact in
f32 and in bf16, so any difference is the compression's.)
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_collectives_worker as CW
import torch_optimizer_worker as W
from horovod_tpu.ops.compression import Compression as JCompression
from horovod_tpu.optim.optimizer import DistributedOptimizer as JOpt
from horovod_tpu_torch.ops.compression import Compression, wire_dtype

SIZES = [100_000] * 4 + [524_288]


def _grads():
    rng = np.random.default_rng(0)
    return {f"g{i}": rng.standard_normal(n).astype(np.float32)
            for i, n in enumerate(SIZES)}


@pytest.fixture(scope="module")
def c6(tmp_path_factory):
    import horovod_tpu as jhvd
    grads = _grads()
    res = CW.spawn(W.run_c6, tmp_path_factory.mktemp("c6"), grads, k=2,
                   timeout=90)
    was = jhvd.is_initialized()
    if not was:
        jhvd.init()
    try:
        opt = JOpt(optax.sgd(0.0), compression=JCompression.bf16_large)
        want = opt._allreduce_grads({k: jnp.asarray(v)
                                     for k, v in grads.items()})
        want = {k: np.asarray(v) for k, v in want.items()}
    finally:
        if not was:
            jhvd.shutdown()
    return res, want, grads


@pytest.mark.parametrize("i", range(len(SIZES)))
def test_c6_hook_path_matches_jax_bit_for_bit(c6, i):
    res, want, grads = c6
    assert want[f"g{i}"].dtype == np.float32
    for r in res:
        np.testing.assert_array_equal(r[f"reduced{i}"], want[f"g{i}"])
    rounded = np.asarray(jnp.asarray(grads[f"g{i}"], jnp.bfloat16),
                         np.float32)
    if SIZES[i] * 4 >= 1 << 20:  # compressed: bf16-rounded
        np.testing.assert_array_equal(want[f"g{i}"], rounded)
    else:  # under the threshold: untouched
        np.testing.assert_array_equal(want[f"g{i}"], grads[f"g{i}"])
        assert not np.array_equal(rounded, grads[f"g{i}"])


def test_c6_no_bucket_mixes_wire_dtypes(c6):
    res, _, _ = c6
    r = res[0]
    wire = [str(r[f"wire{i}"]) for i in range(len(SIZES))]
    assert wire == ["torch.float32"] * 4 + ["torch.bfloat16"]
    buckets = sorted(k[:-len("/dtype")] for k in r if k.endswith("/dtype"))
    assert len(buckets) == 2
    for b in buckets:
        dtype = str(r[f"{b}/dtype"])
        assert {wire[i] for i in r[f"{b}/members"]} == {f"torch.{dtype}"}


CASES = [(Compression.none, torch.float32, 10, torch.float32),
         (Compression.fp16, torch.float32, 10, torch.float16),
         (Compression.fp16, torch.int32, 10, torch.int32),
         (Compression.bf16, torch.float32, 10, torch.bfloat16),
         (Compression.bf16, torch.bfloat16, 10, torch.bfloat16),
         (Compression.bf16_large, torch.float32, 262_143, torch.float32),
         (Compression.bf16_large, torch.float32, 262_144, torch.bfloat16),
         (Compression.bf16_large, torch.bfloat16, 524_288, torch.bfloat16),
         (Compression.thresholded(Compression.fp16, 64), torch.float32, 15,
          torch.float32),
         (Compression.thresholded(Compression.fp16, 64), torch.float32, 16,
          torch.float16)]


@pytest.mark.parametrize("comp,dtype,numel,want", CASES)
def test_wire_dtype_is_what_compress_sends(comp, dtype, numel, want):
    """The planner's dtype for a tensor of `numel` elements is the dtype
    its own compress() sends, here and in the JAX package."""
    assert wire_dtype(comp, dtype, numel) == want
    t = torch.zeros(numel, dtype=dtype)
    assert comp.compress(t)[0].dtype == want
    jcomp = {Compression.none: JCompression.none,
             Compression.fp16: JCompression.fp16,
             Compression.bf16: JCompression.bf16,
             Compression.bf16_large: JCompression.bf16_large}.get(
        comp, JCompression.thresholded(JCompression.fp16, 64))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.int32: jnp.int32}[dtype]
    got = jcomp.compress(jnp.zeros(numel, jdt))[0].dtype
    assert str(got) == str(want).replace("torch.", "")
