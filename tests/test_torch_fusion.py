"""The PyTorch package's bucket planner against the JAX package's.

Both planners get the same (shape, dtype) lists; the plans must be equal
item for item and carry the same signature. Exact equality: the planner
is integer arithmetic.
"""

import numpy as np
import pytest
import torch

from horovod_tpu.ops import fusion as jfusion
from horovod_tpu_torch.ops import fusion as tfusion

MB = 1 << 20

_DTYPES = ["float32", "bfloat16", "float16", "int32"]


def _metas(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        nd = int(rng.integers(0, 4))
        # a spread from scalars to multi-MB tensors
        shape = tuple(int(s) for s in rng.integers(1, 96, nd))
        if rng.random() < 0.15:
            shape = (int(rng.integers(1, 9)) * 262144 + int(rng.integers(7)),)
        out.append((shape, _DTYPES[int(rng.integers(len(_DTYPES)))]))
    return out


def _plain(plan):
    return [(b.dtype, b.itemsize, tuple((it.index, it.start, it.size)
                                        for it in b.items)) for b in plan]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("threshold", [1, MB, 4 * MB])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_matches_jax(seed, threshold, reverse):
    metas = _metas(seed, 40)
    pj = jfusion.plan_buckets(metas, threshold, reverse=reverse)
    pt = tfusion.plan_buckets(metas, threshold, reverse=reverse)
    assert _plain(pt) == _plain(pj)
    assert tfusion.plan_signature(pt) == jfusion.plan_signature(pj)


def test_plan_accepts_torch_dtypes():
    metas = _metas(5, 20)
    as_torch = [(s, getattr(torch, d)) for s, d in metas]
    assert _plain(tfusion.plan_buckets(as_torch, MB, reverse=True)) == \
        _plain(jfusion.plan_buckets(metas, MB, reverse=True))


@pytest.mark.parametrize("t,cap", [(MB, 4 * MB), (64 * MB, 4 * MB),
                                   (8 * MB, 0), (0, 4 * MB)])
def test_effective_threshold_matches_jax(t, cap):
    assert tfusion.effective_threshold(t, cap) == \
        jfusion.effective_threshold(t, cap)


def test_fused_reduce_reassembles_chunks():
    """An identity collective through the planner gives back every
    tensor, chunked tensors included."""
    rng = np.random.default_rng(0)
    ts = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
          for n in (5, 300000, 7, 600000)]
    ts.append(torch.ones(3, 4, dtype=torch.bfloat16))
    out = tfusion.fused_launch(ts, lambda flat: (lambda: flat), MB // 2,
                               reverse=True)()
    for a, b in zip(ts, out):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
