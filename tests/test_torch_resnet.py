"""The PyTorch ResNet against horovod_tpu.models.resnet.

A mini ResNet (STAGE_BLOCKS[8] = (1, 1), 16x16 input, 10 classes, as
tests/test_conv_block.py builds it) is initialised by the JAX package,
carried over with models/convert.from_jax, and run by both packages on
the same float32 numpy batch under the three routings: the fused block
family (HOROVOD_CONV_BLOCK=1), the fused backward (HOROVOD_FUSE_CONV_BN=1)
and neither. Loss, every gradient and every new batch stat must agree
within 1e-4 of the largest magnitude (f32 through ~10 layers, summed in
different orders by XLA and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import resnet as jresnet
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as tresnet


@pytest.fixture
def mini_depth():
    jresnet.STAGE_BLOCKS[8] = (1, 1)
    tresnet.STAGE_BLOCKS[8] = (1, 1)
    try:
        yield 8
    finally:
        jresnet.STAGE_BLOCKS.pop(8, None)
        tresnet.STAGE_BLOCKS.pop(8, None)


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= tol * (np.max(np.abs(a)) + 1e-9), \
        (what, np.max(np.abs(a - b)), np.max(np.abs(a)))


def flat_stats(ns, prefix=""):
    """The port's nested new-stats dict as {state_dict name: tensor}."""
    out = {}
    for k, v in ns.items():
        if "mean" in v and not isinstance(v["mean"], dict):
            bn = f"{prefix}{k}.bn" if k == "stem" else f"{prefix}{k}"
            out[f"{bn}.mean"], out[f"{bn}.var"] = v["mean"], v["var"]
        else:
            out.update(flat_stats(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("route", ["block", "fuse_bn", "unfused"])
def test_mini_resnet_matches_jax(route, mini_depth, monkeypatch):
    monkeypatch.setenv("HOROVOD_CONV_BLOCK", "1" if route == "block" else "0")
    monkeypatch.setenv("HOROVOD_FUSE_CONV_BN",
                       "1" if route == "fuse_bn" else "0")
    params, stats = jresnet.init(jax.random.PRNGKey(0), depth=mini_depth,
                                 num_classes=10, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    yl = rng.integers(0, 10, (2,))

    def loss(p):
        return jresnet.loss_fn(p, stats, (jnp.asarray(x), jnp.asarray(yl)),
                               depth=mini_depth, train=True)
    (lj, nsj), gj = jax.value_and_grad(loss, has_aux=True)(params)

    model = tresnet.ResNet(depth=mini_depth, num_classes=10)
    convert.load_jax(model, params, stats)
    lt, nst = tresnet.loss_fn(model, (torch.tensor(x), torch.tensor(yl)))
    lt.backward()

    assert abs(float(lj) - lt.item()) <= 1e-5 * abs(float(lj))
    want = convert.from_jax(gj, nsj)
    got = {n: p.grad for n, p in model.named_parameters()}
    got.update(flat_stats(nst))
    assert set(got) == set(want)
    for name, g in got.items():
        _close(want[name], g.detach().numpy(), 1e-4, name)


def test_from_jax_covers_resnet50():
    """from_jax of a full ResNet-50 `init` gives exactly the port's
    names and shapes (no forward pass; zero arrays of the traced
    shapes)."""
    shapes = jax.eval_shape(lambda: jresnet.init(jax.random.PRNGKey(0), 50))
    params, stats = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    state = convert.from_jax(params, stats)
    want = {k: tuple(v.shape) for k, v in
            tresnet.ResNet(depth=50).state_dict().items()}
    assert {k: v.shape for k, v in state.items()} == want


def test_fused_sites_match_routing():
    """fused_sites lists the 28 sites of a ResNet-50 step (14 conv1,
    13 conv3, 1 projection) at the row counts the kernels see."""
    sites = tresnet.fused_sites(50, 32, 224)
    kinds = [s[1] for s in sites]
    assert (kinds.count("conv1"), kinds.count("conv3"),
            kinds.count("proj")) == (14, 13, 1)
    assert ("s0b0", "proj", 100352, 64, 256) in sites
    assert ("s3b0", "conv1", 6272, 1024, 512) in sites
    assert ("s1b0", "conv1", 100352, 256, 128) in sites
