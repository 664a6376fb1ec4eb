"""ops/pooling.max_pool of the PyTorch package against the JAX package.

The same NHWC numpy inputs, made from a seed, go through the port's
`max_pool` and through `horovod_tpu.ops.pooling.max_pool` (its one-hot
backward) and the stock `lax.reduce_window` max with its VJP
(SelectAndScatter with GE-select): tests/test_pooling.py's five CASES,
their inputs rounded to halves (ties in most windows), an all-zero
input and post-ReLU data through Inception's overlapping 3x3/2 windows
(ties of zeros, and inputs that two windows share), and bf16.

The forward is a max: equal bit for bit. The gradient gives each
window's cotangent to its first maximum in window order, in both
packages, so the same positions receive the same values; where
overlapping windows add two or more cotangents into one input the
addition order may differ, so f32 gradients are held within 1e-6 (as
tests/test_pooling.py holds the JAX package's two backwards) and bf16
ones, whose cotangents are small integers, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pooling import max_pool as jmax_pool
from horovod_tpu_torch.ops.pooling import _resolve_padding, max_pool

CASES = [
    ((2, 15, 15, 4), (3, 3), (2, 2), "VALID"),
    ((2, 16, 16, 4), (3, 3), (2, 2), "SAME"),
    ((1, 8, 8, 3), (2, 2), (2, 2), "VALID"),
    ((2, 9, 9, 2), (3, 3), (1, 1), "SAME"),
    ((1, 10, 12, 2), (3, 2), (2, 3), "VALID"),
]
GRAD_ATOL = 1e-6


def _stock(x, window, strides, padding):
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, *window, 1), (1, *strides, 1),
        padding if isinstance(padding, str)
        else ((0, 0), *padding, (0, 0)))


def _input(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2) / 2
    elif kind == "relu":
        x = np.maximum(np.round(x * 2) / 2, 0)
    elif kind == "zeros":
        x = np.zeros(shape, np.float32)
    return x


@functools.lru_cache(maxsize=None)
def _grad_fn(pool, window, strides, padding):
    """jit of x, ct -> d sum(pool(x) * ct) / dx, one per pool config."""
    return jax.jit(jax.grad(
        lambda x, ct: jnp.sum(pool(x, window, strides, padding) * ct)))


def _jax_grads(x, ct, window, strides, padding):
    """Gradients of sum(pool(x) * ct) by the stock VJP and by the JAX
    package's one-hot backward."""
    x, ct = jnp.asarray(x), jnp.asarray(ct)
    return tuple(np.asarray(_grad_fn(pool, window, strides, padding)(x, ct))
                 for pool in (_stock, jmax_pool))


def _torch(x, ct, window, strides, padding):
    xt = torch.tensor(x, requires_grad=True)
    y = max_pool(xt, window, strides, padding)
    (y * torch.tensor(ct)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("kind", ["random", "ties", "relu", "zeros"])
@pytest.mark.parametrize("shape,window,strides,padding", CASES)
def test_forward_and_gradient_match_jax(shape, window, strides, padding,
                                        kind):
    x = _input(shape, kind)
    want = np.asarray(_stock(jnp.asarray(x), window, strides, padding))
    ct = np.random.default_rng(2).standard_normal(want.shape).astype(
        np.float32)
    y, g = _torch(x, ct, window, strides, padding)
    np.testing.assert_array_equal(y, want)
    np.testing.assert_array_equal(
        y, np.asarray(jmax_pool(jnp.asarray(x), window, strides, padding)))
    g_stock, g_onehot = _jax_grads(x, ct, window, strides, padding)
    np.testing.assert_allclose(g, g_stock, rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(g, g_onehot, rtol=0, atol=GRAD_ATOL)


def test_ties_go_to_the_first_max_in_window_order():
    """A 3x3/2 window of zeros over a 1x5x5x1 input: every window's
    cotangent lands on its top-left zero, and the input that two windows
    share (row 2, col 2) receives both."""
    x = np.zeros((1, 5, 5, 1), np.float32)
    ct = np.array([1.0, 2.0, 4.0, 8.0], np.float32).reshape(1, 2, 2, 1)
    _, g = _torch(x, ct, (3, 3), (2, 2), "VALID")
    want = np.zeros((5, 5), np.float32)
    want[0, 0], want[0, 2], want[2, 0], want[2, 2] = 1.0, 2.0, 4.0, 8.0
    np.testing.assert_array_equal(g[0, :, :, 0], want)
    g_stock, _ = _jax_grads(x, ct, (3, 3), (2, 2), "VALID")
    np.testing.assert_array_equal(g, g_stock)


def test_inception_pool_on_post_relu_data():
    """Inception's stem pool shape class (3x3/2 VALID, odd size) on
    post-ReLU data, about half zeros: forward bit for bit, the gradient
    within GRAD_ATOL of SelectAndScatter's."""
    x = np.maximum(_input((2, 17, 17, 8), "random", seed=3), 0)
    assert 0.4 < np.mean(x == 0) < 0.6
    want = np.asarray(_stock(jnp.asarray(x), (3, 3), (2, 2), "VALID"))
    ct = np.random.default_rng(4).standard_normal(want.shape).astype(
        np.float32)
    y, g = _torch(x, ct, (3, 3), (2, 2), "VALID")
    np.testing.assert_array_equal(y, want)
    g_stock, _ = _jax_grads(x, ct, (3, 3), (2, 2), "VALID")
    np.testing.assert_allclose(g, g_stock, rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("kind", ["random", "relu", "zeros"])
def test_bf16_matches_jax_bit_for_bit(kind):
    x32 = _input((2, 16, 16, 8), kind, seed=5)
    xj = jnp.asarray(x32, jnp.bfloat16)
    want = _stock(xj, (3, 3), (2, 2), "VALID")
    g_want = jax.grad(lambda x: jnp.sum(
        _stock(x, (3, 3), (2, 2), "VALID").astype(jnp.float32)))(xj)
    xt = torch.tensor(x32).to(torch.bfloat16).requires_grad_()
    y = max_pool(xt, (3, 3), (2, 2), "VALID")
    y.float().sum().backward()
    assert y.dtype == xt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().detach().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(g_want, np.float32))


@pytest.mark.parametrize("padding", ["VALID", "SAME", "same",
                                     ((1, 0), (0, 2))])
def test_padding_rules_are_the_jax_modules(padding):
    from horovod_tpu.ops.pooling import _resolve_padding as jresolve
    for h, w in ((15, 15), (16, 9), (1, 4)):
        assert _resolve_padding(padding, h, w, 3, 2, 2, 3) == \
            jresolve(padding, h, w, 3, 2, 2, 3)
    x = _input((1, 7, 6, 2), "ties", seed=6)
    np.testing.assert_array_equal(
        max_pool(torch.tensor(x), (3, 2), (2, 3), padding).numpy(),
        np.asarray(jmax_pool(jnp.asarray(x), (3, 2), (2, 3), padding)))
