"""The flash-attention module of the PyTorch package against the JAX
package's (ops/flash_attention.py, parallel/ring_attention.py).

Both get the same float32 numpy inputs from a seed. The JAX kernels run
as tests/test_flash_attention.py runs them on the CPU (Pallas interpret
mode); the port runs the plain PyTorch versions of its CUDA kernels,
which a CPU tensor takes. Sequences of at most 128 with 64-blocks keep
the interpret-mode kernels quick.

Tolerance: 1e-5 of the largest magnitude for outputs and 2e-5 for
gradients, in f32: the two sides sum the same products in different
orders (online softmax over 64-blocks against one full-row softmax), and
a gradient adds a few such sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu.parallel.ring_attention import (
    blockwise_attention_reference as jax_reference)
from horovod_tpu_torch.common.exceptions import KernelError
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel.ring_attention import (
    blockwise_attention_reference)

TOL_OUT, TOL_GRAD = 1e-5, 2e-5


def _mk(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(a, b, tol):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.detach() if torch.is_tensor(b) else b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= tol * (np.max(np.abs(a)) + 1e-9), \
        (np.max(np.abs(a - b)), np.max(np.abs(a)))


def _j(*arrs):
    return [jnp.asarray(a, jnp.float32) for a in arrs]


def _t(*arrs):
    return [torch.tensor(a, requires_grad=True) for a in arrs]


def _counts():
    return [f.launches for f in (tfa.flash_fwd, tfa.flash_bwd_dkdv,
                                 tfa.flash_bwd_dq)]


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax(causal):
    q, k, v = _mk(*[(2, 2, 128, 32)] * 3)
    want = jfa.flash_attention(*_j(q, k, v), causal=causal, block_q=64,
                               block_k=64)
    got = tfa.flash_attention(*_t(q, k, v), causal=causal, block_q=64,
                              block_k=64)
    _close(want, got, TOL_OUT)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    q, k, v = _mk(*[(1, 2, 128, 32)] * 3, seed=1)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jfa.flash_attention(
            q, k, v, causal=causal, block_q=64, block_k=64)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    args = _t(q, k, v)
    torch.sin(tfa.flash_attention(*args, causal=causal, block_q=64,
                                  block_k=64)).sum().backward()
    for a, b in zip(want, args):
        _close(a, b.grad, TOL_GRAD)


def test_chunk_with_lse_cotangent_matches_jax():
    """Sq ≠ Sk, not causal; a loss on both o and lse, so the backward
    takes the variant with dlse."""
    q, k, v, w = _mk((1, 2, 64, 32), (1, 2, 128, 32), (1, 2, 128, 32),
                     (1, 2, 64), seed=2)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_chunk(q, k, v, causal=False)
        return jnp.sum(jnp.sin(o)) + jnp.sum(lse * jnp.asarray(w))

    (oj, lj) = jfa.flash_attention_chunk(*_j(q, k, v), causal=False)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    args = _t(q, k, v)
    o, lse = tfa.flash_attention_chunk(*args, causal=False)
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, 64)
    _close(oj, o, TOL_OUT)
    _close(lj, lse, TOL_OUT)
    (torch.sin(o).sum() + (lse * torch.tensor(w)).sum()).backward()
    for a, b in zip(want, args):
        _close(a, b.grad, TOL_GRAD)


@pytest.mark.parametrize("use_lse", [False, True])
def test_chunk_lse_cotangent_picks_the_variant(monkeypatch, use_lse):
    """A loss on o alone reaches the dK/dV kernel with dlse None (the
    variant without it); a loss on lse hands it the cotangent."""
    seen = []
    real = tfa.flash_bwd_dkdv

    def spy(*a):
        seen.append(a[6])
        return real(*a)

    monkeypatch.setattr(tfa, "flash_bwd_dkdv", spy)
    q, k, v = _t(*_mk(*[(1, 1, 64, 32)] * 3, seed=3))
    o, lse = tfa.flash_attention_chunk(q, k, v, causal=True)
    (lse.sum() if use_lse else o.sum()).backward()
    assert len(seen) == 1 and (seen[0] is not None) == use_lse


def test_chunk_refuses_what_jax_refuses():
    q, k = torch.zeros((1, 1, 64, 32)), torch.zeros((1, 1, 128, 32))
    with pytest.raises(ValueError):
        tfa.flash_attention_chunk(q, k, k, causal=True)  # not square
    with pytest.raises(ValueError):
        tfa.flash_attention_chunk(q, k, k, block_q=48)  # 48 ∤ 64


def test_untileable_shape_takes_the_reference():
    """S = 1100 has no block (as in the JAX package): the reference
    route, no kernel; both packages agree."""
    q, k, v = _mk(*[(1, 1, 1100, 32)] * 3, seed=4)
    before = _counts()
    got = tfa.flash_attention(*_t(q, k, v), causal=True)
    want = jfa.flash_attention(*_j(q, k, v), causal=True)
    _close(want, got, TOL_OUT)
    _close(blockwise_attention_reference(*_t(q, k, v)), got, 0.0)
    assert _counts() == before


def test_blocks_that_do_not_divide_take_the_reference():
    q, k, v = _mk(*[(1, 2, 96, 32)] * 3, seed=5)
    got = tfa.flash_attention(*_t(q, k, v), causal=True, block_q=64)
    want = jfa.flash_attention(*_j(q, k, v), causal=True, block_q=64)
    _close(want, got, TOL_OUT)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_jax(causal):
    q, k, v = _mk(*[(2, 2, 48, 16)] * 3, seed=6)
    _close(jax_reference(*_j(q, k, v), causal=causal),
           blockwise_attention_reference(*_t(q, k, v), causal=causal),
           TOL_OUT)


@pytest.mark.parametrize("S", [1, 100, 1024, 1025, 1100, 2048, 3072, 4224])
def test_tiling_rule_is_the_jax_one(S):
    assert tfa._auto_block(S) == jfa._auto_block(S)
    for sk in (S, 2048, 1100):
        for causal in (False, True):
            assert tfa.can_tile(S, sk, causal) == jfa.can_tile(S, sk,
                                                               causal)


def test_plain_kernels_match_jax_kernels_directly():
    """Kernels 4–6's plain versions against the JAX _fwd/_bwd at the
    flattened (B·H, S, dh) layout, with a dlse cotangent."""
    q, k, v, do, dl = _mk((4, 64, 32), (4, 128, 32), (4, 128, 32),
                          (4, 64, 32), (4, 64), seed=7)
    scale = 32 ** -0.5
    oj, lj = jfa._fwd(*_j(q, k, v), False, scale, 64, 64)
    ot, lt = tfa.flash_fwd(*[torch.tensor(a) for a in (q, k, v)], False,
                           scale)
    _close(oj, ot, TOL_OUT)
    _close(np.asarray(lj)[..., 0], lt, TOL_OUT)
    dqj, dkj, dvj = jfa._bwd(*_j(q, k, v), oj, lj, jnp.asarray(do),
                             jnp.asarray(dl)[..., None], False, scale, 64, 64)
    qt, kt, vt, dot, dlt = (torch.tensor(a) for a in (q, k, v, do, dl))
    dkt, dvt, delta = tfa.flash_bwd_dkdv(qt, kt, vt, ot, dot, lt, dlt, False,
                                         scale)
    dqt = tfa.flash_bwd_dq(qt, kt, vt, dot, lt, delta, False, scale)
    for a, b in ((dqj, dqt), (dkj, dkt), (dvj, dvt)):
        _close(a, b, TOL_GRAD)


def test_cpu_tensor_counts_no_launch():
    before = _counts()
    q, k, v = _t(*_mk(*[(1, 2, 64, 32)] * 3, seed=8))
    tfa.flash_attention(q, k, v).sum().backward()
    assert _counts() == before


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel path, which refuses what it
    does not take; it never quietly computes the plain version."""
    q = torch.empty((2, 64, 32), device="meta")
    with pytest.raises(KernelError, match="CUDA"):
        tfa.flash_fwd(q, q, q, True, 0.1)
    lse = torch.empty((2, 64), device="meta")
    with pytest.raises(KernelError):
        tfa.flash_bwd_dkdv(q, q, q, q, q, lse, None, True, 0.1)
    with pytest.raises(KernelError):
        tfa.flash_bwd_dq(q, q, q, q, lse, lse, True, 0.1)


# ---------------------------------------------------------------- head dims

@pytest.mark.parametrize("dh,D", [(16, 32), (32, 32), (48, 64), (80, 128),
                                  (129, 256), (256, 256), (320, 512),
                                  (512, 512)])
def test_instance_is_the_next_head_dim_with_a_kernel(dh, D):
    assert tfa._instance(dh) == D


@pytest.mark.parametrize("dh,D", [(257, 512), (320, 512), (600, 768),
                                  (1024, 1024)])
def test_head_dim_above_256_is_refused(dh, D):
    """A head dim above 256 was refused (no instance); now the kernels
    take it on the wide path: padded to the next multiple of 256 and
    written in 256-wide windows, the D 256 instance being the case of
    one window."""
    assert tfa._instance(dh) == D
    assert D % tfa.WINDOW == 0 and D // tfa.WINDOW == len(_windows(D)) > 1
    with pytest.raises(KernelError):
        tfa._instance(0)


def _padded_route(q, k, v, causal):
    """What a CUDA tensor takes for a head dim without an instance: q, k,
    v zero-padded to `_instance(dh)`, the kernels (here their plain
    versions) at the true dh's scale, the outputs sliced back. Returns
    (o, (dq, dk, dv)) for the loss sum(sin(o)), at (BH, S, dh)."""
    dh = q.shape[-1]
    D, scale = tfa._instance(dh), dh ** -0.5
    qp, kp, vp = (tfa._pad_head(t, D) for t in (q, k, v))
    o_p, lse = tfa._fwd_plain(qp, kp, vp, causal, scale)
    o = o_p[..., :dh]
    do_p = tfa._pad_head(torch.cos(o), D)
    dk, dv, delta = tfa._bwd_dkdv_plain(qp, kp, vp, o_p, do_p, lse, None,
                                        causal, scale)
    dq = tfa._bwd_dq_plain(qp, kp, vp, do_p, lse, delta, causal, scale)
    return o, tuple(g[..., :dh] for g in (dq, dk, dv))


@pytest.mark.parametrize("dh", [16, 48, 80, 96, 200])
def test_padded_head_dim_matches_jax(dh):
    """Zero-padding dh to the next instance is exact: the padded route
    equals the JAX kernel (interpret mode) at the true dh, forward and
    q, k, v gradients, causal."""
    S = 64 if dh > 128 else 128
    q, k, v = _mk(*[(1, 2, S, dh)] * 3, seed=dh)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jfa.flash_attention(
            q, k, v, causal=True, block_q=64, block_k=64)))

    want_o = jfa.flash_attention(*_j(q, k, v), causal=True, block_q=64,
                                 block_k=64)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    flat = [torch.tensor(a.reshape(2, S, dh)) for a in (q, k, v)]
    o, grads = _padded_route(*flat, causal=True)
    _close(np.asarray(want_o).reshape(2, S, dh), o, TOL_OUT)
    for a, b in zip(want, grads):
        _close(np.asarray(a).reshape(2, S, dh), b, TOL_GRAD)


def _windows(D):
    """The column windows of o, dq, dk and dv that the kernels' blocks
    write at padded head dim D (csrc/flash_common.cuh): all of D up to
    256, 256-wide slices above."""
    if D <= tfa.WINDOW:
        return [slice(0, D)]
    return [slice(w, w + tfa.WINDOW) for w in range(0, D, tfa.WINDOW)]


def _windowed_route(q, k, v, causal):
    """What a CUDA tensor takes for a head dim above 256 (the wide path):
    q, k, v zero-padded to `_instance(dh)`, a multiple of 256; the scores
    over the whole padded width; each 256-wide window of o, dq, dk and dv
    from the window of v, do, k or q it reads (as one block of each
    window computes it), through the plain versions and their `_ds`; the
    outputs sliced back. Returns (o, (dq, dk, dv)) for the loss
    sum(sin(o)), at (BH, S, dh)."""
    dh = q.shape[-1]
    D, scale = tfa._instance(dh), dh ** -0.5
    qp, kp, vp = (tfa._pad_head(t, D) for t in (q, k, v))
    wins = _windows(D)
    assert len(wins) > 1
    parts = [tfa._fwd_plain(qp, kp, vp[..., w], causal, scale) for w in wins]
    lse = parts[0][1]
    for _, l_w in parts[1:]:
        assert torch.equal(l_w, lse)  # every window, the same lse
    o_p = torch.cat([o_w for o_w, _ in parts], -1)
    o = o_p[..., :dh]
    do_p = tfa._pad_head(torch.cos(o), D)
    delta = tfa._delta(o_p, do_p, None)
    p, ds = tfa._ds(qp, kp, vp, do_p, lse, delta, causal, scale)
    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    dq = torch.cat([torch.matmul(ds, kp[..., w]) for w in wins], -1)
    dk = torch.cat([torch.matmul(dst, qp[..., w]) for w in wins], -1)
    dv = torch.cat([torch.matmul(pt, do_p[..., w]) for w in wins], -1)
    return o, tuple(g[..., :dh] for g in (dq, dk, dv))


@pytest.mark.parametrize("dh", [320, 512])
def test_wide_head_dim_matches_jax(dh):
    """The wide path (dh above 256: padded to a multiple of 256, scores
    over the whole width, outputs in 256-wide windows) equals the JAX
    kernel (interpret mode) at the true dh, forward and q, k, v
    gradients, causal. Tolerance as for the padded head dims: 1e-5 of
    the largest output, 2e-5 of the largest gradient (f32, sums in other
    orders)."""
    S = 64
    q, k, v = _mk(*[(1, 2, S, dh)] * 3, seed=dh)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jfa.flash_attention(
            q, k, v, causal=True, block_q=64, block_k=64)))

    want_o = jfa.flash_attention(*_j(q, k, v), causal=True, block_q=64,
                                 block_k=64)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    flat = [torch.tensor(a.reshape(2, S, dh)) for a in (q, k, v)]
    o, grads = _windowed_route(*flat, causal=True)
    _close(np.asarray(want_o).reshape(2, S, dh), o, TOL_OUT)
    for a, b in zip(want, grads):
        _close(np.asarray(a).reshape(2, S, dh), b, TOL_GRAD)


@pytest.mark.parametrize("dh", [16, 48, 80, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_padding_leaves_lse_and_delta_unchanged(dh, causal):
    """The padded plain kernels give the unpadded ones' o, lse, delta and
    gradients: zero columns add nothing to any sum."""
    q, k, v, do = (torch.tensor(a) for a in _mk(*[(2, 64, dh)] * 4,
                                                seed=10 + dh))
    D, scale = tfa._instance(dh), dh ** -0.5
    o, lse = tfa._fwd_plain(q, k, v, causal, scale)
    dk, dv, delta = tfa._bwd_dkdv_plain(q, k, v, o, do, lse, None, causal,
                                        scale)
    p = [tfa._pad_head(t, D) for t in (q, k, v, do)]
    o_p, lse_p = tfa._fwd_plain(p[0], p[1], p[2], causal, scale)
    dk_p, dv_p, delta_p = tfa._bwd_dkdv_plain(
        p[0], p[1], p[2], tfa._pad_head(o, D), p[3], lse, None, causal,
        scale)
    _close(o, o_p[..., :dh], 1e-6)
    assert not bool(o_p[..., dh:].any())
    _close(lse, lse_p, 1e-6)
    _close(delta, delta_p, 1e-6)
    _close(dk, dk_p[..., :dh], 1e-6)
    _close(dv, dv_p[..., :dh], 1e-6)


# ---------------------------------------------------------------- instances

@pytest.mark.parametrize("dh", [16, 32, 48, 64, 80, 96, 112, 128])
def test_bf16_up_to_128_takes_the_hopper_instance(dh):
    """Kernels 4, 5 and 6 run bf16 at every head dim up to 128 (padded
    to the D 32, 64 or 128 instance) on their Hopper instances."""
    assert tfa.flash_instance(torch.bfloat16, dh) == "hopper"


@pytest.mark.parametrize("dtype,dh", [
    (torch.float32, 32), (torch.float32, 64), (torch.float32, 128),
    (torch.bfloat16, 129), (torch.bfloat16, 200), (torch.bfloat16, 256),
    (torch.bfloat16, 320), (torch.bfloat16, 512)])
def test_f32_and_wide_head_dims_take_the_simple_instance(dtype, dh):
    """f32 (tf32 wgmma takes K-major operands only), D 256 and the wide
    path above it keep the simple mma.sync kernels."""
    assert tfa.flash_instance(dtype, dh) == "simple"
