"""The fused 1x1-conv + BN kernel modules of the PyTorch package against
the JAX package's (ops/conv_block.py, ops/conv_bn_backward.py).

Both get the same float32 numpy inputs from a seed. The JAX kernels run
as their own tests run them on the CPU (Pallas interpret mode); the port
runs the plain PyTorch versions of its CUDA kernels, which a CPU tensor
takes. Tolerance: 1e-5 of the largest magnitude in f32 (the two sides
sum in different orders); 2e-2 in bf16, the bar of the JAX package's own
bf16 tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import conv_block as jcb
from horovod_tpu.ops import conv_bn_backward as jcbb
from horovod_tpu_torch.common.exceptions import KernelError
from horovod_tpu_torch.ops import conv_block as tcb
from horovod_tpu_torch.ops import conv_bn_backward as tcbb

SHAPES = [(256, 32, 48), (250, 16, 64)]


def _mk(m, cin, c, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, cin)).astype(np.float32),
            (rng.standard_normal((cin, c)) * 0.1).astype(np.float32),
            (rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32))


def _close(a, b, tol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().float() if torch.is_tensor(b) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= tol * (np.max(np.abs(a)) + 1e-9), \
        (np.max(np.abs(a - b)), np.max(np.abs(a)))


def _t(*arrs, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a, jnp.float32) for a in arrs]


# ---------------------------------------------------------------- kernel 1

@pytest.mark.parametrize("m,cin,c", SHAPES)
def test_fwd_fused_matches_jax(m, cin, c):
    x, w, _, _ = _mk(m, cin, c)
    yj, sj, qj = jcb.conv1x1_fwd_fused(*_j(x, w))
    yt, st, qt = tcb.conv1x1_fwd_fused(*_t(x, w))
    _close(yj, yt, 1e-5)
    _close(sj, st, 1e-5)
    _close(qj, qt, 1e-5)


# ---------------------------------------------------------------- kernels 2, 3

def _rows(c, seed):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(c).astype(np.float32) * 0.1
    inv = (1.0 + rng.random(c)).astype(np.float32)
    db = rng.standard_normal(c).astype(np.float32)
    dg = rng.standard_normal(c).astype(np.float32)
    dm = rng.standard_normal(c).astype(np.float32) * 0.1
    dv = rng.standard_normal(c).astype(np.float32) * 0.1
    return mean, inv, db, dg, dm, dv


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,cin,c", SHAPES)
def test_bn_act_bwd_fused_matches_jax(m, cin, c, relu):
    x, w, scale, bias = _mk(m, cin, c, seed=1)
    rng = np.random.default_rng(2)
    dz = rng.standard_normal((m, c)).astype(np.float32)
    y = (x @ w).astype(np.float32)
    rows = _rows(c, 3)
    args = (dz, y, x, w, scale, bias) + rows[:4]
    dxj, dwj = jcb.conv1x1_bn_act_bwd_fused(
        *_j(*args), dmean=jnp.asarray(rows[4]), dvar=jnp.asarray(rows[5]),
        count=2 * m, relu=relu)
    dxt, dwt = tcb.conv1x1_bn_act_bwd_fused(
        *_t(*args), dmean=torch.tensor(rows[4]), dvar=torch.tensor(rows[5]),
        count=2 * m, relu=relu)
    _close(dxj, dxt, 1e-5)
    _close(dwj, dwt, 1e-5)


@pytest.mark.parametrize("m,cin,c", SHAPES)
def test_bn_bwd_fused_matches_jax(m, cin, c):
    x, w, scale, _ = _mk(m, cin, c, seed=4)
    rng = np.random.default_rng(5)
    dz = rng.standard_normal((m, c)).astype(np.float32)
    y = (x @ w).astype(np.float32)
    rows = _rows(c, 6)
    args = (dz, y, x, w, scale) + rows[:4]
    dxj, dwj = jcbb.conv1x1_bn_bwd_fused(
        *_j(*args), dmean=jnp.asarray(rows[4]), dvar=jnp.asarray(rows[5]))
    dxt, dwt = tcbb.conv1x1_bn_bwd_fused(
        *_t(*args), dmean=torch.tensor(rows[4]), dvar=torch.tensor(rows[5]))
    _close(dxj, dxt, 1e-5)
    _close(dwj, dwt, 1e-5)


# ---------------------------------------------------------------- autograd ops

def _jax_grads(f, args, with_stats):
    def loss(*a):
        z, (mean, var) = f(*a)
        out = jnp.sum(jnp.sin(z.astype(jnp.float32)))
        if with_stats:
            out = out + 0.3 * jnp.sum(jnp.cos(mean)) + 0.1 * jnp.sum(var ** 2)
        return out, (z, mean, var)
    (_, outs), g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                      has_aux=True)(*args)
    return outs, g


def _torch_grads(f, args, with_stats):
    z, (mean, var) = f(*args)
    loss = torch.sin(z.float()).sum()
    if with_stats:
        loss = loss + 0.3 * torch.cos(mean).sum() + 0.1 * (var ** 2).sum()
    g = torch.autograd.grad(loss, args)
    return (z, mean, var), g


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,cin,c", SHAPES)
def test_conv_bn_act_op_matches_jax(m, cin, c, relu, with_stats):
    """Forward (z, mean, var) and the four gradients; `with_stats` puts
    the batch stats in the loss, so the dmean/dvar cotangents count."""
    arrs = _mk(m, cin, c, seed=7)
    oj, gj = _jax_grads(lambda *a: jcb.conv1x1_bn_act(*a, 1e-5, None, relu),
                        _j(*arrs), with_stats)
    ot, gt = _torch_grads(lambda *a: tcb.conv1x1_bn_act(*a, 1e-5, None,
                                                        relu),
                          _t(*arrs, grad=True), with_stats)
    for a, b in zip(oj + gj, ot + gt):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("m,cin,c", SHAPES)
def test_conv_bn_op_matches_jax(m, cin, c, with_stats):
    arrs = _mk(m, cin, c, seed=8)
    oj, gj = _jax_grads(lambda *a: jcbb.conv1x1_bn(*a), _j(*arrs),
                        with_stats)
    ot, gt = _torch_grads(lambda *a: tcbb.conv1x1_bn(*a),
                          _t(*arrs, grad=True), with_stats)
    for a, b in zip(oj + gj, ot + gt):
        _close(a, b, 1e-5)


def test_nhwc_wrappers_match_rows():
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.standard_normal((2, 4, 4, 16)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((16, 32)).astype(np.float32) * 0.1)
    s, b = torch.ones(32), torch.zeros(32)
    for f_nhwc, f_rows in ((tcb.conv1x1_bn_act_nhwc, tcb.conv1x1_bn_act),
                           (tcbb.conv1x1_bn_nhwc, tcbb.conv1x1_bn)):
        z, (mean, var) = f_nhwc(x, w, s, b)
        zr, _ = f_rows(x.reshape(-1, 16), w, s, b)
        assert z.shape == (2, 4, 4, 32) and mean.shape == (32,)
        assert torch.equal(z.reshape(-1, 32), zr)


def test_bf16_boundary_mask_matches_forward():
    """The JAX package's boundary test, on the port: per channel, the
    bias puts one row's pre-activation at ±1e-5, far below bf16 rounding
    and far above f32 residue. The fused forward equals the reference
    bit for bit, the fused gradients match autograd of the reference and
    the JAX package's fused gradients within the bf16 bar (2e-2): one
    flipped mask sign would break that."""
    rng = np.random.default_rng(2)
    m, cin, c = 64, 8, 16
    x = torch.tensor(rng.standard_normal((m, cin)).astype(np.float32)
                     ).bfloat16()
    w = torch.tensor((rng.standard_normal((cin, c)) * 0.1).astype(
        np.float32)).bfloat16()
    scale = torch.full((c,), 1.015625, dtype=torch.bfloat16)
    yf = torch.matmul(x.float(), w.float()).bfloat16().float()
    mean = yf.mean(0)
    inv = torch.rsqrt(yf.square().mean(0) - mean.square() + 1e-5)
    prod = ((yf - mean) * inv * scale.float()).numpy()
    delta = 1e-5 * (-1.0) ** np.arange(c)
    bias = torch.tensor((-prod[np.arange(c) % m, np.arange(c)] + delta
                         ).astype(np.float32))
    zr, _ = tcb.conv_block_reference(x, w, scale, bias)
    zf, _ = tcb.conv1x1_bn_relu(x, w, scale, bias)
    assert torch.equal(zr, zf)

    def grads(f, args):
        args = [a.detach().requires_grad_(True) for a in args]
        loss = torch.sin(f(*args)[0].float()).sum()
        return torch.autograd.grad(loss, args)

    gr = grads(tcb.conv_block_reference, (x, w, scale, bias))
    gf = grads(tcb.conv1x1_bn_relu, (x, w, scale, bias))
    for a, b in zip(gr, gf):
        _close(a.float().numpy(), b, 2e-2)
    jargs = (jnp.asarray(x.float().numpy(), jnp.bfloat16),
             jnp.asarray(w.float().numpy(), jnp.bfloat16),
             jnp.asarray(scale.float().numpy(), jnp.bfloat16),
             jnp.asarray(bias.numpy(), jnp.float32))
    gj = jax.grad(lambda *a: jnp.sum(jnp.sin(
        jcb.conv1x1_bn_relu(*a)[0].astype(jnp.float32))),
        argnums=(0, 1, 2, 3))(*jargs)
    for a, b in zip(gj, gf):
        _close(np.asarray(a, np.float32), b, 2e-2)


# ---------------------------------------------------------------- dispatch

def test_cpu_tensor_takes_plain_version():
    """A CPU tensor runs the plain version and counts no launch."""
    x, w, scale, bias = _t(*_mk(64, 8, 16, seed=11))
    counters = (tcb.conv1x1_fwd_fused, tcb.conv1x1_bn_act_bwd_fused,
                tcbb.conv1x1_bn_bwd_fused)
    before = [f.launches for f in counters]
    y, s, q = tcb.conv1x1_fwd_fused(x, w)
    assert all(torch.equal(a, b) for a, b in
               zip((y, s, q), tcb._fwd_plain(x, w)))
    xg = x.clone().requires_grad_(True)
    tcb.conv1x1_bn_relu(xg, w, scale, bias)[0].sum().backward()
    xg.grad = None
    tcbb.conv1x1_bn(xg, w, scale, bias)[0].sum().backward()
    assert [f.launches for f in counters] == before


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel path, which refuses what
    it does not take; it never quietly computes the plain version."""
    x = torch.empty((64, 8), device="meta")
    w = torch.empty((8, 16), device="meta")
    with pytest.raises(KernelError):
        tcb.conv1x1_fwd_fused(x, w)
    dz = torch.empty((64, 16), device="meta")
    row = torch.empty((16,), device="meta")
    with pytest.raises(KernelError):
        tcbb.conv1x1_bn_bwd_fused(dz, dz, x, w, row, row, row, row, row)


# ---------------------------------------------------------------- instances

def _resnet50_sites():
    from horovod_tpu_torch.models import resnet
    return sorted({(m, cin, c) for _, _, m, cin, c in
                   resnet.fused_sites(50, 32, 224)})


# Ragged M (and C) that still take the Hopper instances: TMA fills the
# edges with zeros.
RAGGED_HOPPER = [(6271, 256, 1024), (6271, 64, 200)]


@pytest.mark.parametrize("m,cin,c", _resnet50_sites() + RAGGED_HOPPER)
def test_resnet50_sites_take_the_hopper_instance_in_bf16(m, cin, c):
    """Kernels 2 and 3 run every ResNet-50 site (batch 32) on the Hopper
    instance in bf16, and on its tf32 sibling in f32."""
    assert tcbb.bwd_instance(m, cin, c, torch.bfloat16) == "hopper"
    assert tcbb.bwd_instance(m, cin, c, torch.float32) == "hopper_tf32"


@pytest.mark.parametrize("m,cin,c", [(1001, 24, 50), (250, 16, 64),
                                     (256, 32, 48), (4096, 100, 64),
                                     (4096, 64, 1032), (4096, 2048, 64)])
def test_other_shapes_take_the_simple_instance(m, cin, c):
    """Cin or C below 64, not a multiple of 8 (TMA's stride rule) or
    above 1024 (the staged rows) keep the simple mma.sync code."""
    assert tcbb.bwd_instance(m, cin, c, torch.bfloat16) == "simple"


@pytest.mark.parametrize("m,cin,c,want", [
    (100352, 64, 64, (64, 64, 64)), (100352, 64, 256, (64, 64, 128)),
    (25088, 128, 512, (128, 128, 128)), (100352, 200, 64, (256, 256, 64)),
    (25088, 512, 128, (256, 256, 128)), (6272, 1024, 512, (128, 256, 128)),
    (6272, 256, 1024, (128, 256, 128)), (1000, 64, 64, (64, 64, 64))])
def test_hopper_tiles_are_the_smallest_that_hold_the_shape(m, cin, c, want):
    """The smallest tiles that hold Cin and C, except that dx drops to
    128-wide tiles where 256-wide ones leave fewer than two waves of
    128-row jobs over the 132 SMs (the M 6272 sites)."""
    assert tcbb.hopper_tiles(m, cin, c) == want


@pytest.mark.parametrize("m,cin,c", _resnet50_sites() + RAGGED_HOPPER
                         + [(64, 64, 64), (100, 1024, 1024)])
def test_hopper_dw_plan_covers_m_in_a_fixed_order(m, cin, c):
    """The Hopper dW split: block s of the clusters x 8 takes rows
    [s·chunk, (s+1)·chunk) ∩ [0, M), summed in the order of s (within a
    cluster through distributed shared memory, then over clusters by
    colsum), so the chunks must tile M in order, in whole 64-row ring
    steps, with no cluster left empty; and the f32 workspace for the
    clusters' sums stays at most 16 tiles of 256 x 128 (2 MiB)."""
    clusters, chunk = tcbb.hopper_dw_plan(m, cin, c)
    assert tcbb.hopper_dw_plan(m, cin, c) == (clusters, chunk)
    splits = clusters * tcbb.HOPPER_CLUSTER
    assert chunk % 64 == 0 and chunk > 0
    spans = [(s * chunk, min(m, (s + 1) * chunk)) for s in range(splits)]
    rows = [r for b, e in spans for r in range(b, e)]
    assert rows == list(range(m))
    assert (clusters - 1) * tcbb.HOPPER_CLUSTER * chunk < m
    _, ct, nt = tcbb.hopper_tiles(m, cin, c)
    tiles = -(-cin // ct) * -(-c // nt)
    assert clusters == 1 or tiles * clusters <= 16
    ws = 0 if clusters == 1 else clusters * cin * c * 4  # launch_bwd's
    assert ws <= 2 * 2 ** 20


def test_hopper_workspace_is_far_below_the_simple_split():
    """At (6272, 256, 1024) the simple dW pass writes 17 f32 partials of
    dW (17.8 MB, read back by colsum: 35.7 MB); the Hopper plan writes
    two cluster sums (2 MiB)."""
    splits, _ = tcbb.dw_splits(6272, 256, 1024)
    assert splits * 256 * 1024 * 4 > 17e6
    clusters, _ = tcbb.hopper_dw_plan(6272, 256, 1024)
    assert clusters * 256 * 1024 * 4 == 2 * 2 ** 20


# ---------------------------------------------------------------- kernel 1

@pytest.mark.parametrize("m,cin,c", _resnet50_sites() + RAGGED_HOPPER)
def test_resnet50_sites_take_the_hopper_fwd_instance_in_bf16(m, cin, c):
    """Kernel 1 runs every ResNet-50 site (batch 32) on its Hopper
    instance in bf16, and on the simple (tf32) one in f32."""
    assert tcb.fwd_instance(m, cin, c, torch.bfloat16) == "hopper"
    assert tcb.fwd_instance(m, cin, c, torch.float32) == "simple"


@pytest.mark.parametrize("m,cin,c", [(1001, 24, 50), (250, 16, 64),
                                     (256, 32, 48), (4096, 100, 64),
                                     (4096, 64, 1032), (4096, 2048, 64)])
def test_other_shapes_take_the_simple_fwd_instance(m, cin, c):
    """Cin or C below 64, not a multiple of 8 or above 1024 keep kernel
    1's simple mma.sync code, as for kernels 2 and 3."""
    assert tcb.fwd_instance(m, cin, c, torch.bfloat16) == "simple"


@pytest.mark.parametrize("m,cin,c", _resnet50_sites() + RAGGED_HOPPER
                         + [(6271, 64, 200), (1000, 64, 64),
                            (100, 1024, 1024)])
def test_fwd_tile_covers_c_and_fills_the_sms(m, cin, c):
    """Kernel 1's Hopper jobs: a column width the kernel has (64, 128,
    256) whose tiles cover C exactly (the last one holds the edge); at
    every ResNet-50 site at least one job an SM (132), which the M 6272
    sites reach by narrower tiles; and never narrower than needed."""
    bn = tcb.fwd_tile(m, cin, c)
    assert bn in (64, 128, 256)
    n_ct = -(-c // bn)
    assert (n_ct - 1) * bn < c <= n_ct * bn
    jobs = -(-m // tcb.FWD_ROWS) * n_ct
    if (m, cin, c) in _resnet50_sites():
        assert jobs >= 132
    if bn < 256 and bn < c:  # halved: the wider tile left SMs idle
        assert -(-m // tcb.FWD_ROWS) * -(-c // (2 * bn)) < 132


def test_m6272_sites_get_a_wave_of_jobs():
    """The three M 6272 shapes: 128 x 256 tiles would give 49, 49 and 98
    jobs for the 132 SMs; the planner's widths give 196 each."""
    for cin, c, want in ((256, 1024, 256), (1024, 256, 64),
                         (1024, 512, 128)):
        bn = tcb.fwd_tile(6272, cin, c)
        assert bn == want
        assert 49 * -(-c // bn) == 196
