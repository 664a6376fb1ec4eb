"""The PyTorch port's CUDA kernels against their plain versions, on the
card. A CUDA kernel has no CPU mode, so these tests skip on a host
without a GPU; run them there with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

(--noconftest: tests/conftest.py sets up JAX, which a GPU host running
only the port need not have; this file imports no JAX.)

Tolerances as chip_smoke.py states them: bf16 outputs within one bf16
step (2^-7) of the largest value, f32 sums and dW within 1e-3; f32
inputs (tf32 products) within 2^-9; the flash kernels' outputs tile by
tile (each 64-row tile within 2^-7 (bf16) or 2^-9 (f32) of the
reference tile's norm), lse within 2e-3, delta within 2e-5 of the size
of its terms.

Kernels 1 and 6 also on their Hopper instances at the shapes the main
paths give them: kernel 1 at every ResNet-50 site (batch 32) and a
ragged M, kernel 6 at dh 32, 64, 80 (padded) and 128, causal and not,
Sq != Sk, ragged Sq, with an lse cotangent; two launches of each give
the same bits.
"""

import pytest
import torch

from horovod_tpu_torch.ops import conv_block as cb
from horovod_tpu_torch.common.exceptions import KernelError
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.ops import conv_bn_backward as cbb
from horovod_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

SHAPES = [(256, 32, 48), (250, 16, 64), (1001, 24, 50), (4096, 256, 512)]
# Kernels 2 and 3 also at two ResNet-50 site shapes, on their Hopper
# instances in bf16 (Cin 1024 runs the 256-wide tiles and a two-cluster
# dW; Cin 64 the 64-wide ones and 16 clusters) and in f32 (tf32);
# (4096, 256, 512) is Hopper in both types too, the first three simple.
BWD_SHAPES = SHAPES + [(6272, 1024, 256), (100352, 64, 64)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(m, cin, c, dev, seed=0, bf=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, cin), generator=g, device=dev).to(bf)
    w = (torch.randn((cin, c), generator=g, device=dev) * 0.2).to(bf)
    scale = (1 + 0.5 * torch.randn(c, generator=g, device=dev)).to(bf)
    bias = (0.1 * torch.randn(c, generator=g, device=dev)).to(bf)
    dz = torch.randn((m, c), generator=g, device=dev).to(bf)
    return x, w, scale, bias, dz


def _close(got, ref, tol):
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol * float(ref.float().abs().max()), err


@pytest.mark.parametrize("m,cin,c", SHAPES)
def test_fwd_kernel_matches_plain(dev, m, cin, c):
    x, w, *_ = _inputs(m, cin, c, dev)
    before = cb.conv1x1_fwd_fused.launches
    y, s, q = cb.conv1x1_fwd_fused(x, w)
    assert cb.conv1x1_fwd_fused.launches == before + 1
    yr, sr, qr = cb._fwd_plain(x, w)
    _close(y, yr, 2.0 ** -7)
    assert float(((s - sr).abs() / yr.float().abs().sum(0)).max()) <= 1e-3
    assert float(((q - qr).abs() / qr.abs()).max()) <= 1e-3


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,cin,c", BWD_SHAPES)
def test_bwd_kernels_match_plain(dev, m, cin, c, relu):
    x, w, scale, bias, dz = _inputs(m, cin, c, dev, seed=1)
    y, ssum, ssq = cb._fwd_plain(x, w)
    mean = ssum / m
    inv = torch.rsqrt(ssq / m - mean.square() + 1e-5)
    dmean = torch.randn(c, device=dev) * 0.1
    dvar = torch.randn(c, device=dev) * 0.1
    db, dg = cb._bn_act_sums(dz, y, mean, inv, scale, bias, relu)
    dx, dw = cb.conv1x1_bn_act_bwd_fused(dz, y, x, w, scale, bias, mean,
                                         inv, db, dg, dmean, dvar, relu=relu)
    g, a, b = cbb.fold_rows(scale.float(), inv, db, dg, dmean, dvar, m)
    s_row = scale.float() if relu else torch.zeros_like(inv)
    b_row = bias.float() if relu else torch.ones_like(inv)
    dxr, dwr = cbb._bwd_plain(dz, y, x, w, g, mean, inv, a, b, s_row, b_row)
    _close(dx, dxr, 2.0 ** -7)
    _close(dw, dwr, 1e-3)
    if not relu:  # kernel 3 on the same inputs: same BN backward
        dx3, dw3 = cbb.conv1x1_bn_bwd_fused(dz, y, x, w, scale.float(), mean,
                                            inv, db, dg, dmean, dvar)
        _close(dx3, dxr, 2.0 ** -7)
        _close(dw3, dwr, 1e-3)


@pytest.mark.parametrize("m,cin,c", [(6272, 1024, 512), (6271, 64, 200)])
def test_hopper_bwd_is_bitwise_repeatable(dev, m, cin, c):
    """The Hopper instances sum in a fixed order (clusters through
    distributed shared memory, then colsum): two launches on the same
    inputs give the same bits."""
    assert cbb.bwd_instance(m, cin, c, torch.bfloat16) == "hopper"
    x, w, scale, bias, dz = _inputs(m, cin, c, dev, seed=4)
    y, ssum, ssq = cb._fwd_plain(x, w)
    mean = ssum / m
    inv = torch.rsqrt(ssq / m - mean.square() + 1e-5)
    db, dg = cb._bn_act_sums(dz, y, mean, inv, scale, bias, True)
    runs = [cb.conv1x1_bn_act_bwd_fused(dz, y, x, w, scale, bias, mean, inv,
                                        db, dg) for _ in range(2)]
    runs += [cbb.conv1x1_bn_bwd_fused(dz, y, x, w, scale.float(), mean, inv,
                                      db, dg) for _ in range(2)]
    for a, b in ((runs[0], runs[1]), (runs[2], runs[3])):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_block_op_grads_match_reference(dev):
    """The autograd op on the card against autograd of the plain
    reference (bf16 bar, 2e-2, as the JAX package's bf16 tests)."""
    x, w, scale, bias, _ = _inputs(2048, 64, 256, dev, seed=2)

    def grads(f):
        args = [t.detach().clone().requires_grad_(True)
                for t in (x, w, scale, bias)]
        z = f(*args)[0]
        torch.sin(z.float()).sum().backward()
        return [a.grad for a in args]

    for a, b in zip(grads(cb.conv_block_reference), grads(cb.conv1x1_bn_relu)):
        _close(b, a, 2e-2)


# ---------------------------------------------------------------- f32 (tf32)

@pytest.mark.parametrize("m,cin,c", SHAPES)
def test_f32_conv_kernels_match_plain(dev, m, cin, c):
    """A float32 CUDA tensor reaches kernels 1–3 (the tf32 instances) and
    is not refused; each matches its plain version within 2^-9."""
    x, w, scale, bias, dz = _inputs(m, cin, c, dev, seed=3,
                                    bf=torch.float32)
    before = [f.launches for f in (cb.conv1x1_fwd_fused,
                                   cb.conv1x1_bn_act_bwd_fused,
                                   cbb.conv1x1_bn_bwd_fused)]
    y, s, q = cb.conv1x1_fwd_fused(x, w)
    yr, sr, qr = cb._fwd_plain(x, w)
    assert y.dtype == torch.float32
    _close(y, yr, 2.0 ** -9)
    assert float(((s - sr).abs() / yr.abs().sum(0)).max()) <= 1e-3
    assert float(((q - qr).abs() / qr.abs()).max()) <= 1e-3
    mean = sr / m
    inv = torch.rsqrt(qr / m - mean.square() + 1e-5)
    db, dg = cb._bn_act_sums(dz, yr, mean, inv, scale, bias, True)
    dx, dw = cb.conv1x1_bn_act_bwd_fused(dz, yr, x, w, scale, bias, mean,
                                         inv, db, dg)
    g, a, b = cbb.fold_rows(scale, inv, db, dg, None, None, m)
    dxr, dwr = cbb._bwd_plain(dz, yr, x, w, g, mean, inv, a, b, scale, bias)
    _close(dx, dxr, 2.0 ** -9)
    _close(dw, dwr, 2.0 ** -9)
    db3, dg3 = cbb._bn_sums(dz, yr, mean, inv)
    dx3, dw3 = cbb.conv1x1_bn_bwd_fused(dz, yr, x, w, scale, mean, inv, db3,
                                        dg3)
    g3, a3, b3 = cbb.fold_rows(scale, inv, db3, dg3, None, None, m)
    dxr3, dwr3 = cbb._bwd_plain(dz, yr, x, w, g3, mean, inv, a3, b3)
    _close(dx3, dxr3, 2.0 ** -9)
    _close(dw3, dwr3, 2.0 ** -9)
    after = [f.launches for f in (cb.conv1x1_fwd_fused,
                                  cb.conv1x1_bn_act_bwd_fused,
                                  cbb.conv1x1_bn_bwd_fused)]
    assert after == [n + 1 for n in before]


@pytest.mark.parametrize("m,cin,c", [(6272, 1024, 256), (100352, 64, 64),
                                     (25088, 512, 128), (6271, 64, 200)])
def test_tf32_hopper_bwd_matches_plain_and_repeats(dev, m, cin, c):
    """Kernels 2 and 3 in f32 on their Hopper instance (tf32 wgmma, TMA,
    dW split over clusters) at ResNet-50 sites and a ragged M: within
    2^-9 of the plain versions, and two launches give the same bits."""
    assert cbb.bwd_instance(m, cin, c, torch.float32) == "hopper_tf32"
    x, w, scale, bias, dz = _inputs(m, cin, c, dev, seed=6,
                                    bf=torch.float32)
    y, ssum, ssq = cb._fwd_plain(x, w)
    mean = ssum / m
    inv = torch.rsqrt(ssq / m - mean.square() + 1e-5)
    db, dg = cb._bn_act_sums(dz, y, mean, inv, scale, bias, True)
    runs = [cb.conv1x1_bn_act_bwd_fused(dz, y, x, w, scale, bias, mean, inv,
                                        db, dg) for _ in range(2)]
    g, a, b = cbb.fold_rows(scale, inv, db, dg, None, None, m)
    ref2 = cbb._bwd_plain(dz, y, x, w, g, mean, inv, a, b, scale, bias)
    db3, dg3 = cbb._bn_sums(dz, y, mean, inv)
    runs += [cbb.conv1x1_bn_bwd_fused(dz, y, x, w, scale, mean, inv, db3,
                                      dg3) for _ in range(2)]
    g3, a3, b3 = cbb.fold_rows(scale, inv, db3, dg3, None, None, m)
    ref3 = cbb._bwd_plain(dz, y, x, w, g3, mean, inv, a3, b3)
    for (got, again), ref in (((runs[0], runs[1]), ref2),
                              ((runs[2], runs[3]), ref3)):
        _close(got[0], ref[0], 2.0 ** -9)
        _close(got[1], ref[1], 2.0 ** -9)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_conv_kernels_refuse_mixed_dtypes(dev):
    x, w, *_ = _inputs(256, 32, 48, dev)
    with pytest.raises(KernelError):
        cb.conv1x1_fwd_fused(x.float(), w)


# ---------------------------------------------------------------- flash

def _close_tiles(got, ref, tol, tile=64):
    """Every 64-row tile of (BH, S, dh), the part one kernel block
    writes, within tol of the reference tile's norm."""
    d2 = (got.float() - ref.float()).square().sum(-1)
    r2 = ref.float().square().sum(-1)
    pad = -d2.shape[1] % tile
    d2, r2 = (torch.nn.functional.pad(t, (0, pad))
              .reshape(t.shape[0], -1, tile).sum(-1) for t in (d2, r2))
    ratio = float((d2 / r2.clamp_min(1e-30)).sqrt().max())
    assert ratio <= tol, ratio


FLASH = [  # (BH, Sq, Sk, dh, causal, with dlse), in bf16 and f32
    (4, 256, 256, 128, True, False), (4, 200, 200, 64, True, False),
    (4, 256, 256, 32, False, False), (4, 128, 320, 64, False, True),
]
# bf16 only: D 32 with a ragged S (64-byte swizzle, TMA zero fill), dh 80
# (zero-padded to the 128 instance), dh 200 (the 256 instance); and f32
# at dh 200 (the 256 instance with 32-row streamed tiles).
FLASH_MORE = [
    (torch.bfloat16, 4, 1000, 1000, 32, True, False),
    (torch.bfloat16, 4, 256, 256, 80, True, False),
    (torch.bfloat16, 4, 256, 256, 200, True, False),
    (torch.float32, 2, 200, 200, 200, True, True),
]


@pytest.mark.parametrize(
    "dtype,bh,sq,sk,dh,causal,with_dlse",
    [(dt, *row) for row in FLASH for dt in (torch.bfloat16, torch.float32)]
    + FLASH_MORE)
def test_flash_kernels_match_plain(dev, dtype, bh, sq, sk, dh, causal,
                                   with_dlse):
    g = torch.Generator(device=dev).manual_seed(sq + dh)
    q, do = (torch.randn((bh, sq, dh), generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((bh, sk, dh), generator=g, device=dev).to(dtype)
            for _ in range(2))
    dlse = (0.1 * torch.randn((bh, sq), generator=g, device=dev)
            if with_dlse else None)
    sc = dh ** -0.5
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -9
    before = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dkdv,
                                   fa.flash_bwd_dq)]
    o, lse = fa.flash_fwd(q, k, v, causal, sc)
    o_r, lse_r = fa._fwd_plain(q, k, v, causal, sc)
    _close_tiles(o, o_r, tol)
    assert float((lse - lse_r).abs().max()) <= 2e-3
    dk, dv, delta = fa.flash_bwd_dkdv(q, k, v, o, do, lse, dlse, causal, sc)
    dk_r, dv_r, delta_r = fa._bwd_dkdv_plain(q, k, v, o, do, lse, dlse,
                                             causal, sc)
    _close_tiles(dk, dk_r, tol)
    _close_tiles(dv, dv_r, tol)
    size = (do.float() * o.float()).abs().sum(-1)
    if dlse is not None:
        size = size + dlse.abs()
    assert bool(((delta - delta_r).abs() <= 2e-5 * size).all())
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc)
    _close_tiles(dq, fa._bwd_dq_plain(q, k, v, do, lse, delta, causal, sc),
                 tol)
    after = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dkdv,
                                  fa.flash_bwd_dq)]
    assert after == [n + 1 for n in before]


def test_flash_attention_grads_on_the_card(dev):
    """The autograd path (kernels 4–6) against autograd of the plain
    reference, bf16, causal."""
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((2, 4, 256, 64), generator=g, device=dev)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))

    def grads(f):
        out = f(q, k, v)
        return torch.autograd.grad(torch.sin(out.float()).sum(), (q, k, v))

    from horovod_tpu_torch.parallel.ring_attention import (
        blockwise_attention_reference as ref)
    for a, b in zip(grads(lambda *t: ref(*(x.float() for x in t))),
                    grads(fa.flash_attention)):
        _close(b, a, 2.0 ** -5)


@pytest.mark.parametrize("dtype,dh,causal,with_dlse", [
    (torch.bfloat16, 320, True, False), (torch.bfloat16, 512, False, False),
    (torch.float32, 320, True, True)])
def test_flash_refuses_a_head_dim_without_instance(dev, dtype, dh, causal,
                                                   with_dlse):
    """No head dim lacks an instance now: above 256 the kernels take the
    wide path (dh zero-padded to a multiple of 256, outputs in 256-wide
    windows), and it matches the plain versions tile by tile."""
    assert fa._instance(dh) == 512
    g = torch.Generator(device=dev).manual_seed(dh)
    bh, s = 2, 200
    q, k, v, do = (torch.randn((bh, s, dh), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    dlse = (0.1 * torch.randn((bh, s), generator=g, device=dev)
            if with_dlse else None)
    sc = dh ** -0.5
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -9
    o, lse = fa.flash_fwd(q, k, v, causal, sc)
    o_r, lse_r = fa._fwd_plain(q, k, v, causal, sc)
    _close_tiles(o, o_r, tol)
    assert float((lse - lse_r).abs().max()) <= 2e-3
    dk, dv, delta = fa.flash_bwd_dkdv(q, k, v, o, do, lse, dlse, causal, sc)
    dk_r, dv_r, _ = fa._bwd_dkdv_plain(q, k, v, o, do, lse, dlse, causal,
                                       sc)
    _close_tiles(dk, dk_r, tol)
    _close_tiles(dv, dv_r, tol)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc)
    _close_tiles(dq, fa._bwd_dq_plain(q, k, v, do, lse, delta, causal, sc),
                 tol)


# ---------------------------------------------------------------- Hopper
# instances of kernels 1 and 6

RESNET50_SITES = sorted({(m, cin, c) for _, _, m, cin, c in
                         resnet.fused_sites(50, 32, 224)})


def _fwd_site(m, cin, c, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, cin), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((cin, c), generator=g, device=dev)
         * cin ** -0.5).to(torch.bfloat16)
    return x, w


@pytest.mark.parametrize("m,cin,c", RESNET50_SITES + [(6271, 256, 1024),
                                                      (6271, 64, 200)])
def test_fwd_hopper_matches_plain(dev, m, cin, c):
    """Kernel 1's Hopper instance: y within one bf16 step (2^-7) of the
    largest value, Σy within 1e-3 of Σ|y| and Σy² within 1e-3 relative,
    per channel (chip_smoke's TOL_BF16 and TOL_SUMS)."""
    assert cb.fwd_instance(m, cin, c, torch.bfloat16) == "hopper"
    x, w = _fwd_site(m, cin, c, dev, seed=m + c)
    before = cb.conv1x1_fwd_fused.launches
    y, s, q = cb.conv1x1_fwd_fused(x, w)
    assert cb.conv1x1_fwd_fused.launches == before + 1
    yr, sr, qr = cb._fwd_plain(x, w)
    _close(y, yr, 2.0 ** -7)
    assert float(((s - sr).abs() / yr.float().abs().sum(0)).max()) <= 1e-3
    assert float(((q - qr).abs() / qr.abs()).max()) <= 1e-3


@pytest.mark.parametrize("m,cin,c", [(6272, 1024, 512), (100352, 64, 256),
                                     (6271, 256, 1024)])
def test_fwd_hopper_is_bitwise_repeatable(dev, m, cin, c):
    """Every sum of kernel 1's Hopper instance runs in a fixed order (a
    job's slices, then the row tiles in one column-sum launch): two
    launches give the same y, Σy and Σy² bits."""
    x, w = _fwd_site(m, cin, c, dev, seed=5)
    a, b = cb.conv1x1_fwd_fused(x, w), cb.conv1x1_fwd_fused(x, w)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


DQ_HOPPER = [  # (BH, Sq, Sk, dh, causal, with dlse), bf16
    (8, 1024, 1024, 128, True, False), (8, 1024, 1024, 128, False, False),
    (8, 1000, 1000, 128, True, False), (8, 1100, 1100, 64, True, True),
    (8, 512, 1024, 64, False, True), (8, 1100, 700, 32, False, False),
    (8, 1000, 1000, 32, True, True), (8, 256, 256, 80, True, False),
    (8, 1024, 1024, 80, False, True),
]


def _dq_inputs(bh, sq, sk, dh, with_dlse, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((bh, sq, dh), generator=g, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((bh, sk, dh), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    dlse = (0.1 * torch.randn((bh, sq), generator=g, device=dev)
            if with_dlse else None)
    return q, k, v, do, dlse


@pytest.mark.parametrize("bh,sq,sk,dh,causal,with_dlse", DQ_HOPPER)
def test_dq_hopper_matches_plain(dev, bh, sq, sk, dh, causal, with_dlse):
    """Kernel 6's Hopper instance against `_bwd_dq_plain` fed the same
    lse and delta (kernels 4 and 5's), every 64-row tile within 2^-7 of
    the reference tile's norm."""
    assert fa.flash_instance(torch.bfloat16, dh) == "hopper"
    q, k, v, do, dlse = _dq_inputs(bh, sq, sk, dh, with_dlse, dev, sq + dh)
    sc = dh ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal, sc)
    _, _, delta = fa.flash_bwd_dkdv(q, k, v, o, do, lse, dlse, causal, sc)
    before = fa.flash_bwd_dq.launches
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc)
    assert fa.flash_bwd_dq.launches == before + 1
    assert bool(torch.isfinite(dq.float()).all())
    _close_tiles(dq, fa._bwd_dq_plain(q, k, v, do, lse, delta, causal, sc),
                 2.0 ** -7)


def test_dq_hopper_is_bitwise_repeatable(dev):
    """Each block of kernel 6 owns its dq rows and sums in a fixed order:
    two launches give the same bits."""
    q, k, v, do, _ = _dq_inputs(16, 1024, 1024, 128, False, dev, 11)
    sc = 128 ** -0.5
    o, lse = fa.flash_fwd(q, k, v, True, sc)
    _, _, delta = fa.flash_bwd_dkdv(q, k, v, o, do, lse, None, True, sc)
    a = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, sc)
    b = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, sc)
    assert torch.equal(a, b)


def test_kernels_launch_on_their_tensors_card(dev):
    """Every wrapper launches on its tensors' card, not the current one:
    with cuda:0 current and the tensors on cuda:1, kernels 1-6 (Hopper
    instances, bf16) agree with their plain versions, and cuda:0 stays
    current. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    d1 = torch.device("cuda", 1)
    m, cin, c = 6272, 1024, 256
    assert cbb.bwd_instance(m, cin, c, torch.bfloat16) == "hopper"
    x, w, scale, bias, dz = _inputs(m, cin, c, d1, seed=5)
    y, s, q = cb.conv1x1_fwd_fused(x, w)
    yr, sr, qr = cb._fwd_plain(x, w)
    _close(y, yr, 2.0 ** -7)
    assert float(((q - qr).abs() / qr.abs()).max()) <= 1e-3
    mean = sr / m
    inv = torch.rsqrt(qr / m - mean.square() + 1e-5)
    db, dg = cb._bn_act_sums(dz, yr, mean, inv, scale, bias, True)
    dx, dw = cb.conv1x1_bn_act_bwd_fused(dz, yr, x, w, scale, bias, mean,
                                         inv, db, dg)
    g, a, b = cbb.fold_rows(scale.float(), inv, db, dg, None, None, m)
    dxr, dwr = cbb._bwd_plain(dz, yr, x, w, g, mean, inv, a, b,
                              scale.float(), bias.float())
    _close(dx, dxr, 2.0 ** -7)
    _close(dw, dwr, 1e-3)
    db, dg = cb._bn_act_sums(dz, yr, mean, inv, scale, bias, False)
    dx3, dw3 = cbb.conv1x1_bn_bwd_fused(dz, yr, x, w, scale.float(), mean,
                                        inv, db, dg)
    g, a, b = cbb.fold_rows(scale.float(), inv, db, dg, None, None, m)
    dxr, dwr = cbb._bwd_plain(dz, yr, x, w, g, mean, inv, a, b,
                              torch.zeros_like(inv), torch.ones_like(inv))
    _close(dx3, dxr, 2.0 ** -7)
    _close(dw3, dwr, 1e-3)
    bh, S, dh = 4, 256, 128
    assert fa.flash_instance(torch.bfloat16, dh) == "hopper"
    qq, kk, vv, do, _ = _dq_inputs(bh, S, S, dh, False, d1, 12)
    sc = dh ** -0.5
    o, lse = fa.flash_fwd(qq, kk, vv, True, sc)
    _close_tiles(o, fa._fwd_plain(qq, kk, vv, True, sc)[0], 2.0 ** -7)
    dk, dv, delta = fa.flash_bwd_dkdv(qq, kk, vv, o, do, lse, None, True, sc)
    dk_r, dv_r, _ = fa._bwd_dkdv_plain(qq, kk, vv, o, do, lse, None, True,
                                       sc)
    _close_tiles(dk, dk_r, 2.0 ** -7)
    _close_tiles(dv, dv_r, 2.0 ** -7)
    dq = fa.flash_bwd_dq(qq, kk, vv, do, lse, delta, True, sc)
    _close_tiles(dq, fa._bwd_dq_plain(qq, kk, vv, do, lse, delta, True, sc),
                 2.0 ** -7)
    torch.cuda.synchronize(d1)
    assert torch.cuda.current_device() == 0


KERNEL_WRAPPERS = ["conv1x1_fwd_fused", "conv1x1_bn_act_bwd_fused",
                   "conv1x1_bn_bwd_fused", "flash_fwd", "flash_bwd_dkdv",
                   "flash_bwd_dq"]


@pytest.mark.parametrize("kname", KERNEL_WRAPPERS)
def test_a_recorded_wrapper_call_is_one_kernel_op(dev, kname):
    """Under the step recorder (analysis/graph.py) one wrapper call on
    the card is one custom_call op named after its kernel, with an f32
    accumulator; with no recorder the wrapper reports nothing."""
    from horovod_tpu_torch import kernels
    from horovod_tpu_torch.analysis import graph
    m, cin, c = 512, 64, 128
    x, w, scale, bias, dz = _inputs(m, cin, c, dev)
    y, s1, s2 = cb.conv1x1_fwd_fused(x, w)
    mean = s1 / m
    inv = torch.rsqrt(s2 / m - mean.square() + 1e-5)
    db, dg = cb._bn_act_sums(dz, y, mean, inv, scale, bias, True)
    q, k, v, do, _ = _dq_inputs(4, 256, 256, 64, False, dev, 3)
    sc = 64 ** -0.5
    o, lse = fa.flash_fwd(q, k, v, True, sc)
    _, _, delta = fa.flash_bwd_dkdv(q, k, v, o, do, lse, None, True, sc)
    calls = {
        "conv1x1_fwd_fused": lambda: cb.conv1x1_fwd_fused(x, w),
        "conv1x1_bn_act_bwd_fused": lambda: cb.conv1x1_bn_act_bwd_fused(
            dz, y, x, w, scale, bias, mean, inv, db, dg),
        "conv1x1_bn_bwd_fused": lambda: cbb.conv1x1_bn_bwd_fused(
            dz, y, x, w, scale.float(), mean, inv, db, dg),
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, True, sc),
        "flash_bwd_dkdv": lambda: fa.flash_bwd_dkdv(q, k, v, o, do, lse,
                                                    None, True, sc),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                True, sc),
    }
    _, prog = graph.record(calls[kname])
    ops = [op for op in prog.ops if op.opcode == "custom_call"]
    assert len(ops) == 1
    assert f'custom_call_target="{kname}"' in ops[0].attrs
    assert "accumulation_type=f32" in ops[0].attrs and ops[0].operands
    assert kernels.op_hook is None
    calls[kname]()  # and with none active, nothing to report to
    torch.cuda.synchronize(dev)
