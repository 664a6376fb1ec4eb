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
"""

import pytest
import torch

from horovod_tpu_torch.ops import conv_block as cb
from horovod_tpu_torch.common.exceptions import KernelError
from horovod_tpu_torch.ops import conv_bn_backward as cbb
from horovod_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

SHAPES = [(256, 32, 48), (250, 16, 64), (1001, 24, 50), (4096, 256, 512)]


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
@pytest.mark.parametrize("m,cin,c", SHAPES)
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


def test_flash_refuses_a_head_dim_without_instance(dev):
    q = torch.zeros((2, 64, 300), device=dev, dtype=torch.bfloat16)
    with pytest.raises(KernelError, match="256"):
        fa.flash_fwd(q, q, q, True, 0.1)
