"""The PyTorch port's CUDA kernels against their plain versions, on the
card. A CUDA kernel has no CPU mode, so these tests skip on a host
without a GPU; run them there with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

(--noconftest: tests/conftest.py sets up JAX, which a GPU host running
only the port need not have; this file imports no JAX.)

Tolerances as chip_smoke.py states them: bf16 outputs within one bf16
step (2^-7) of the largest value, f32 sums and dW within 1e-3.
"""

import pytest
import torch

from horovod_tpu_torch.ops import conv_block as cb
from horovod_tpu_torch.ops import conv_bn_backward as cbb

pytestmark = pytest.mark.cuda

SHAPES = [(256, 32, 48), (250, 16, 64), (1001, 24, 50), (4096, 256, 512)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(m, cin, c, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
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
