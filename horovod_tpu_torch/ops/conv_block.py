"""Fused 1x1-conv + BatchNorm + ReLU block (counterpart of
horovod_tpu/ops/conv_block.py).

`conv1x1_bn_act` is z = relu(BN(x @ w)) over flattened rows, train mode
(`relu=False` drops the activation), through two hand-written kernels:
  * kernel 1, `conv1x1_fwd_fused` (csrc/conv1x1_fwd.cu; replaces the
    Pallas conv_block.py `_fwd_kernel`): y = x @ w and, in the same
    pass, the per-channel f32 Σy and Σy² of the stored (rounded) y; in
    bf16 at the shapes `fwd_instance` names (every ResNet-50 site) its
    Hopper instance (csrc/conv1x1_fwd_hopper.cuh), else the simple one;
  * kernel 2, `conv1x1_bn_act_bwd_fused` (csrc/conv1x1_bn_act_bwd.cu;
    replaces conv_block.py `_bwd_kernel`): the ReLU mask recomputed from
    y and the stats, the BN backward and both products, dy never stored.
The BN epilogue between them runs in f32 and rounds once, at z; the
mask reruns that exact chain, so its sign decisions equal the
forward's.

Beside each kernel: its plain PyTorch version (`_fwd_plain`,
conv_bn_backward._bwd_plain), which a CPU tensor takes and the card
checks compare against, and its launch counter (`.launches` on the
wrapper). A CUDA tensor always launches the kernel, or raises. The
kernels' source notes say what bounds them on the H100.

HOROVOD_CONV_BLOCK=1 routes models/resnet.py's 1x1 sites through this
family.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import torch

from horovod_tpu_torch import kernels
from horovod_tpu_torch.common.exceptions import KernelError
from horovod_tpu_torch.ops.conv_bn_backward import (
    _SM_COUNT, _bwd_plain, _ptr, _stream, check_cuda_args, entry, fold_rows,
    fold_rows_cuda, group_size, group_sum, launch_bwd)

CONV_BLOCK_ENV = "HOROVOD_CONV_BLOCK"


def conv_block_enabled() -> bool:
    """HOROVOD_CONV_BLOCK=1 opts the model into the fused block family."""
    return os.environ.get(CONV_BLOCK_ENV, "").strip() in ("1", "true",
                                                          "True")


# --------------------------------------------------------------------------
# reference
# --------------------------------------------------------------------------

def conv_block_reference(x, w, scale, bias, eps=1e-5, relu=True):
    """Plain PyTorch math of the block over rows: (z, (mean, var)), the
    contract the fused op must match (no sync-BN)."""
    y = torch.matmul(x.float(), w.float()).to(x.dtype)
    yf = y.float()
    mean = yf.mean(0)
    var = yf.square().mean(0) - mean.square()
    inv = torch.rsqrt(var + eps)
    zf = ((yf - mean) * inv) * scale.float() + bias.float()
    if relu:
        zf = torch.relu(zf)
    return zf.to(x.dtype), (mean, var)


# --------------------------------------------------------------------------
# kernel 1
# --------------------------------------------------------------------------

def _fwd_plain(x, w):
    """Plain version of kernel 1: f32 product rounded to x.dtype, and the
    f32 sums of the rounded y."""
    y = torch.matmul(x.float(), w.float()).to(x.dtype)
    ys = y.float()
    return y, ys.sum(0), ys.square().sum(0)


def fwd_instance(m: int, cin: int, c: int, dtype: torch.dtype) -> str:
    """Which instance of kernel 1 runs (m, cin, c) in `dtype`: "hopper"
    (TMA rings, wgmma with w read in place, TMA stores of y) for bf16
    with Cin and C multiples of 8 (TMA's 16-byte stride rule) between 64
    and 1024, which every ResNet-50 site is; else "simple" (mma.sync on
    a transposed copy of w): f32, whose tf32 wgmma needs K-major
    operands where w is MN-major, and every other shape. A function of
    shape and dtype alone: a launch or build that fails raises, it never
    picks the other instance."""
    del m  # any M: TMA fills the ragged row edge with zeros
    if (dtype == torch.bfloat16 and cin % 8 == 0 and c % 8 == 0
            and 64 <= cin <= 1024 and 64 <= c <= 1024):
        return "hopper"
    return "simple"


FWD_ROWS = 128  # rows of a Hopper job (two warpgroups of 64)


def fwd_tile(m: int, cin: int, c: int) -> int:
    """The column width BN of a Hopper job of kernel 1 (its wgmma N):
    the smallest of 64, 128, 256 that holds C (256 above), so that x is
    read once for C <= 256; halved while the jobs (128-row tiles x column
    tiles) would not give every SM one (the M 6272 sites): idle SMs cost
    more there than re-reading x from L2."""
    del cin
    bn = 64 if c <= 64 else 128 if c <= 128 else 256
    while (bn > 64
           and math.ceil(m / FWD_ROWS) * math.ceil(c / bn) < _SM_COUNT):
        bn //= 2
    return bn


@kernels.kernel_op("conv1x1_fwd_fused")
def conv1x1_fwd_fused(x: torch.Tensor, w: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y = x @ w plus the per-channel (sum, sumsq) f32 rows of the stored
    y. x: (M, Cin); w: (Cin, C). Returns (y (M, C) in x.dtype,
    sum (C,) f32, sumsq (C,) f32)."""
    if x.device.type == "cpu":
        return _fwd_plain(x, w)
    m, cin = x.shape
    c = w.shape[1]
    if w.shape[0] != cin:
        raise ValueError(f"conv1x1_fwd_fused: x {tuple(x.shape)} and "
                         f"w {tuple(w.shape)} disagree")
    nmb = math.ceil(m / FWD_ROWS)
    if fwd_instance(m, cin, c, x.dtype) == "hopper":
        w = w.contiguous()  # read in place: no copy for a (Cin, C) weight
        check_cuda_args("conv1x1_fwd_fused", (x, w), ())
        if x.data_ptr() % 16 or w.data_ptr() % 16:
            raise KernelError("conv1x1_fwd_fused: the TMA loads need x and "
                              "w on 16-byte boundaries")
        y = torch.empty((m, c), dtype=x.dtype, device=x.device)
        ws = torch.empty((nmb, 2, c), dtype=torch.float32, device=x.device)
        stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
        fn = entry("conv1x1_fwd", "hvd_conv1x1_fwd_hopper", 5, 4)
        kernels.launch(fn, "conv1x1_fwd_fused", x.device,
                       *[_ptr(t) for t in (x, w, y, ws, stats)], m, cin, c,
                       fwd_tile(m, cin, c), _stream(x))
        conv1x1_fwd_fused.launches += 1
        return y, stats[0], stats[1]
    wt = w.t().contiguous()  # (C, Cin): both operands load along Cin
    suffix = check_cuda_args("conv1x1_fwd_fused", (x, wt), ())
    y = torch.empty((m, c), dtype=x.dtype, device=x.device)
    ws = torch.empty((2, nmb, c), dtype=torch.float32, device=x.device)
    ssum = torch.empty((c,), dtype=torch.float32, device=x.device)
    ssq = torch.empty((c,), dtype=torch.float32, device=x.device)
    fn = entry("conv1x1_fwd", f"hvd_conv1x1_fwd_{suffix}", 6, 3)
    kernels.launch(fn, "conv1x1_fwd_fused", x.device,
                   *[_ptr(t) for t in (x, wt, y, ws, ssum, ssq)], m, cin, c,
                   _stream(x))
    conv1x1_fwd_fused.launches += 1
    return y, ssum, ssq


conv1x1_fwd_fused.launches = 0


# --------------------------------------------------------------------------
# kernel 2
# --------------------------------------------------------------------------

@kernels.kernel_op("conv1x1_bn_act_bwd_fused")
def conv1x1_bn_act_bwd_fused(dz, y, x_in, w, scale, bias, mean, inv, dbeta,
                             dgamma, dmean=None, dvar=None, count=None,
                             relu: bool = True):
    """dx, dW of a 1x1 conv + train-mode BN + optional ReLU, given dz
    w.r.t. the block output and the masked sums of `_bn_act_sums`.

    dz, y: (M, C); x_in: (M, Cin); w: (Cin, C); mean, inv, dbeta, dgamma:
    (C,) f32; scale, bias: (C,) in the model dtype. dmean/dvar: optional
    (C,) f32 cotangents of the batch stats; count: rows behind the stats
    (M·world under sync-BN). Returns dx (M, Cin) in x_in.dtype and dW
    (Cin, C) f32."""
    m = dz.shape[0]
    count = count if count is not None else m
    if dz.device.type == "cpu":
        scale32 = scale.float()
        g, a, b = fold_rows(scale32, inv, dbeta, dgamma, dmean, dvar, count)
        if relu:  # the mask reruns the forward's f32 epilogue
            s_row, b_row = scale32, bias.float()
        else:  # mask all-true: xhat·0 + 1 > 0 everywhere
            s_row = torch.zeros_like(scale32)
            b_row = torch.ones_like(scale32)
        return _bwd_plain(dz, y, x_in, w, g, mean, inv, a, b, s_row, b_row)
    # The same rows in one launch on the card.
    g, a, b, s_row, b_row = fold_rows_cuda(
        "conv1x1_bn_act_bwd", "hvd_conv1x1_bn_act_fold_rows", scale, bias,
        inv, dbeta, dgamma, dmean, dvar, count, relu).unbind(0)
    rows = [r.float().contiguous() for r in (g, mean, inv, a, b, s_row,
                                             b_row)]
    out = launch_bwd("conv1x1_bn_act_bwd", "hvd_conv1x1_bn_act_bwd", dz, y,
                     x_in, w, rows)
    conv1x1_bn_act_bwd_fused.launches += 1
    return out


conv1x1_bn_act_bwd_fused.launches = 0


# --------------------------------------------------------------------------
# autograd Function: the model-facing fused block
# --------------------------------------------------------------------------

def _bn_act_sums(dz, y, mean, inv, scale, bias, relu):
    """The masked BN-backward sums: dbeta = Σdz·mask, dgamma =
    Σdz·mask·x̂, the mask rerunning the forward's f32 chain."""
    dzf = dz.float()
    xhat = (y.float() - mean) * inv
    if relu:
        zpre = xhat * scale.float() + bias.float()
        dzf = torch.where(zpre > 0.0, dzf, 0.0)
    return dzf.sum(0), (dzf * xhat).sum(0)


def _fwd_math(x, w, scale, bias, eps, group, relu):
    y, ssum, ssq = conv1x1_fwd_fused(x, w)
    m = x.shape[0]
    mean, meansq = group_sum((ssum / m, ssq / m), group)
    k = group_size(group)
    if k != 1:
        mean, meansq = mean / k, meansq / k
    var = meansq - mean.square()
    inv = torch.rsqrt(var + eps)
    # f32 epilogue, one final rounding: the chain the mask recomputes.
    zf = ((y.float() - mean) * inv) * scale.float() + bias.float()
    if relu:
        zf = torch.relu(zf)
    return zf.to(x.dtype), y, mean, var, inv


class _Conv1x1BNAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, scale, bias, eps, group, relu):
        z, y, mean, var, inv = _fwd_math(x, w, scale, bias, eps, group,
                                         relu)
        ctx.save_for_backward(x, w, scale, bias, y, mean, inv)
        ctx.group, ctx.relu = group, relu
        ctx.set_materialize_grads(False)
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, dmean, dvar):
        x, w, scale, bias, y, mean, inv = ctx.saved_tensors
        group, relu = ctx.group, ctx.relu
        if dz is None:
            dz = torch.zeros_like(y)
        dz = dz.contiguous()
        dbeta, dgamma = _bn_act_sums(dz, y, mean, inv, scale, bias, relu)
        if group is not None:
            zero = torch.zeros_like(dbeta)
            db_g, dg_g, dm_g, dv_g = group_sum(
                (dbeta, dgamma, zero if dmean is None else dmean,
                 zero if dvar is None else dvar), group)
        else:
            db_g, dg_g, dm_g, dv_g = dbeta, dgamma, dmean, dvar
        dx, dw = conv1x1_bn_act_bwd_fused(
            dz, y, x, w, scale, bias, mean, inv, db_g, dg_g, dmean=dm_g,
            dvar=dv_g, count=dz.shape[0] * group_size(group), relu=relu)
        return (dx, dw.to(w.dtype), dgamma.to(scale.dtype),
                dbeta.to(bias.dtype), None, None, None)


def conv1x1_bn_act(x, w, scale, bias, eps: float = 1e-5, group=None,
                   relu: bool = True):
    """z = relu(BN(x @ w)) over rows, train mode, forward through kernel
    1 and backward through kernel 2. With `group`, batch stats sync
    across that process group. Returns (z, (batch_mean, batch_var))."""
    z, mean, var = _Conv1x1BNAct.apply(x, w, scale, bias, eps, group, relu)
    return z, (mean, var)


def conv1x1_bn_relu(x, w, scale, bias, eps: float = 1e-5, group=None):
    return conv1x1_bn_act(x, w, scale, bias, eps, group, True)


def conv1x1_bn_act_nhwc(x, w, scale, bias, eps: float = 1e-5, group=None,
                        relu: bool = True):
    """x (N, H, W, Cin) contiguous, w (Cin, C). Returns (z NHWC, stats)."""
    n, h, wd, cin = x.shape
    z, stats = conv1x1_bn_act(x.reshape(n * h * wd, cin), w, scale, bias,
                              eps, group, relu)
    return z.reshape(n, h, wd, -1), stats
