"""Fused 1x1-conv + BatchNorm backward (counterpart of
horovod_tpu/ops/conv_bn_backward.py).

`conv1x1_bn` is z = BN(x @ w) over flattened rows, train mode: the
forward is plain PyTorch, the backward runs kernel 3,
`conv1x1_bn_bwd_fused`, which forms the BN-backward gradient dy in
registers and feeds it straight into both products (dx = dy @ wᵀ,
dW = xᵀ @ dy), so dy never reaches device memory.

Kernel 3 is csrc/conv1x1_bn_bwd.cu (CUDA C++ for sm_90a; it replaces the
Pallas kernel conv_bn_backward.py `_bwd_kernel`). Its source note says
what bounds it on the H100 and how its design answers that. Beside it
here: `_bwd_plain`, the same function in plain PyTorch, which a CPU
tensor takes and which the card checks compare against; and the launch
counter `conv1x1_bn_bwd_fused.launches`. A CUDA tensor always launches
the kernel, or raises. bf16 and f32 are both kernel types: bf16 at the
shapes `bwd_instance` names runs the Hopper instance (wgmma, TMA rings,
dW split-K through thread-block clusters); f32 runs the tf32 instance
(mma.sync m16n8k8), never a cast down to bf16.

This module also holds what ops/conv_block.py shares with it, as in the
JAX package: the folding of the per-channel rows, the plain backward
and the CUDA backward launcher.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import kernels
from horovod_tpu_torch.common.exceptions import KernelError

_SM_COUNT = 132  # H100 SXM


# --------------------------------------------------------------------------
# helpers shared with conv_block
# --------------------------------------------------------------------------

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_sum(rows: Sequence[torch.Tensor], group) -> Tuple[torch.Tensor, ...]:
    """Sum each (C,) f32 row across `group`, in one all_reduce of the
    stacked rows (identity for None)."""
    if group is None:
        return tuple(rows)
    both = torch.stack(list(rows))
    from horovod_tpu_torch.ops.sync_batch_norm import _all_reduce
    _all_reduce(both, group)
    return tuple(both.unbind(0))


def fold_rows(scale32, inv, dbeta, dgamma, dmean, dvar, count):
    """The per-channel rows of dy = g·dz − a − b·x̂ (JAX order):
    g = scale·inv, a = g·dbeta/M − dmean/M, b = g·dgamma/M − 2·dvar/(M·inv).
    A None cotangent is zero."""
    minv = 1.0 / count
    g = scale32 * inv
    a = g * dbeta * minv
    b = g * dgamma * minv
    if dmean is not None:
        a = a - dmean * minv
    if dvar is not None:
        b = b - 2.0 * dvar * minv / inv
    return g, a, b


def _bwd_plain(dz, y, x_in, w, g, mean, inv, a, b, s=None, bias=None):
    """Plain PyTorch version of kernels 2 (with s, bias) and 3: dy in
    f32, masked where xhat·s + bias <= 0, rounded to dz.dtype before both
    products; f32 products; dx in x_in.dtype, dW in f32."""
    dzf = dz.float()
    xhat = (y.float() - mean) * inv
    if s is not None:
        dzf = torch.where(xhat * s + bias > 0.0, dzf, 0.0)
    dy = (g * dzf - a - b * xhat).to(dz.dtype).float()
    dx = torch.matmul(dy, w.float().t()).to(x_in.dtype)
    dw = torch.matmul(x_in.float().t(), dy)
    return dx, dw


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def check_cuda_args(what: str, mats: Sequence[torch.Tensor],
                    rows: Sequence[torch.Tensor]) -> str:
    """The kernels take contiguous matrices of one dtype, bf16 or f32 (f32
    runs the tf32 instance), and contiguous f32 rows, all on one CUDA
    device. Returns the C entry point's dtype suffix."""
    dev, dtype = mats[0].device, mats[0].dtype
    for t in (*mats, *rows):
        if t.device.type != "cuda":
            raise KernelError(f"{what}: takes CUDA tensors, got a tensor on "
                              f"{t.device}")
    if dtype not in _SUFFIX:
        raise KernelError(f"{what}: takes bfloat16 or float32 matrices, "
                          f"got {dtype}")
    for t in mats:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise KernelError(
                f"{what}: takes contiguous {dtype} matrices on one device, "
                f"got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    for r in rows:
        if r.device != dev or r.dtype != torch.float32 \
                or not r.is_contiguous():
            raise KernelError(f"{what}: per-channel rows must be contiguous "
                              f"float32 on {dev}")
    return _SUFFIX[dtype]


def dw_splits(m: int, cin: int, c: int) -> Tuple[int, int]:
    """(splits, chunk) for the simple dW pass: enough (Cin, C)-tile x
    M-split blocks for two waves over the SMs; chunk is a multiple of 32
    rows."""
    tiles = math.ceil(cin / 128) * math.ceil(c / 128)
    want = max(1, math.ceil(2 * _SM_COUNT / tiles))
    chunk = 32 * math.ceil(math.ceil(m / want) / 32)
    return math.ceil(m / chunk), chunk


# The Hopper instances (csrc/conv1x1_bwd_hopper.cuh): dW split over M in
# thread-block clusters of HOPPER_CLUSTER blocks, at most HOPPER_WAVE
# blocks for the tiles that one wave covers.
HOPPER_CLUSTER = 8
HOPPER_WAVE = 128


def bwd_instance(m: int, cin: int, c: int, dtype: torch.dtype) -> str:
    """Which instance of kernels 2 and 3 runs (m, cin, c) in `dtype`:
    "hopper" (wgmma, TMA, clusters) for bf16 with Cin and C multiples of
    8 (TMA's 16-byte stride rule) between 64 and 1024 (the per-channel
    rows of up to 1024 channels stay in shared memory), which every
    ResNet-50 site is; else "simple" (mma.sync): f32, whose tf32 wgmma
    needs K-major operands where both dW operands are MN-major, and
    every other shape. A function of shape and dtype alone: a launch or
    build that fails raises, it never picks the other instance."""
    del m  # any M: TMA fills the ragged row edge with zeros
    if (dtype == torch.bfloat16 and cin % 8 == 0 and c % 8 == 0
            and 64 <= cin <= 1024 and 64 <= c <= 1024):
        return "hopper"
    return "simple"


def hopper_tiles(m: int, cin: int, c: int) -> Tuple[int, int, int]:
    """(NB, CT, NT): the Cin width of a dx tile (the wgmma N) and the
    (Cin, C) tile of dW, the smallest instances that hold Cin and C, up
    to 256 and 128; but dx takes 128-wide tiles where 256-wide ones give
    fewer jobs (128-row tiles x Cin tiles) than two waves over the SMs,
    as at M 6272: forming dy twice as often costs less there than idle
    SMs (measured on an H100)."""
    ct = 64 if cin <= 64 else 128 if cin <= 128 else 256
    nb = ct
    if nb == 256 and math.ceil(m / 128) * math.ceil(cin / 256) \
            < 2 * _SM_COUNT:
        nb = 128
    return nb, ct, 64 if c <= 64 else 128


def hopper_dw_plan(m: int, cin: int, c: int) -> Tuple[int, int]:
    """(clusters, chunk) of the Hopper dW pass: each dW tile is split over
    M into clusters x HOPPER_CLUSTER blocks of `chunk` rows (a multiple
    of 64, the ring step), in order: block s takes rows
    [s·chunk, (s+1)·chunk). tiles x clusters <= HOPPER_WAVE /
    HOPPER_CLUSTER (or clusters is 1), so the f32 workspace that holds
    the clusters' sums when clusters > 1 is at most that many tiles."""
    _, ct, nt = hopper_tiles(m, cin, c)
    tiles = math.ceil(cin / ct) * math.ceil(c / nt)
    clusters = max(1, HOPPER_WAVE // HOPPER_CLUSTER // tiles)
    splits = clusters * HOPPER_CLUSTER
    chunk = 64 * max(1, math.ceil(m / splits / 64))
    clusters = max(1, math.ceil(math.ceil(m / chunk) / HOPPER_CLUSTER))
    return clusters, chunk


_ENTRIES = {}


def entry(lib_name: str, name: str, n_ptr: int, n_int: int, tail=()):
    """The C entry point `name` of `csrc/<lib_name>.cu`, its argument
    types set once: n_ptr pointers, n_int ints, the ctypes types in
    `tail`, then the stream."""
    fn = _ENTRIES.get((lib_name, name))
    if fn is None:
        fn = getattr(kernels.lib(lib_name), name)
        fn.argtypes = ([kernels.P] * n_ptr + [kernels.I] * n_int + list(tail)
                       + [kernels.P])
        fn.restype = ctypes.c_int
        _ENTRIES[(lib_name, name)] = fn
    return fn


def fold_rows_cuda(lib_name: str, fn_name: str, scale, bias, inv, dbeta,
                   dgamma, dmean, dvar, count, relu: bool):
    """fold_rows on the card in one launch (csrc/conv1x1_gemm.cuh
    fold_kernel, the entry point `fn_name` of `lib_name`), with the mask's
    rows: returns the (5, C) f32 rows g, a, b, s, bias, where s, bias are
    scale, bias (relu) or 0, 1. scale and bias are bf16 or f32 of one
    dtype, the rest f32; dmean, dvar and bias may be None."""
    c = inv.shape[0]
    bias = scale if bias is None else bias
    if scale.dtype not in _SUFFIX or bias.dtype != scale.dtype:
        raise KernelError(f"{fn_name}: scale and bias must be bfloat16 or "
                          f"float32 of one dtype, got {scale.dtype}, "
                          f"{bias.dtype}")
    params = [r.contiguous() for r in (scale, bias)]
    rows = [r.float().contiguous() for r in (inv, dbeta, dgamma)]
    opt = [None if r is None else r.float().contiguous()
           for r in (dmean, dvar)]
    check_cuda_args(fn_name, params, rows + [r for r in opt
                                             if r is not None])
    out = torch.empty((5, c), dtype=torch.float32, device=inv.device)
    fn = entry(lib_name, fn_name, 8, 1, (ctypes.c_float, kernels.I,
                                         kernels.I))
    kernels.launch(fn, fn_name, inv.device,
                   *[_ptr(r) for r in params + rows],
                   *[ctypes.c_void_p(None if r is None else r.data_ptr())
                     for r in opt], _ptr(out), c, 1.0 / count, int(relu),
                   int(scale.dtype == torch.bfloat16), _stream(inv))
    return out


def launch_bwd(lib_name: str, fn_name: str, dz, y, x_in, w,
               rows: Sequence[torch.Tensor]):
    """Run a backward kernel (2 or 3) on the card: the C entry point
    `fn_name` plus the instance's suffix (`bwd_instance`). Returns (dx,
    dW f32)."""
    suffix = check_cuda_args(fn_name, (dz, y, x_in, w), rows)
    m, c = dz.shape
    cin = x_in.shape[1]
    if y.shape != (m, c) or x_in.shape[0] != m or w.shape != (cin, c):
        raise KernelError(f"{fn_name}: shapes dz {tuple(dz.shape)} "
                          f"y {tuple(y.shape)} x {tuple(x_in.shape)} "
                          f"w {tuple(w.shape)} disagree")
    dev = dz.device
    dx = torch.empty((m, cin), dtype=x_in.dtype, device=dev)
    dw = torch.empty((cin, c), dtype=torch.float32, device=dev)
    if bwd_instance(m, cin, c, dz.dtype) == "hopper":
        if any(t.data_ptr() % 16 for t in (dz, y, x_in, w)):
            raise KernelError(f"{fn_name}: the TMA loads need dz, y, x and "
                              f"w on 16-byte boundaries")
        clusters, chunk = hopper_dw_plan(m, cin, c)
        ws = torch.empty((clusters if clusters > 1 else 0, cin, c),
                         dtype=torch.float32, device=dev)
        ints = (m, cin, c, *hopper_tiles(m, cin, c), clusters, chunk)
        suffix = "hopper"
    else:
        splits, chunk = dw_splits(m, cin, c)
        ws = torch.empty((splits, cin, c), dtype=torch.float32, device=dev)
        ints = (m, cin, c, splits, chunk)
    fn = entry(lib_name, f"{fn_name}_{suffix}", 4 + len(rows) + 3,
               len(ints))
    kernels.launch(fn, fn_name, dev,
                   *[_ptr(t) for t in (dz, y, x_in, w, *rows, dx, ws, dw)],
                   *ints, _stream(dz))
    return dx, dw


# --------------------------------------------------------------------------
# kernel 3
# --------------------------------------------------------------------------

@kernels.kernel_op("conv1x1_bn_bwd_fused")
def conv1x1_bn_bwd_fused(dz: torch.Tensor, y: torch.Tensor,
                         x_in: torch.Tensor, w: torch.Tensor,
                         scale: torch.Tensor, mean: torch.Tensor,
                         inv: torch.Tensor, dbeta: torch.Tensor,
                         dgamma: torch.Tensor, dmean=None, dvar=None,
                         count: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dx, dW of a 1x1 conv followed by train-mode BN, given dz w.r.t.
    the BN output and the sums dbeta = Σdz, dgamma = Σdz·x̂.

    dz, y: (M, C); x_in: (M, Cin); w: (Cin, C); scale, mean, inv,
    dbeta, dgamma: (C,) f32 (scale may be bf16 too). dmean/dvar:
    optional (C,) f32 cotangents on the batch-stat outputs. count: rows behind the batch stats (M·world
    under sync-BN; default M). Returns dx (M, Cin) in x_in.dtype and
    dW (Cin, C) f32."""
    m = dz.shape[0]
    count = count if count is not None else m
    if dz.device.type == "cpu":
        g, a, b = fold_rows(scale.float(), inv, dbeta, dgamma, dmean, dvar,
                            count)
        return _bwd_plain(dz, y, x_in, w, g, mean, inv, a, b)
    g, a, b, _, _ = fold_rows_cuda(
        "conv1x1_bn_bwd", "hvd_conv1x1_bn_fold_rows", scale, None, inv,
        dbeta, dgamma, dmean, dvar, count, False).unbind(0)
    rows = [r.float().contiguous() for r in (g, mean, inv, a, b)]
    out = launch_bwd("conv1x1_bn_bwd", "hvd_conv1x1_bn_bwd", dz, y, x_in, w,
                     rows)
    conv1x1_bn_bwd_fused.launches += 1
    return out


conv1x1_bn_bwd_fused.launches = 0


# --------------------------------------------------------------------------
# autograd Function: the model-facing fused op
# --------------------------------------------------------------------------

def _bn_sums(dz, y, mean, inv):
    """dbeta = Σdz, dgamma = Σdz·x̂, in f32."""
    dzf = dz.float()
    xhat = (y.float() - mean) * inv
    return dzf.sum(0), (dzf * xhat).sum(0)


def _fwd_math(x, w, scale, bias, eps, group):
    y = torch.matmul(x, w)
    yf = y.float()
    mean, meansq = group_sum((yf.mean(0), yf.square().mean(0)), group)
    k = group_size(group)
    if k != 1:
        mean, meansq = mean / k, meansq / k
    var = meansq - mean.square()
    inv = torch.rsqrt(var + eps)
    z = ((yf - mean) * inv).to(x.dtype) * scale + bias
    return z, y, mean, var, inv


class _Conv1x1BN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, scale, bias, eps, group):
        z, y, mean, var, inv = _fwd_math(x, w, scale, bias, eps, group)
        ctx.save_for_backward(x, w, scale, y, mean, inv)
        ctx.group = group
        ctx.set_materialize_grads(False)
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, dmean, dvar):
        x, w, scale, y, mean, inv = ctx.saved_tensors
        group = ctx.group
        if dz is None:
            dz = torch.zeros_like(y)
        dbeta, dgamma = _bn_sums(dz, y, mean, inv)
        # Sync-BN: the dy formula needs the group's sums and row count;
        # the returned dscale/dbias stay per-rank (the gradient all-reduce
        # completes them, as for the unfused path).
        zero = torch.zeros_like(dbeta)
        db_g, dg_g, dm_g, dv_g = group_sum(
            (dbeta, dgamma, zero if dmean is None else dmean,
             zero if dvar is None else dvar), group) \
            if group is not None else (dbeta, dgamma, dmean, dvar)
        dx, dw = conv1x1_bn_bwd_fused(
            dz.contiguous(), y, x, w, scale, mean, inv, db_g, dg_g,
            dmean=dm_g, dvar=dv_g, count=dz.shape[0] * group_size(group))
        return (dx, dw.to(w.dtype), dgamma.to(scale.dtype),
                dbeta.to(scale.dtype), None, None)


def conv1x1_bn(x, w, scale, bias, eps: float = 1e-5, group=None):
    """z = BN(x @ w) over rows, train mode, backward through kernel 3.
    x: (M, Cin); w: (Cin, C). With `group`, batch stats are synced across
    that process group. Returns (z, (batch_mean, batch_var))."""
    z, mean, var = _Conv1x1BN.apply(x, w, scale, bias, eps, group)
    return z, (mean, var)


def conv1x1_bn_nhwc(x, w, scale, bias, eps: float = 1e-5, group=None):
    """x (N, H, W, Cin) contiguous, w (Cin, C). Returns (z NHWC, stats)."""
    n, h, wd, cin = x.shape
    z, stats = conv1x1_bn(x.reshape(n * h * wd, cin), w, scale, bias, eps,
                          group)
    return z.reshape(n, h, wd, -1), stats
