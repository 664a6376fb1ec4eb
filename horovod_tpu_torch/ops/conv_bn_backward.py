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
the kernel, or raises. bf16 and f32 are both kernel types: at the shapes
`bwd_instance` names (every ResNet-50 site) bf16 runs the Hopper
instance (wgmma, TMA rings, dW split-K through thread-block clusters)
and f32 its tf32 sibling (tf32 wgmma, the same rings and clusters);
other shapes run the simple mma.sync code; f32 is never cast down to
bf16.

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
    runs tf32 products), and contiguous f32 rows, all on one CUDA
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


# The Hopper instances (csrc/conv1x1_bwd_hopper.cuh, and for f32
# csrc/conv1x1_bwd_hopper_f32.cuh): dW split over M in thread-block
# clusters of HOPPER_CLUSTER blocks, at most HOPPER_WAVE blocks for the
# tiles that one wave covers.
HOPPER_CLUSTER = 8
HOPPER_WAVE = 128
# The f32 instance runs tf32 wgmma, whose shared-memory operands are
# K-major rows of 128 bytes: a ring step is 32 f32 values (bf16: 64).
TF32_STEP = 32
SMEM_MAX = 232448  # bytes of shared memory a block can take on the H100
TF32_MIN_STAGES, TF32_MAX_STAGES = 3, 4
# The f32 dW blocks take one SM each (their ring needs more than half of
# its shared memory). Their time follows the bytes a block loads over the
# blocks in flight, and an H100 80GB HBM3 holds at once 15 clusters of 8
# such blocks, 17 of 6, 30 of 4 and 66 of 2 (cudaOccupancyMaxActiveClusters,
# chip_smoke.py tf32_instance_report): clusters of 2 put a block on every
# SM in one wave, and measured fastest at every ResNet-50 site
# (PERF.md); a plan with more clusters than the card holds runs a second
# wave, at twice the time.
TF32_CLUSTER = 2
TF32_WAVE = 132


def bwd_instance(m: int, cin: int, c: int, dtype: torch.dtype) -> str:
    """Which instance of kernels 2 and 3 runs (m, cin, c) in `dtype`:
    "hopper" (bf16 wgmma, TMA, clusters) for bf16 with Cin and C
    multiples of 8, and "hopper_tf32" (tf32 wgmma, the same design) for
    f32 with Cin and C multiples of 4 (TMA's 16-byte stride rule), both
    with Cin and C between 64 and 1024 (the per-channel rows of up to
    1024 channels stay in shared memory), which every ResNet-50 site is;
    else "simple" (mma.sync). A function of shape and dtype alone: a
    launch or build that fails raises, it never picks the other
    instance."""
    del m  # any M: TMA fills the ragged row edge with zeros
    if not (64 <= cin <= 1024 and 64 <= c <= 1024):
        return "simple"
    if dtype == torch.bfloat16 and cin % 8 == 0 and c % 8 == 0:
        return "hopper"
    if dtype == torch.float32 and cin % 4 == 0 and c % 4 == 0:
        return "hopper_tf32"
    return "simple"


def hopper_tiles(m: int, cin: int, c: int) -> Tuple[int, int, int]:
    """(NB, CT, NT): the Cin width of a dx tile (the wgmma N) and the
    (Cin, C) tile of dW, the smallest instances that hold Cin and C, up
    to 256 and 128; but dx takes 128-wide tiles where 256-wide ones give
    fewer jobs (128-row tiles x Cin tiles) than two waves over the SMs,
    as at M 6272: forming dy twice as often costs less there than idle
    SMs (measured on an H100)."""
    ct = 64 if cin <= 64 else 128 if cin <= 128 else 256
    return _dx_width(m, cin, ct, 2 * _SM_COUNT), ct, 64 if c <= 64 else 128


def _dx_width(m: int, cin: int, widest: int, min_jobs: int) -> int:
    """`widest`, or 128 where 256-wide dx tiles give fewer than
    `min_jobs` jobs (128-row tiles x Cin tiles)."""
    if widest == 256 and math.ceil(m / 128) * math.ceil(cin / 256) \
            < min_jobs:
        return 128
    return widest


def _dw_split(m: int, tiles: int, step: int, cl: int = HOPPER_CLUSTER,
              wave: int = HOPPER_WAVE) -> Tuple[int, int]:
    """(clusters, chunk): each of `tiles` dW tiles split over M into
    clusters x `cl` blocks of `chunk` rows (a multiple of the ring step),
    in order: block s takes rows [s·chunk, (s+1)·chunk). tiles x clusters
    <= wave / cl (or clusters is 1), so the f32 workspace that holds the
    clusters' sums when clusters > 1 is at most that many tiles."""
    clusters = max(1, wave // cl // tiles)
    splits = clusters * cl
    chunk = step * max(1, math.ceil(m / splits / step))
    clusters = max(1, math.ceil(math.ceil(m / chunk) / cl))
    return clusters, chunk


def hopper_dw_plan(m: int, cin: int, c: int) -> Tuple[int, int]:
    """(clusters, chunk) of the bf16 Hopper dW pass (`_dw_split`, 64-row
    ring steps)."""
    _, ct, nt = hopper_tiles(m, cin, c)
    return _dw_split(m, math.ceil(cin / ct) * math.ceil(c / nt), 64)


def hopper_tf32_tiles(m: int, cin: int, c: int) -> Tuple[int, int, int]:
    """(NB, CT, NT) of the f32 instance: dx the smallest width that holds
    Cin, up to 256, but 128 where 256-wide tiles give fewer jobs than
    half the SMs (M 6272 at Cin 256, where 128-wide tiles measured
    faster on an H100; at Cin 1024 256-wide ones did); the dW tile the
    smallest that holds Cin and C, up to 256 x 128, where the ring of 3
    stages and the two dyᵀ buffers fit in shared memory
    (`hopper_tf32_smem`)."""
    ct = 64 if cin <= 64 else 128 if cin <= 128 else 256
    return (_dx_width(m, cin, ct, _SM_COUNT // 2), ct,
            64 if c <= 64 else 128)


def hopper_tf32_dw_plan(m: int, cin: int, c: int) -> Tuple[int, int]:
    """(clusters, chunk) of the f32 Hopper dW pass: clusters of
    TF32_CLUSTER blocks, at most TF32_WAVE blocks for the tiles that one
    wave covers (`_dw_split`, 32-row ring steps)."""
    _, ct, nt = hopper_tf32_tiles(m, cin, c)
    tiles = math.ceil(cin / ct) * math.ceil(c / nt)
    return _dw_split(m, tiles, TF32_STEP, TF32_CLUSTER, TF32_WAVE)


def _tf32_stages(stage: int, fixed: int) -> int:
    st = (SMEM_MAX - 1024 - fixed) // stage
    return 0 if st < TF32_MIN_STAGES else min(st, TF32_MAX_STAGES)


def hopper_tf32_smem(m: int, cin: int, c: int) -> dict:
    """The shared-memory plan of the f32 instance's two kernels, the
    arithmetic of csrc/conv1x1_bwd_hopper_f32.cuh launch_dx_tf32 and
    dw_smem: ring stages and bytes a block of each, and the dW
    partial tile that reuses the ring. A launch refuses (stages 0) a
    shape where fewer than TF32_MIN_STAGES stages fit."""
    nb, ct, nt = hopper_tf32_tiles(m, cin, c)
    bars = 2 * TF32_MAX_STAGES * 8
    dx_stage = 2 * 128 * 128 + nb * 128        # dz, y, w
    dx_fixed = 8 * 4 * TF32_STEP * math.ceil(c / TF32_STEP) + bars
    dw_stage = (ct + 2 * nt) * 128             # x, dz, y
    dw_fixed = 2 * nt * 128 + bars              # two dyᵀ buffers
    dx_st, dw_st = _tf32_stages(dx_stage, dx_fixed), \
        _tf32_stages(dw_stage, dw_fixed)
    return dict(dx_stages=dx_st, dx_stage=dx_stage,
                dx_bytes=1024 + dx_st * dx_stage + dx_fixed,
                dw_stages=dw_st, dw_stage=dw_stage,
                dw_bytes=1024 + dw_st * dw_stage + dw_fixed,
                tile_bytes=ct * (nt + 8) * 4)


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
    inst = bwd_instance(m, cin, c, dz.dtype)
    if inst != "simple":
        if any(t.data_ptr() % 16 for t in (dz, y, x_in, w)):
            raise KernelError(f"{fn_name}: the TMA loads need dz, y, x and "
                              f"w on 16-byte boundaries")
        tiles, plan = ((hopper_tiles, hopper_dw_plan) if inst == "hopper"
                       else (hopper_tf32_tiles, hopper_tf32_dw_plan))
        clusters, chunk = plan(m, cin, c)
        ws = torch.empty((clusters if clusters > 1 else 0, cin, c),
                         dtype=torch.float32, device=dev)
        ints = (m, cin, c, *tiles(m, cin, c), clusters, chunk)
        suffix = inst
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
