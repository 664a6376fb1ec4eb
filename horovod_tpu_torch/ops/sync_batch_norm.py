"""Batch normalization in the JAX package's formula, with optional
cross-rank (sync) batch statistics.

Counterpart of horovod_tpu/models/resnet.py batch_norm and
horovod_tpu/ops/sync_batch_norm.py. The formula is not torch's
`F.batch_norm`:
  * mean and E[x²] are taken in f32 and var = E[x²] − mean²;
  * the running var is the biased batch var, updated as
    stats·momentum + batch·(1 − momentum);
  * the normalise runs in x.dtype: inv = rsqrt(var + eps) cast to x.dtype.

Two ways to share the batch statistics across ranks:
  * `batch_norm(..., group=)`, the ResNet's and Inception's (the JAX
    models' `batch_norm(axis_name=)`): the per-rank mean and E[x²] are
    averaged over the group (never the var), in one all_reduce of a
    stacked (2, C) tensor. Exact only when every rank holds the same
    batch size.
  * `sync_batch_norm` and the `SyncBatchNorm` layer (the JAX package's
    `sync_batch_norm` and `SyncBatchNorm`), count-weighted: each rank
    all-reduces (Sum) one f32 vector [Σx, Σx², n] over a process set,
    then mean = Σx/N and var = Σx²/N − mean², so uneven per-rank batches
    stay exact. The JAX layer is eager and never differentiated through
    its all-reduce; here the sums go through an autograd Function whose
    backward all-reduces (Sum) the cotangents of Σx and Σx², so each
    rank's gradient is its slice of the gradient of one BN over the
    concatenated batch (of the losses summed over the ranks).
For equal batches the two agree (up to rounding).

In elastic mode a transport failure of either all-reduce is a
HorovodInternalError, as in ops/collectives.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn


def _all_reduce(x: torch.Tensor, group) -> None:
    """In-place sum over `group`; in elastic mode a transport failure is
    a HorovodInternalError (ops/collectives.py comm_failure_guard)."""
    from horovod_tpu_torch.ops.collectives import guarded_wait
    try:
        guarded_wait(dist.all_reduce(x, group=group, async_op=True),
                     "sync_batch_norm")
    except Exception as e:
        from horovod_tpu_torch.ops.collectives import comm_failure_guard
        comm_failure_guard(e, "sync batch norm all-reduce")
        raise


class _AllReduceMean(torch.autograd.Function):
    """pmean over a process group: the mean across ranks forward, and the
    mean of the cotangents across ranks backward (the transpose JAX
    gives lax.pmean inside shard_map)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        _all_reduce(y, group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _all_reduce(g, ctx.group)
        return g / dist.get_world_size(ctx.group), None


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable mean of `x` across `group` (identity for None)."""
    return x if group is None else _AllReduceMean.apply(x, group)


def batch_stats(x: torch.Tensor, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode f32 (mean, var) over every axis but the last."""
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    both = torch.stack([xf.mean(dim=axes), xf.square().mean(dim=axes)])
    mean, meansq = pmean(both, group)
    return mean, meansq - mean.square()


def update_running(running: torch.Tensor, batch: torch.Tensor,
                   momentum: float = 0.9) -> torch.Tensor:
    """stats·momentum + batch·(1 − momentum), detached."""
    return (running * momentum + batch.detach() * (1 - momentum)).detach()


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean_stat: torch.Tensor, var_stat: torch.Tensor,
               train: bool, momentum: float = 0.9, eps: float = 1e-5,
               group: Optional[dist.ProcessGroup] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Functional BN over channels-last `x`. Returns
    (out, (new_running_mean, new_running_var))."""
    if train:
        mean, var = batch_stats(x, group)
        new = (update_running(mean_stat, mean, momentum),
               update_running(var_stat, var, momentum))
    else:
        mean, var = mean_stat, var_stat
        new = (mean_stat, var_stat)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    out = (x - mean.to(x.dtype)) * inv * scale + bias
    return out, new


# ---------------------------------------------------- count-weighted sync BN

class _SumAcrossRanks(torch.autograd.Function):
    """psum over a process group: the sum across ranks forward, and the
    sum of the cotangents across ranks backward (psum's transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _all_reduce(g, ctx.group)
        return g, None


def sync_batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    process_set=None, eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalise channels-last `x` with count-weighted batch statistics
    over `process_set` (default the global set). Returns (normalized,
    global mean, global var), the stats f32; the caller owns running
    stats."""
    from horovod_tpu_torch.ops.collectives import _resolve
    ps = _resolve(process_set)
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    n = xf.new_tensor([float(xf.numel() // xf.shape[-1])])
    tot = _SumAcrossRanks.apply(
        torch.cat([xf.sum(dim=axes), xf.square().sum(dim=axes), n]),
        ps.group)
    c = x.shape[-1]
    count = tot[-1]
    mean = tot[:c] / count
    var = tot[c:2 * c] / count - mean.square()
    inv = torch.rsqrt(var + eps).to(x.dtype)
    out = (x - mean.to(x.dtype)) * inv * scale.to(x.dtype) + \
        bias.to(x.dtype)
    return out, mean, var


class SyncBatchNorm(nn.Module):
    """Horovod's SyncBatchNormalization in the JAX package's conventions
    (horovod_tpu/ops/sync_batch_norm.py SyncBatchNorm): channels-last
    input normalised over every axis but the last, count-weighted across
    the process set (`sync_batch_norm`), `scale` and `bias` parameters,
    f32 running stats updated as running·momentum + batch·(1 − momentum)
    with momentum 0.9 and the biased batch var; eval mode normalises
    with the running stats. The normalise runs in x.dtype with
    rsqrt(var + eps) cast to x.dtype.

    Not `torch.nn.SyncBatchNorm`: that layer takes channels-first input,
    weights the new batch by `momentum` (0.1) rather than the running
    stats, keeps the unbiased var in its running stats and normalises in
    f32."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9, process_set=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.process_set = process_set
        self.scale = nn.Parameter(torch.ones(num_features, dtype=dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, dtype=dtype,
                                             device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps).to(x.dtype)
            return (x - self.running_mean.to(x.dtype)) * inv * \
                self.scale.to(x.dtype) + self.bias.to(x.dtype)
        out, mean, var = sync_batch_norm(x, self.scale, self.bias,
                                         self.process_set, self.eps)
        with torch.no_grad():
            self.running_mean.copy_(
                update_running(self.running_mean, mean, self.momentum))
            self.running_var.copy_(
                update_running(self.running_var, var, self.momentum))
        return out


# Reference-API alias.
SyncBatchNormalization = SyncBatchNorm
