"""Batch normalization in the JAX package's formula, with optional
cross-rank (sync) batch statistics.

Counterpart of horovod_tpu/models/resnet.py batch_norm and
horovod_tpu/ops/sync_batch_norm.py. The formula is not torch's
`F.batch_norm`:
  * mean and E[x²] are taken in f32 and var = E[x²] − mean²;
  * the running var is the biased batch var, updated as
    stats·momentum + batch·(1 − momentum);
  * the normalise runs in x.dtype: inv = rsqrt(var + eps) cast to x.dtype.
With a process group, the per-rank mean and E[x²] are averaged over the
group (never the var), in one all_reduce of a stacked (2, C) tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


class _AllReduceMean(torch.autograd.Function):
    """pmean over a process group: the mean across ranks forward, and the
    mean of the cotangents across ranks backward (the transpose JAX
    gives lax.pmean inside shard_map)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
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
