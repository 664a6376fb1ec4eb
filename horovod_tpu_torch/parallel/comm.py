"""Differentiable point-to-point and all-to-all over a process set: the
port's `lax.ppermute` (a ring shift) and tiled `lax.all_to_all`, which
the JAX package's sequence parallelism is built on.

Both are `torch.autograd.Function`s whose backward is the transposed
communication, which is what JAX derives for its primitives:
  * `ring_shift` sends to the next rank of the set and receives from the
    previous one; its backward shifts the cotangent the other way, so a
    gradient goes back to the rank its block came from;
  * `all_to_all_4d` cuts `split_axis` into one chunk per rank, sends
    chunk j to rank j and concatenates what arrives along
    `concat_axis`, in rank order; its backward is the all-to-all with
    the two axes swapped.

"Rank" is the position in the set's sorted rank list, which for an
`axis_process_set` is the coordinate along that axis. A set of one rank
communicates nothing. Every operation is issued with `async_op` and
waited on its Work (NCCL hangs on a dead peer otherwise), and a ring
shift posts its send and its receive in one `batch_isend_irecv`, in the
same order on every rank. Works over gloo on the CPU and NCCL on the
card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _peers(ps):
    """(group, global ranks in set order, this rank's position)."""
    from horovod_tpu_torch.core import topology
    ranks = ps.ranks if ps.ranks is not None else list(range(ps.size()))
    return ps.group, ranks, ranks.index(topology.rank())


def _shift(t: torch.Tensor, ps, step: int) -> torch.Tensor:
    """t sent `step` places along the set's ring (+1: to the next rank),
    the block of the rank `step` places back received."""
    group, ranks, i = _peers(ps)
    n = len(ranks)
    if n == 1:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, ranks[(i + step) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - step) % n], group)]
    from horovod_tpu_torch.ops.collectives import guarded_wait
    for work in dist.batch_isend_irecv(ops):
        guarded_wait(work, "ring_shift")
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ps):
        ctx.ps = ps
        return _shift(t, ps, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.ps, -1), None


def ring_shift(t: torch.Tensor, ps) -> torch.Tensor:
    """What rank (r − 1) % P of process set `ps` holds as `t`, on rank r
    (`lax.ppermute` with perm [(i, (i + 1) % P)]); differentiable."""
    return _RingShift.apply(t, ps)


def _all_to_all(t: torch.Tensor, ps, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    group, ranks, _ = _peers(ps)
    n = len(ranks)
    if n == 1:
        return t
    if t.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of size "
                         f"{t.shape[split_axis]} does not split into {n}")
    # (P, ...) with chunk j of split_axis at [j], contiguous for the send
    x = t.unflatten(split_axis, (n, -1)).movedim(split_axis, 0).contiguous()
    out = torch.empty_like(x)
    from horovod_tpu_torch.ops.collectives import guarded_wait
    guarded_wait(dist.all_to_all_single(out, x, group=group, async_op=True),
                 "all_to_all")
    # out[j] came from rank j: concatenated along concat_axis in rank order
    return out.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ps, split_axis, concat_axis):
        ctx.args = (ps, split_axis, concat_axis)
        return _all_to_all(t, ps, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        ps, split_axis, concat_axis = ctx.args
        return _all_to_all(g, ps, concat_axis, split_axis), None, None, None


def all_to_all_4d(t: torch.Tensor, ps, split_axis: int,
                  concat_axis: int) -> torch.Tensor:
    """JAX's tiled `lax.all_to_all(t, axis, split_axis, concat_axis)` over
    process set `ps`: `split_axis` shrinks P-fold, `concat_axis` grows
    P-fold; differentiable."""
    return _AllToAll.apply(t, ps, split_axis, concat_axis)
