"""Adasum: scaling-insensitive gradient combination (counterpart of
horovod_tpu/ops/adasum.py).

Each pairwise step computes dot(a, b), |a|², |b|² in float32 and
combines

    adasum(a, b) = (1 - a·b / (2|a|²)) · a  +  (1 - a·b / (2|b|²)) · b

with a zero norm giving the plain sum's coefficient 1. The pairing is
the hypercube's: level l pairs set index i with i XOR 2^l. Ranks beyond
the largest power of two p2 of the set fold into their partner i - p2
first and read the result back at the end.

Two exchanges, the JAX package's two:
- default: the whole vector crosses at every level
  (`dist.batch_isend_irecv` where the JAX package uses `ppermute`), and
  every rank's dots stay local;
- HOROVOD_ADASUM_HALVING: true vector-halving distance-doubling. At
  level l a rank keeps half of its current segment and sends the other
  half; the pair's full-vector dots are partials summed over the
  2d-rank subgroup, as one all-reduce over the set of a (groups, 3)
  table in which each rank fills its subgroup's row (ranks beyond p2
  add zeros). The last all-gather puts the segments in bit-reversed
  order (`_vhdd`). Everything after the fold-in runs in float32 and is
  cast back once.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

def _coeffs(dot, na, nb):
    """Projection coefficients with zero-norm guards."""
    one = torch.ones_like(dot)
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * torch.where(na > 0, na, one)),
                     one)
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * torch.where(nb > 0, nb, one)),
                     one)
    return ca, cb


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Adasum combine in float32, cast back to a's dtype."""
    af, bf = a.float(), b.float()
    ca, cb = _coeffs(_dot(af, bf), _dot(af, af), _dot(bf, bf))
    return (ca * af + cb * bf).to(a.dtype)


def _wait(work) -> None:
    """Wait under the stall watchdog (ops/collectives.py guarded_wait)."""
    from horovod_tpu_torch.ops.collectives import guarded_wait
    guarded_wait(work, "adasum")


def _exchange(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send x to global rank `peer` and receive its tensor of x's shape."""
    x = x.contiguous()
    got = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, peer, group=group),
           dist.P2POp(dist.irecv, got, peer, group=group)]
    for w in dist.batch_isend_irecv(ops):
        _wait(w)
    return got


def _send(x: torch.Tensor, peer: int, group) -> None:
    for w in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, x.contiguous(), peer, group=group)]):
        _wait(w)


def _recv(like: torch.Tensor, peer: int, group) -> torch.Tensor:
    got = torch.empty_like(like)
    for w in dist.batch_isend_irecv(
            [dist.P2POp(dist.irecv, got, peer, group=group)]):
        _wait(w)
    return got


def adasum_allreduce(x: torch.Tensor, ps, halving: bool = False
                     ) -> torch.Tensor:
    """Adasum of every member's x over process set `ps`; every member
    returns the same tensor."""
    from horovod_tpu_torch.core import topology
    k = ps.size()
    if k == 1:
        return x.clone()
    group = ps.group
    idx = ps.rank_index(topology.rank())
    p2 = 1
    while p2 * 2 <= k:
        p2 *= 2
    surplus = k - p2
    if idx >= p2:
        _send(x, ps.global_rank(idx - p2), group)
    elif idx < surplus:
        x = _combine(x, _recv(x, ps.global_rank(idx + p2), group))
    if halving:
        return _vhdd(x, ps, p2, idx)
    if idx < p2:
        d = 1
        while d < p2:
            x = _combine(x, _exchange(x, ps.global_rank(idx ^ d), group))
            d *= 2
        if idx < surplus:
            _send(x, ps.global_rank(idx + p2), group)
        return x
    return _recv(x, ps.global_rank(idx - p2), group)


def _bitrev(j: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (j & 1)
        j >>= 1
    return out


def _vhdd(x: torch.Tensor, ps, p2: int, idx: int) -> torch.Tensor:
    """True vector-halving distance-doubling over the p2 core ranks; the
    ranks beyond p2 join each level's all-reduce with zeros and the last
    all-gather with a zero segment, and so hold the result too."""
    k = ps.size()
    group = ps.group
    dtype, shape = x.dtype, x.shape
    flat = x.float().reshape(-1)
    n = flat.numel()
    pad = (-n) % p2
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    cur = flat
    core = idx < p2
    levels = p2.bit_length() - 1
    d = 1
    while d < p2:
        num_groups = p2 // (2 * d)
        table = torch.zeros(num_groups, 3, dtype=torch.float32,
                            device=x.device)
        half = cur.numel() // 2
        if core:
            bit = (idx // d) % 2
            keep, send = (cur[:half], cur[half:]) if bit == 0 \
                else (cur[half:], cur[:half])
            recv = _exchange(send, ps.global_rank(idx ^ d), group)
            kk, rr = _dot(keep, keep), _dot(recv, recv)
            table[idx // (2 * d)] = torch.stack(
                [_dot(keep, recv), kk if bit == 0 else rr,
                 rr if bit == 0 else kk])
        _wait(dist.all_reduce(table, group=group, async_op=True))
        if core:
            dot, na, nb = table[idx // (2 * d)]
            ca, cb = _coeffs(dot, na, nb)
            cur = ca * keep + cb * recv if bit == 0 else cb * keep + ca * recv
        else:
            cur = cur[:half]
        d *= 2
    seg = cur if core else torch.zeros_like(cur)
    rows: List[torch.Tensor] = [torch.empty_like(seg) for _ in range(k)]
    _wait(dist.all_gather(rows, seg.contiguous(), group=group,
                          async_op=True))
    combined = torch.cat([rows[_bitrev(j, levels)] for j in range(p2)])
    return combined[:n].reshape(shape).to(dtype)


def adasum_numpy_reference(tensors):
    """Host-side float64 reference of the whole reduction, for tests."""
    import numpy as np

    def comb(a, b):
        dot = float(np.vdot(a, b))
        na = float(np.vdot(a, a))
        nb = float(np.vdot(b, b))
        ca = 1.0 - dot / (2.0 * na) if na > 0 else 1.0
        cb = 1.0 - dot / (2.0 * nb) if nb > 0 else 1.0
        return ca * a + cb * b

    vals = [np.asarray(t, dtype=np.float64) for t in tensors]
    k = len(vals)
    p2 = 1
    while p2 * 2 <= k:
        p2 *= 2
    for r in range(p2, k):
        vals[r - p2] = comb(vals[r - p2], vals[r])
    d = 1
    while d < p2:
        vals[:p2] = [comb(vals[i], vals[i ^ d]) for i in range(p2)]
        d *= 2
    return vals[0]
