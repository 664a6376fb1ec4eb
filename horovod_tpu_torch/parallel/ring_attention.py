"""Ring attention: exact attention over a sequence-parallel axis
(counterpart of horovod_tpu/parallel/ring_attention.py).

The sequence is sharded over the ranks of one `sp` process set: ring
rank r holds tokens [r·S, (r+1)·S) of q, k and v (B, H, S, dh). The
k/v blocks travel round the ring (parallel/comm.py `ring_shift`, one
message of k and v stacked a hop), so after t hops rank r holds the
block that originated on rank (r − t) % P, and each hop folds that
block into the local queries' attention. The result is exact at any
sequence length while each rank keeps O(S) of it.

Two routes, chosen as in the JAX package (`use_flash=None`: the port's
`can_tile` of the local shapes):
  * `ring_flash_attention`: each hop is one `flash_attention_chunk`
    (kernels 4–6 on the card) giving (o, lse), merged in log space;
  * the streaming f32 path of `ring_attention` (`_block_attn`): running
    max, denominator and output, plain PyTorch.

Differentiable: the backward of `ring_shift` is the reverse shift, the
ring JAX derives for `ppermute`, so the k/v cotangents each rank
computes for a visiting block travel back to the rank it came from.
Every rank posts its send and receive on every hop, whether or not its
own chunk for that hop is skipped, so the ring cannot deadlock. The
shift after the last hop, whose result JAX drops, is not made.

`blockwise_attention_reference` is the exact one-device oracle, and the
route of ops/flash_attention.py for shapes the kernels do not tile.
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.parallel.comm import ring_shift

_NEG_INF = -1e30


def _ring(axis_name: str):
    """(process set, P, this rank's ring position) of a mesh axis."""
    from horovod_tpu_torch.core import topology
    from horovod_tpu_torch.core.process_sets import axis_process_set
    ps = axis_process_set(axis_name)
    return ps, ps.size(), ps.rank_index(topology.rank())


def _block_attn(q, k, v, m, l, o, q_off, kv_off, causal, scale):
    """One streaming-softmax update of (m, l, o) against a k/v block.

    q (B, H, Sq, dh); k, v (B, H, Sk, dh); m, l (B, H, Sq, 1); o (B, H,
    Sq, dh). Offsets are the global positions of element 0."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        q_pos = q_off + torch.arange(q.shape[2], device=q.device)[:, None]
        kv_pos = kv_off + torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(q_pos >= kv_pos, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1, keepdim=True)
    o_new = o * corr + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, o_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str, causal: bool = True,
                   scale: Optional[float] = None,
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Exact attention with k/v rotating round the ring of the HOROVOD_MESH
    axis `axis_name`. Per-rank shapes q, k, v (B, H, S, dh), contiguous
    blocks; returns (B, H, S, dh) in q.dtype.

    When the shard tiles (default: decided), each hop runs the flash
    chunk and the chunks merge in log space (`ring_flash_attention`);
    otherwise the streaming f32 path below."""
    if use_flash is None:
        from horovod_tpu_torch.ops.flash_attention import can_tile
        use_flash = can_tile(q.shape[2], k.shape[2], causal=causal)
    if use_flash:
        return ring_flash_attention(q, k, v, axis_name, causal=causal,
                                    scale=scale)
    ps, P, r = _ring(axis_name)
    B, H, S, dh = q.shape
    if scale is None:
        scale = dh ** -0.5
    # The streaming state accumulates in f32 whatever the input dtype: a
    # bf16 running max and denominator compound error over P·S keys.
    q32 = q.float()
    kv = torch.stack([k, v]).float()
    m = torch.full((B, H, S, 1), _NEG_INF, device=q.device)
    l = torch.zeros((B, H, S, 1), device=q.device)
    o = torch.zeros((B, H, S, dh), device=q.device)
    for t in range(P):
        kv_off = ((r - t) % P) * S
        m, l, o = _block_attn(q32, kv[0], kv[1], m, l, o, r * S, kv_off,
                              causal, scale)
        if t < P - 1:
            kv = ring_shift(kv, ps)
    return (o / l.clamp_min(1e-30)).to(q.dtype)


class _Skip(torch.autograd.Function):
    """(o, L) as they are, with kv an input whose gradient is zero. A
    skipped hop still consumes its block, so every rank's backward
    reaches every ring shift and the reverse ring pairs up across ranks
    that skip different hops (JAX's `lax.switch` transposes every
    `ppermute` for the same reason); without it a rank whose later
    blocks are all skipped would post no reverse shift at all."""

    @staticmethod
    def forward(ctx, o, L, kv):
        return o.view_as(o), L.view_as(L)

    @staticmethod
    def backward(ctx, do, dL):
        return do, dL, None


def ring_hop(q, kv, o, L, case: int, scale: float):
    """One hop of `ring_flash_attention`: the chunk of the local queries
    q against the visiting block kv = (k, v) stacked, then the log-space
    merge into (o, L):

        L' = logaddexp(L, lse);  o' = e^{L−L'}·o + e^{lse−L'}·o_chunk

    `case` is the JAX `lax.switch` index: 0, the block comes after ours
    and is skipped ((o, L) unchanged, which is what merging the skip
    branch's zeros and −1e30 gives, and the block still in the graph:
    `_Skip`); 1, the diagonal block, a causal
    chunk; 2, a block before ours (or any block when not causal), a full
    chunk. All f32."""
    if case == 0:
        return _Skip.apply(o, L, kv)
    from horovod_tpu_torch.ops.flash_attention import flash_attention_chunk
    o_b, lse_b = flash_attention_chunk(q, kv[0], kv[1], causal=case == 1,
                                       scale=scale)
    L_new = torch.logaddexp(L, lse_b)
    o = (o * torch.exp(L - L_new)[..., None]
         + o_b * torch.exp(lse_b - L_new)[..., None])
    return o, L_new


def hop_case(src: int, r: int, causal: bool) -> int:
    """`ring_hop`'s case for the block from ring rank `src` at rank r."""
    if not causal:
        return 2
    return 1 if src == r else (2 if src < r else 0)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis_name: str, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention with the flash chunk inside each hop (`ring_hop`).
    Per-rank q, k, v (B, H, S, dh); returns (B, H, S, dh) in q.dtype.

    q, k and v go to f32 first, as in the JAX package: chunk outputs in
    bf16 would round once per hop before the merge instead of once at
    the end. The chunks are therefore the f32 instances of kernels 4–6.
    The merge is plain PyTorch, so autograd flows through it, through
    both outputs of each chunk (kernel 5 takes the lse cotangent) and
    back round the ring."""
    ps, P, r = _ring(axis_name)
    B, H, S, dh = q.shape
    if scale is None:
        scale = dh ** -0.5
    q32 = q.float()
    kv = torch.stack([k, v]).float()
    o = torch.zeros((B, H, S, dh), device=q.device)
    L = torch.full((B, H, S), _NEG_INF, device=q.device)
    for t in range(P):
        o, L = ring_hop(q32, kv, o, L, hop_case((r - t) % P, r, causal),
                        scale)
        if t < P - 1:
            kv = ring_shift(kv, ps)
    return o.to(q.dtype)


def blockwise_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool = True,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Exact attention of q, k, v (B, H, S, dh) in their own dtype: the
    full (S, S) scores, masked with -1e30 above the diagonal when causal,
    a softmax and the weighted sum of v. Returns (B, H, S, dh)."""
    S, dh = q.shape[-2], q.shape[-1]
    if scale is None:
        scale = dh ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
