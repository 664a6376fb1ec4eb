"""Expert parallelism: the top-1 mixture-of-experts FFN over the `ep`
axis (counterpart of horovod_tpu/parallel/moe.py `moe_ffn`).

Each rank holds E/ep experts. Top-1 routing over softmax(x·router_w)
with the gate as the output's scale, a capacity of
max(1, int(capacity_factor · T / E)) tokens an expert, slots in token
order by a running count, overflow tokens dropped (they give 0); the
slabs go out and back by the tiled all-to-all over `ep` with the JAX
split and concat axes (parallel/comm.py all_to_all_4d).

Dispatch and combine are a scatter and a gather by slot where the JAX
function multiplies by the one-hot (T, E, cap) tensor. The values are
the same: every element of either einsum sums exactly one x·1 term (a
kept token's own row, or nothing for an empty slot), and x·1 and x + 0
are exact. So are the gradients (the einsum's transpose picks the same
row back). At the flagship LM's shape (T 12288, E 8, cap 3072) the
one-hot tensor would be 604 MB a layer and each einsum ~3.1 TFLOP, more
than the experts' own FFN (~2.5 TFLOP).

One difference, in the JAX function's disfavour: it counts slots with a
cumulative sum in x's dtype, which in bf16 stops counting exactly past
256 tokens an expert; the port counts in int64, exact at any T. In f32
(up to 2^24 tokens) the two agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from horovod_tpu_torch.parallel.comm import all_to_all_4d
from horovod_tpu_torch.parallel.mesh import axis_sizes


def route(x: torch.Tensor, router_w: torch.Tensor, capacity_factor: float):
    """Top-1 routing of x (T, D) over router_w (D, E): (gate (T,), the
    expert of each token (T,), its slot (T,), whether it is kept (T,),
    capacity). Slots count a token's predecessors of the same expert,
    in token order."""
    T, E = x.shape[0], router_w.shape[1]
    probs = torch.softmax(x @ router_w, dim=-1)
    gate, expert = probs.max(dim=-1)
    cap = max(1, int(capacity_factor * T / E))
    # Running count of each expert's tokens, scanned along the token
    # axis as the contiguous one ((E, T): a scan down T rows of E
    # columns uses E threads).
    count = F.one_hot(expert, E).t().cumsum(dim=1)
    slot = count.gather(0, expert[None])[0] - 1
    return gate, expert, slot, slot < cap, cap


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor, axis_name: str = "ep",
            capacity_factor: float = 1.25) -> torch.Tensor:
    """Top-1 MoE feed-forward.

    Per-rank shapes: x (T, D) this rank's tokens, router_w (D, E) with E
    the experts over the whole axis, w1 (E_local, D, F) and w2
    (E_local, F, D) this rank's experts. Returns (T, D)."""
    P = axis_sizes()[axis_name]
    T, D = x.shape
    E = w1.shape[0] * P
    if router_w.shape[1] != E:
        raise ValueError("router width must equal total experts")
    gate, expert, slot, keep, cap = route(x, router_w, capacity_factor)
    # Row e·cap + c of the flat dispatch buffer is expert e's slot c; a
    # dropped token goes to the spare row E·cap, which is cut off, and
    # reads a zero row back (no host sync, unlike a boolean mask).
    idx = torch.where(keep, expert * cap + slot, E * cap)
    xs = x.new_zeros(E * cap + 1, D).index_add(0, idx, x)[:-1]
    xs = all_to_all_4d(xs.view(E, cap, D), axis_name, 0, 1)
    h = F.gelu(torch.bmm(xs, w1), approximate="tanh")
    ys = torch.bmm(h, w2)                       # (E_local, P·cap, D)
    ys = all_to_all_4d(ys, axis_name, 1, 0).reshape(E * cap, D)
    # index_select's backward is an index_add; indexing's sorts.
    out = torch.cat([ys, ys.new_zeros(1, D)]).index_select(0, idx)
    return out * gate[:, None]
