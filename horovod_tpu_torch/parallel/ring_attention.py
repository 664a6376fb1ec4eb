"""Attention over the whole sequence on one device (counterpart of
horovod_tpu/parallel/ring_attention.py).

Only `blockwise_attention_reference` is ported so far: the exact,
score-materialising attention that is the oracle of the flash kernels
and the route of ops/flash_attention.py for shapes the kernels do not
tile. `ring_attention` and `ring_flash_attention` need a sequence-parallel
process group and are still to port (ROADMAP A11).
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


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
