"""Ulysses sequence parallelism (counterpart of
horovod_tpu/parallel/ulysses.py): all-to-alls trade heads for sequence.

Where ring attention circulates k and v, Ulysses re-shards: one
all-to-all each for q, k and v turns the sequence-sharded (B, H, S/P,
dh) into head-sharded (B, H/P, S, dh), every rank runs exact attention
over the whole sequence for its H/P heads (the port's
`flash_attention`, kernels 4–6 on the card, in the input dtype), and a
fourth all-to-all brings the output back to sequence shards. Needs
H % P == 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.parallel.comm import all_to_all_4d


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str, causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Per-rank q, k, v (B, H, S_local, dh), the sequence sharded over the
    HOROVOD_MESH axis `axis_name`; returns (B, H, S_local, dh)."""
    from horovod_tpu_torch.core.process_sets import axis_process_set
    from horovod_tpu_torch.ops.flash_attention import flash_attention
    ps = axis_process_set(axis_name)
    qh, kh, vh = (all_to_all_4d(t, ps, split_axis=1, concat_axis=2)
                  for t in (q, k, v))
    out = flash_attention(qh, kh, vh, causal=causal, scale=scale)
    return all_to_all_4d(out, ps, split_axis=2, concat_axis=1)
