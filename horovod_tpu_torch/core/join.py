"""Join for uneven data (counterpart of horovod_tpu/core/join.py).

The JAX package's design: ranks agree on the largest step count and the
ranks whose data ran out pad with zero-contribution steps
(`join_steps`); `join()` is the end-of-loop barrier, which returns the
highest rank that joined.
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.common import types as T
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.core.process_sets import ProcessSet
from horovod_tpu_torch.ops import collectives


def _max(value: int, process_set: Optional[ProcessSet]) -> int:
    out = collectives.allreduce(
        torch.tensor([value], dtype=torch.int64, device=topology.device()),
        op=T.ReduceOp.MAX, process_set=process_set)
    return int(out.item())


def join_steps(local_steps: int,
               process_set: Optional[ProcessSet] = None) -> int:
    """The step count every member runs: the largest of the members'
    `local_steps`. A member past its own data contributes zeros."""
    return _max(local_steps, process_set)


def join(process_set: Optional[ProcessSet] = None) -> int:
    """Block until every member has called join; returns the highest
    rank among them (with one collective there is no arrival order)."""
    topology.set_joined(True)
    try:
        return _max(topology.rank(), process_set)
    finally:
        topology.set_joined(False)
