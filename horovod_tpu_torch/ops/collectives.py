"""Eager collectives over torch.distributed (counterpart of the
allreduce / grouped_allreduce / bucketed_allreduce / broadcast /
barrier / synchronize / poll entry points of
horovod_tpu/ops/collectives.py).

Every collective is issued with `async_op=True`; a `Handle` holds the
`Work` and the output, `synchronize` waits on it and `poll` reports
`Work.is_completed()`. Average is a sum divided by the world size in the
tensor's own dtype, as the JAX package divides after its psum.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import types as T
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.ops import fusion


class Handle:
    """An in-flight collective: its Work and the tensor it writes."""

    def __init__(self, work, out: torch.Tensor, finish=None):
        self.work = work
        self.out = out
        self._finish = finish

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work = None
            if self._finish is not None:
                self.out = self._finish(self.out)
        return self.out


def _normalize_op(average: Optional[bool], op) -> T.ReduceOp:
    if op is not None and average is not None:
        raise ValueError("pass either `average` or `op`, not both")
    if op is None:
        return T.ReduceOp.SUM if average is False else T.ReduceOp.AVERAGE
    return T.ReduceOp(op)


def _launch(rop: T.ReduceOp, prescale: float, postscale: float
            ) -> Callable[[torch.Tensor], Handle]:
    """A function that starts the all-reduce of one tensor in place."""
    k = topology.size()

    def finish(y: torch.Tensor) -> torch.Tensor:
        if rop == T.ReduceOp.AVERAGE and k != 1:
            y = y / torch.tensor(k, dtype=y.dtype, device=y.device)
        if postscale != 1.0:
            y = y * postscale
        return y

    def start(x: torch.Tensor) -> Handle:
        if prescale != 1.0:
            x = x * prescale
        work = dist.all_reduce(x, op=dist.ReduceOp.SUM, async_op=True)
        return Handle(work, x, finish)

    return start


def allreduce_async(tensor: torch.Tensor, average: Optional[bool] = None,
                    name: Optional[str] = None, op=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> Handle:
    """Start reducing `tensor` across the world; the input is untouched."""
    del name
    rop = _normalize_op(average, op)
    return _launch(rop, prescale_factor, postscale_factor)(tensor.clone())


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op=None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Reduce `tensor` across the world (default: Average)."""
    return allreduce_async(tensor, average, name, op, prescale_factor,
                           postscale_factor).wait()


def _fused(tensors, average, op, prescale, postscale, reverse
           ) -> List[torch.Tensor]:
    if not tensors:
        return []
    cfg = topology.config()
    start = _launch(_normalize_op(average, op), prescale, postscale)
    thresh = fusion.effective_threshold(cfg.fusion_threshold_bytes,
                                        cfg.bucket_cap_bytes)
    return fusion.fused_reduce(list(tensors),
                               lambda flat: start(flat).wait,
                               thresh, reverse=reverse)


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      average: Optional[bool] = None,
                      name: Optional[str] = None, op=None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """Reduce a group of tensors in ≤-threshold buckets packed in
    submission order, one collective per bucket."""
    del name
    return _fused(tensors, average, op, prescale_factor, postscale_factor,
                  reverse=False)


def bucketed_allreduce(tensors: Sequence[torch.Tensor],
                       average: Optional[bool] = None,
                       name: Optional[str] = None, op=None,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """Reduce a group of tensors as independently launched buckets packed
    in backward-production order (HOROVOD_BUCKET_REVERSE); all buckets are
    in flight before the first is waited on."""
    del name
    return _fused(tensors, average, op, prescale_factor, postscale_factor,
                  reverse=topology.config().bucket_reverse)


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    """The root rank's tensor, on every rank (a new tensor)."""
    del name
    out = tensor.clone()
    dist.broadcast(out, src=root_rank)
    return out


def broadcast_(tensor: torch.Tensor, root_rank: int) -> torch.Tensor:
    """In-place broadcast of `tensor` from the root rank."""
    dist.broadcast(tensor, src=root_rank)
    return tensor


def barrier() -> None:
    """Block until every rank reaches the barrier."""
    dist.barrier()


def synchronize(handle: Handle) -> torch.Tensor:
    """Wait for an async collective and return its result."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """True once the collective behind `handle` has completed."""
    return handle.work is None or handle.work.is_completed()
