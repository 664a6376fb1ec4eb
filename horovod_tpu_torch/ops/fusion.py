"""Tensor fusion: bucket planning and the fused reduce.

The planner is a copy of horovod_tpu/ops/fusion.py (effective_threshold,
plan_buckets, plan_signature): same-dtype items pack greedily, tensors
above max(threshold, 1 MiB) are cut into near-equal chunks first, and
`reverse` packs from the last tensor backwards so that each bucket
covers gradients that the backward pass produces together. Plans are
identical to the JAX package's for identical (shape, dtype) lists.

`fused_launch` is the eager counterpart of fused_reduce_blocks:
flatten, `torch.cat` each bucket's segments, one collective per bucket,
split back. Every bucket is launched before any is waited on.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

_MIN_CHUNK_BYTES = 1 << 20

DTypeLike = Union[str, torch.dtype]


def dtype_name(dtype: DTypeLike) -> str:
    """'float32' for torch.float32 or 'float32' (the JAX package's
    str(dtype) spelling, which plans are keyed on)."""
    return dtype if isinstance(dtype, str) else \
        str(dtype).replace("torch.", "")


def _itemsize(name: str) -> int:
    return getattr(torch, name).itemsize


@dataclasses.dataclass(frozen=True)
class BucketItem:
    """One contiguous slice of a (flattened) tensor inside a bucket."""

    index: int  # position in the submitted tensor list
    start: int  # element offset into the flattened tensor
    size: int   # element count


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One fusion bucket: same-dtype items reduced by one collective."""

    dtype: str
    itemsize: int
    items: Tuple[BucketItem, ...]


def effective_threshold(threshold_bytes: int, cap_bytes: int) -> int:
    """The bucket size actually used: min(threshold, cap); a cap of 0
    disables the cap."""
    t = max(int(threshold_bytes), 1)
    return min(t, int(cap_bytes)) if cap_bytes and cap_bytes > 0 else t


def plan_buckets(shapes_dtypes: Sequence[Tuple[Tuple[int, ...], DTypeLike]],
                 threshold_bytes: int,
                 reverse: bool = False) -> List[Bucket]:
    """Partition tensors (or chunks of them) into fusion buckets; see the
    module docstring. Deterministic: identical inputs give an identical
    plan on every rank."""
    thresh = max(int(threshold_bytes), 1)
    chunk_bytes = max(thresh, _MIN_CHUNK_BYTES)
    buckets: List[dict] = []
    open_bucket: dict = {}  # dtype -> bucket index
    order = range(len(shapes_dtypes) - 1, -1, -1) if reverse \
        else range(len(shapes_dtypes))
    for i in order:
        shape, dtype = shapes_dtypes[i]
        dtype = dtype_name(dtype)
        itemsize = _itemsize(dtype)
        total = math.prod(shape) if shape else 1
        nbytes = total * itemsize
        if nbytes > chunk_bytes:
            per = max(chunk_bytes // itemsize, 1)
            nchunks = -(-total // per)
            base, rem = divmod(total, nchunks)
            pieces = []
            off = 0
            for c in range(nchunks):
                sz = base + (1 if c < rem else 0)
                pieces.append(BucketItem(i, off, sz))
                off += sz
        else:
            pieces = [BucketItem(i, 0, total)]
        for it in pieces:
            it_bytes = it.size * itemsize
            bi = open_bucket.get(dtype)
            if bi is not None and buckets[bi]["bytes"] + it_bytes <= thresh:
                buckets[bi]["items"].append(it)
                buckets[bi]["bytes"] += it_bytes
            else:
                buckets.append({"dtype": dtype, "itemsize": itemsize,
                                "bytes": it_bytes, "items": [it]})
                open_bucket[dtype] = len(buckets) - 1
    return [Bucket(b["dtype"], b["itemsize"], tuple(b["items"]))
            for b in buckets]


def plan_signature(plan: Sequence[Bucket]) -> str:
    """Short stable fingerprint of a bucket plan (same text as the JAX
    package's, so the two packages' plans can be compared by it)."""
    h = hashlib.sha256(repr([(b.dtype, b.items) for b in plan]).encode())
    return f"{len(plan)}b:{h.hexdigest()[:10]}"


def pack(bucket: Bucket, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The bucket's segments as one flat tensor."""
    segs = [tensors[it.index].reshape(-1)[it.start:it.start + it.size]
            for it in bucket.items]
    return segs[0].clone() if len(segs) == 1 else torch.cat(segs)


def unpack(bucket: Bucket, flat: torch.Tensor,
           outs: Sequence[torch.Tensor]) -> None:
    """Copy a reduced bucket back into the flat views `outs`."""
    off = 0
    for it in bucket.items:
        outs[it.index][it.start:it.start + it.size].copy_(
            flat[off:off + it.size])
        off += it.size


def fused_launch(tensors: Sequence[torch.Tensor],
                 launch: Callable[[torch.Tensor], Callable[[], torch.Tensor]],
                 threshold_bytes: int,
                 reverse: bool = False,
                 outs: Optional[Sequence[torch.Tensor]] = None
                 ) -> Callable[[], List[torch.Tensor]]:
    """Start one collective per fusion bucket of `tensors`.

    `launch(flat)` starts the collective on a fused 1-D tensor and returns
    a function that waits and gives the reduced flat tensor. Returns a
    function that waits on every bucket and gives the results: new
    tensors of the inputs' shapes and dtypes, or `outs` (contiguous
    tensors of those shapes and dtypes) written in place."""
    plan = plan_buckets([(tuple(t.shape), t.dtype) for t in tensors],
                        threshold_bytes, reverse=reverse)
    waits = [(b, launch(pack(b, tensors))) for b in plan]

    def finish() -> List[torch.Tensor]:
        res = list(outs) if outs is not None else [
            torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
        flat_outs = [o.view(-1) for o in res]
        for b, wait in waits:
            unpack(b, wait(), flat_outs)
        return res

    return finish

