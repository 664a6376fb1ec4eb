"""Reduce operators and the collectives' dtypes (counterpart of
horovod_tpu/common/types.py: ReduceOp, normalize_reduce_op and the
supported-dtype check)."""

from __future__ import annotations

import enum
from typing import Any

import torch


class ReduceOp(enum.IntEnum):
    """Reduction operators; values match the JAX package's enum."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT


def normalize_reduce_op(op: Any) -> ReduceOp:
    """A ReduceOp from an enum member, its int value or its name."""
    if isinstance(op, ReduceOp):
        return op
    if isinstance(op, int):
        return ReduceOp(op)
    if isinstance(op, str):
        return ReduceOp[op.upper()]
    raise ValueError(f"Cannot interpret reduce op: {op!r}")


# The JAX package's list: unsigned and signed integers up to 64 bits, the
# three float widths plus bf16, and bool. torch.uint16 is absent from
# older torch builds.
_SUPPORTED_DTYPES = tuple(d for d in (
    torch.uint8, torch.int8, getattr(torch, "uint16", None), torch.int16,
    torch.int32, torch.int64, torch.float16, torch.bfloat16, torch.float32,
    torch.float64, torch.bool) if d is not None)


def check_supported_dtype(dtype: torch.dtype) -> None:
    if dtype not in _SUPPORTED_DTYPES:
        raise ValueError(f"Unsupported dtype for collective: {dtype}")
