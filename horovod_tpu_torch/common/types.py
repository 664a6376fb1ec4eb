"""Reduce operators, the collectives' dtypes and the operation status
(counterpart of horovod_tpu/common/types.py: ReduceOp,
normalize_reduce_op, the supported-dtype check, Status and StatusType)."""

from __future__ import annotations

import dataclasses
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


class StatusType(enum.IntEnum):
    """Result classification (reference: horovod/common/common.h:175-182)."""

    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


@dataclasses.dataclass(frozen=True)
class Status:
    """Operation status (reference: horovod/common/common.h:184-228)."""

    type: StatusType = StatusType.OK
    reason: str = ""

    @staticmethod
    def OK() -> "Status":
        return Status(StatusType.OK)

    @staticmethod
    def UnknownError(msg: str) -> "Status":
        return Status(StatusType.UNKNOWN_ERROR, msg)

    @staticmethod
    def PreconditionError(msg: str) -> "Status":
        return Status(StatusType.PRECONDITION_ERROR, msg)

    @staticmethod
    def Aborted(msg: str) -> "Status":
        return Status(StatusType.ABORTED, msg)

    @staticmethod
    def InvalidArgument(msg: str) -> "Status":
        return Status(StatusType.INVALID_ARGUMENT, msg)

    @staticmethod
    def InProgress() -> "Status":
        return Status(StatusType.IN_PROGRESS)

    def ok(self) -> bool:
        return self.type == StatusType.OK

    def in_progress(self) -> bool:
        return self.type == StatusType.IN_PROGRESS


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
