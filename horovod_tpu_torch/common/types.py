"""Reduce operators (counterpart of horovod_tpu/common/types.py).

Only the operators the data-parallel training path uses are ported:
Average and Sum. Adasum, Min, Max and Product come with later slices.
"""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    """Reduction operators; values match the JAX package's enum."""

    AVERAGE = 0
    SUM = 1


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
