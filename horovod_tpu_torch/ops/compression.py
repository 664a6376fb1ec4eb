"""Gradient compression (counterpart of horovod_tpu/ops/compression.py):
`none` and `fp16`, the two that `--fp16-allreduce` chooses between."""

from __future__ import annotations

from typing import Any, Tuple

import torch


class Compressor:
    """Interface for compressing tensors before a collective."""

    @staticmethod
    def compress(tensor: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx: Any) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def wire_dtype(cls, dtype: torch.dtype) -> torch.dtype:
        """The dtype a tensor of `dtype` travels in."""
        return cls.compress(torch.empty(0, dtype=dtype))[0].dtype


class NoneCompressor(Compressor):
    """Identity."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """Cast floating tensors to fp16 on the wire."""

    @staticmethod
    def compress(tensor):
        if tensor.is_floating_point() and tensor.dtype != torch.float16:
            return tensor.to(torch.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class Compression:
    """Option namespace."""

    none = NoneCompressor
    fp16 = FP16Compressor
