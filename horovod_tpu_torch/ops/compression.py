"""Gradient compression (counterpart of horovod_tpu/ops/compression.py):
`none`, `fp16` (what `--fp16-allreduce` chooses), `bf16`, and
`ThresholdedCompressor`, which compresses only tensors of at least
`min_bytes`."""

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


class _CastCompressor(Compressor):
    """Cast floating tensors to `cast_to` on the wire."""

    cast_to: torch.dtype = torch.float16

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point() and tensor.dtype != cls.cast_to:
            return tensor.to(cls.cast_to), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class FP16Compressor(_CastCompressor):
    """Cast floating tensors to fp16 on the wire."""

    cast_to = torch.float16


class BF16Compressor(_CastCompressor):
    """Cast floating tensors to bf16 on the wire."""

    cast_to = torch.bfloat16


class ThresholdedCompressor(Compressor):
    """Apply `inner` (default bf16) only to tensors of at least
    `min_bytes`: large gradients ride the narrow type, the long tail of
    small bias and norm gradients keeps its precision."""

    def __init__(self, inner=None, min_bytes: int = 1 << 20):
        self.inner = inner if inner is not None else BF16Compressor
        self.min_bytes = int(min_bytes)

    def compress(self, tensor):
        if tensor.numel() * tensor.element_size() >= self.min_bytes:
            return self.inner.compress(tensor)
        return tensor, None

    def decompress(self, tensor, ctx):
        return self.inner.decompress(tensor, ctx)

    def wire_dtype(self, dtype: torch.dtype) -> torch.dtype:
        """The dtype buckets are planned in: the tensor's own, since
        whether a message is compressed depends on its size
        (DistributedOptimizer decides it for each packed bucket)."""
        return dtype


class Compression:
    """Option namespace."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor

    @staticmethod
    def thresholded(inner=None, min_bytes: int = 1 << 20
                    ) -> ThresholdedCompressor:
        """`inner` (default bf16) for tensors of at least `min_bytes`,
        identity below."""
        return ThresholdedCompressor(inner, min_bytes)


# bf16 on the wire for tensors of 1 MiB and more.
Compression.bf16_large = ThresholdedCompressor(BF16Compressor, 1 << 20)
