"""Framework exceptions (counterpart of horovod_tpu/common/exceptions.py)."""

from __future__ import annotations


class HorovodError(Exception):
    """Base class for errors of the PyTorch package."""


class HorovodInternalError(HorovodError):
    """A collective failed or the framework is in an unusable state."""


class KernelError(HorovodError):
    """A hand-written CUDA kernel failed to build, was refused at launch,
    or was given tensors it does not take."""
