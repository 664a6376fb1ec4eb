"""Framework exceptions (counterpart of horovod_tpu/common/exceptions.py)."""

from __future__ import annotations


class HorovodError(Exception):
    """Base class for errors of the PyTorch package."""


class HorovodInternalError(HorovodError):
    """A collective failed or the framework is in an unusable state."""


class KernelError(HorovodError):
    """A hand-written CUDA kernel failed to build, was refused at launch,
    or was given tensors it does not take."""


class RetryError(HorovodError):
    """A RetryPolicy exhausted its attempts or overall deadline.

    `__cause__` carries the last underlying failure
    (common/resilience.py).
    """


class CircuitOpenError(HorovodError):
    """A CircuitBreaker rejected the call without attempting it
    (common/resilience.py)."""


class ResetLimitExceededError(HorovodError):
    """The elastic driver hit --reset-limit: too many topology resets.

    Typed so orchestrators can tell "the job churned itself to death"
    from other driver failures.
    """

