"""Framework exceptions (counterpart of horovod_tpu/common/exceptions.py)."""

from __future__ import annotations


class HorovodError(Exception):
    """Base class for errors of the PyTorch package."""


class HorovodInternalError(HorovodError):
    """A collective failed or the framework is in an unusable state.

    In elastic mode this triggers the restore of the last commit and a
    re-join (elastic/__init__.py run)."""


class HostsUpdatedInterrupt(HorovodError):
    """Raised inside elastic training when the driver started a new
    round (the host set changed); `skip_sync` says whether the state
    sync after the re-join may be skipped."""

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class CheckpointCorruptError(HorovodError):
    """A checkpoint directory failed verification: no `.done` commit
    marker, an unreadable or partial manifest, or leaf files absent or
    truncated (ckpt/, checkpoint.py). Restore paths quarantine and fall
    back on it. Not a HorovodInternalError: the elastic retry loop must
    not re-join over a corrupt artifact, which it would read again every
    round."""


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



class TensorShapeMismatchError(HorovodError):
    """Ranks submitted mismatched shapes for the same collective."""


class VersionMismatchError(HorovodError):
    """Ranks, or a rank and its launcher, run different versions of the
    package or of its control-plane protocol (core/consistency.py's
    handshake at init)."""


class CollectiveDivergenceError(HorovodError):
    """Ranks issued different collective sequences: caught by the
    fingerprint verifier (HOROVOD_CHECK_COLLECTIVES, analysis/
    verifier.py) or by the consistency check. Not a HorovodInternalError:
    the elastic retry loop must not restart a program that diverges
    deterministically; it would diverge again every round."""


class CollectiveMismatchError(TensorShapeMismatchError,
                              CollectiveDivergenceError):
    """The consistency check (core/consistency.py) found ranks disagreeing
    on one collective: a TensorShapeMismatchError as in the JAX package,
    and a CollectiveDivergenceError naming the divergent call."""


class StalledTensorError(HorovodError):
    """The stall inspector forced a shutdown."""


class FaultInjectedError(HorovodError):
    """An error produced by the seeded fault-injection harness
    (testing/faults.py) for kinds with no natural exception type (a
    discovery flap). Never raised unless HOROVOD_FAULT_SPEC is set."""


class DuplicateNameError(HorovodError):
    """Two in-flight collectives share a name: an async handle holds its
    name until it is synchronized."""
