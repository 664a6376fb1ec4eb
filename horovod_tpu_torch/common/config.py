"""Environment knobs read by the PyTorch package.

A copy of the part of horovod_tpu/common/config.py that the training
path reads: the fusion threshold, the bucket cap and the bucket order.
The knob names and defaults are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os

HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_BUCKET_CAP = "HOROVOD_BUCKET_CAP"
HOROVOD_BUCKET_REVERSE = "HOROVOD_BUCKET_REVERSE"

# Launcher-injected rendezvous (horovod_tpu/runner/launch.py).
HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_SIZE = "HOROVOD_SIZE"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_COORDINATOR_ADDR = "HOROVOD_COORDINATOR_ADDR"

DEFAULT_FUSION_THRESHOLD_BYTES = 4 * 1024 * 1024
DEFAULT_BUCKET_CAP_BYTES = 4 * 1024 * 1024


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        return int(v)
    except ValueError:
        return default


@dataclasses.dataclass
class Config:
    """Snapshot of the knobs, taken at init()."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    bucket_cap_bytes: int = DEFAULT_BUCKET_CAP_BYTES
    bucket_reverse: bool = True

    @staticmethod
    def from_env() -> "Config":
        return Config(
            fusion_threshold_bytes=_env_int(
                HOROVOD_FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES),
            bucket_cap_bytes=_env_int(
                HOROVOD_BUCKET_CAP, DEFAULT_BUCKET_CAP_BYTES),
            bucket_reverse=_env_bool(HOROVOD_BUCKET_REVERSE, True),
        )
