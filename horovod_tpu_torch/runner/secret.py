"""Shared-secret HMAC signing for control-plane RPC (counterpart of
horovod_tpu/runner/secret.py; the digest is the same, byte for byte, so
either package's client can talk to either package's server).

The launcher makes a per-job secret and hands it to the workers in the
HOROVOD_SECRET_KEY env var; every rendezvous request carries an HMAC
digest of method, path and body, and the server rejects requests
without a valid one.
"""

from __future__ import annotations

import hmac
import os
import secrets as _secrets
from typing import Optional

SECRET_ENV = "HOROVOD_SECRET_KEY"
DIGEST_HEADER = "X-Horovod-HMAC"
_HASH = "sha256"


def make_secret_key() -> str:
    """Reference: secret.make_secret_key (random per-job key)."""
    return _secrets.token_hex(32)


def job_secret_key() -> str:
    """The job secret a launcher should use: a pre-set
    HOROVOD_SECRET_KEY is honored, so out-of-band tooling can sign reads
    against the live job; else a fresh per-job key."""
    return os.environ.get(SECRET_ENV, "") or make_secret_key()


def secret_from_env() -> Optional[bytes]:
    val = os.environ.get(SECRET_ENV, "")
    return val.encode() if val else None


def compute_digest(secret: bytes, method: str, path: str,
                   body: bytes) -> str:
    msg = method.encode() + b"\n" + path.encode() + b"\n" + body
    return hmac.new(secret, msg, _HASH).hexdigest()


def check_digest(secret: bytes, method: str, path: str, body: bytes,
                 digest: Optional[str]) -> bool:
    if not digest:
        return False
    want = compute_digest(secret, method, path, body)
    return hmac.compare_digest(want, digest)
