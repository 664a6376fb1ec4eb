"""Retry/backoff policies and circuit breaking for the control plane
(counterpart of horovod_tpu/common/resilience.py).

Every control-plane hop (rendezvous KV, worker notification) routes its
transient failures through one `RetryPolicy`: jittered exponential
backoff with an attempt bound and an overall deadline, so no caller
retries without end. Exhaustion raises `RetryError` (the last failure as
`__cause__`); an open `CircuitBreaker` raises `CircuitOpenError`.

The JAX package also counts retries and breaker transitions in its
metrics registry and records them in its flight recorder. Neither
subsystem is ported yet (ROADMAP A13), and both only observe: this copy
leaves those calls out and decides exactly as the reference does.

Env knobs: each call site reads a scoped prefix (e.g.
HOROVOD_KV_RETRY_MAX_ATTEMPTS) over code defaults.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Iterator, Optional

from horovod_tpu_torch.common.config import _env_float, _env_int
from horovod_tpu_torch.common.exceptions import (CircuitOpenError,
                                                 HorovodError, RetryError)


def is_transient(e: BaseException) -> bool:
    """Default retryable predicate: transport-level failures and HTTP 5xx.

    4xx (403 auth rejection, 404 missing key) is not transient: retrying
    would mask a real error.
    """
    import urllib.error

    if isinstance(e, urllib.error.HTTPError):
        return e.code >= 500
    if isinstance(e, urllib.error.URLError):
        reason = getattr(e, "reason", None)
        return reason is None or is_transient(reason) or not isinstance(
            reason, Exception)
    if isinstance(e, (ConnectionError, TimeoutError)):
        return True
    import socket
    if isinstance(e, (socket.timeout, socket.gaierror)):
        return True
    if isinstance(e, OSError):
        import errno
        return e.errno in (errno.ECONNREFUSED, errno.ECONNRESET,
                           errno.ECONNABORTED, errno.EPIPE, errno.ETIMEDOUT,
                           errno.EHOSTUNREACH, errno.ENETUNREACH,
                           errno.EAGAIN, None)
    return False


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with attempt and deadline bounds.

    `max_attempts` counts calls, not retries: 1 means no retry at all.
    `deadline` bounds the total time spent inside `call` (attempts plus
    sleeps); a sleep is truncated to the remaining budget and the next
    attempt is skipped if the budget is gone. `jitter` is the randomized
    fraction of each delay (0 = fully deterministic, 1 = full jitter).
    """

    max_attempts: int = 5
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline: Optional[float] = 30.0
    retryable: Callable[[BaseException], bool] = is_transient

    @staticmethod
    def from_env(prefix: str = "HOROVOD_RETRY", **defaults) -> "RetryPolicy":
        """Build a policy from `<prefix>_*` env vars over code defaults.

        Knobs: _MAX_ATTEMPTS, _BASE_DELAY, _MAX_DELAY, _MULTIPLIER,
        _JITTER, _DEADLINE (seconds; _DEADLINE <= 0 means unbounded time).
        """
        base = RetryPolicy(**defaults)
        deadline = _env_float(f"{prefix}_DEADLINE",
                              base.deadline if base.deadline is not None
                              else 0.0)
        return dataclasses.replace(
            base,
            max_attempts=_env_int(f"{prefix}_MAX_ATTEMPTS",
                                  base.max_attempts),
            base_delay=_env_float(f"{prefix}_BASE_DELAY", base.base_delay),
            max_delay=_env_float(f"{prefix}_MAX_DELAY", base.max_delay),
            multiplier=_env_float(f"{prefix}_MULTIPLIER", base.multiplier),
            jitter=_env_float(f"{prefix}_JITTER", base.jitter),
            deadline=deadline if deadline > 0 else None,
        )

    def delays(self, rng: Optional[random.Random] = None) -> Iterator[float]:
        """The backoff schedule: one delay per retry (max_attempts - 1).

        delay_i = min(base * multiplier^i, max_delay), with the last
        `jitter` fraction re-drawn uniformly so synchronized clients
        de-correlate.
        """
        rng = rng or random
        d = self.base_delay
        for _ in range(max(self.max_attempts - 1, 0)):
            capped = min(d, self.max_delay)
            yield capped * (1.0 - self.jitter) + \
                capped * self.jitter * rng.random()
            d *= self.multiplier

    def call(self, fn: Callable, *args, **kwargs):
        """Run `fn(*args, **kwargs)` under this policy.

        Retries only exceptions for which `retryable(e)` is True; others
        propagate immediately. Exhaustion (attempts or deadline) raises
        `RetryError` from the last failure.
        """
        start = time.monotonic()
        schedule = self.delays()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                if not self.retryable(e):
                    raise
                try:
                    delay = next(schedule)
                except StopIteration:
                    raise RetryError(
                        f"retries exhausted after {attempt} attempt(s): "
                        f"{e}") from e
                if self.deadline is not None:
                    remaining = self.deadline - (time.monotonic() - start)
                    if remaining <= 0:
                        raise RetryError(
                            f"retry deadline {self.deadline}s exceeded "
                            f"after {attempt} attempt(s): {e}") from e
                    delay = min(delay, remaining)
                time.sleep(delay)


# Default policy for rendezvous KV traffic: 8 attempts over ~6 s of
# backoff (cap 1 s) ride out a rendezvous-server restart.
KV_RETRY_DEFAULTS = dict(max_attempts=8, base_delay=0.05, max_delay=1.0,
                         deadline=30.0)


def kv_retry_policy(**overrides) -> RetryPolicy:
    """The rendezvous-KV policy (env prefix HOROVOD_KV_RETRY)."""
    merged = dict(KV_RETRY_DEFAULTS)
    merged.update(overrides)
    return RetryPolicy.from_env("HOROVOD_KV_RETRY", **merged)


# Discovery scripts flake for longer (cloud API hiccups); cap higher and
# let the elastic driver's loop re-arm the schedule
# (elastic/driver.py ElasticDriver._discover_loop).
DISCOVERY_RETRY_DEFAULTS = dict(max_attempts=6, base_delay=0.5,
                                max_delay=10.0, deadline=60.0)


def discovery_retry_policy(**overrides) -> RetryPolicy:
    """The host-discovery policy (env prefix HOROVOD_DISCOVERY_RETRY)."""
    merged = dict(DISCOVERY_RETRY_DEFAULTS)
    merged.update(overrides)
    return RetryPolicy.from_env("HOROVOD_DISCOVERY_RETRY", **merged)


class CircuitBreaker:
    """Closed → open → half-open breaker for control-plane targets.

    After `failure_threshold` consecutive failures the circuit opens and
    `call` fails fast with `CircuitOpenError` until `recovery_timeout`
    elapses; then one probe call is admitted (half-open): success closes
    the circuit, failure re-opens it for another window.
    """

    def __init__(self, failure_threshold: int = 5,
                 recovery_timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise HorovodError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.recovery_timeout = recovery_timeout
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.recovery_timeout:
            return "half_open"
        return "open"

    def allow(self) -> bool:
        """Admission check. In half-open, only one caller gets the probe."""
        with self._lock:
            s = self._state_locked()
            if s == "closed":
                return True
            if s == "half_open" and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._failures >= self.failure_threshold:
                self._opened_at = self._clock()

    def call(self, fn: Callable, *args, **kwargs):
        if not self.allow():
            remaining = 0.0
            with self._lock:
                if self._opened_at is not None:
                    remaining = max(
                        0.0, self.recovery_timeout -
                        (self._clock() - self._opened_at))
            raise CircuitOpenError(
                f"circuit open after {self._failures} consecutive "
                f"failure(s); retry in {remaining:.1f}s")
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out

