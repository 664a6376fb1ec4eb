"""Retry/backoff policies, circuit breaking and the pure-Python stall
inspector for the control plane (counterpart of
horovod_tpu/common/resilience.py).

Every control-plane hop (rendezvous KV, discovery poll, worker
notification) routes its transient failures through one `RetryPolicy`:
jittered exponential backoff with an attempt bound and an overall
deadline, so no caller retries without end. Exhaustion raises
`RetryError` (the last failure as `__cause__`); an open `CircuitBreaker`
raises `CircuitOpenError`. The breaker is opt-in, for launcher-side
fan-out, never the default KV path. Jitter draws from an injectable
`random.Random`, so the fault-injection suite (testing/faults.py)
replays identical schedules from a seed.

Named policies count their retries and exhaustions, and the breaker its
transitions, in the metrics registry (`horovod_retry_*`,
`horovod_circuit_transitions_total`), and each failure-path event is a
flight-recorder `resilience` record (observability/).

`PyStallInspector` is the stall inspector's contract in Python, used
where the native library does not build (native/), so the collectives'
stall watchdog never degrades to an unwatched wait.

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
from horovod_tpu_torch.common.exceptions import (CircuitOpenError, HorovodError,
                                           RetryError)

_mx = None


def _metrics():
    """Lazy retry/breaker instrument handles (observability/metrics.py;
    refreshed if the registry is reset under test). Series are touched at
    policy creation so a healthy job still scrapes explicit zeros for
    its retry counters instead of an absent metric."""
    global _mx
    from horovod_tpu_torch.observability import metrics as m
    reg = m.registry()
    if _mx is None or _mx[0] is not reg:
        _mx = (reg, {
            "retries": reg.counter(
                "horovod_retry_attempts_total",
                "Retries performed after a transient failure",
                labelnames=("policy",)),
            "exhausted": reg.counter(
                "horovod_retry_exhausted_total",
                "RetryError raises (attempt or deadline budget spent)",
                labelnames=("policy",)),
            "breaker": reg.counter(
                "horovod_circuit_transitions_total",
                "CircuitBreaker state transitions",
                labelnames=("state",)),
        })
    return _mx[1]


def _flight_event(desc: str) -> None:
    """Retry/breaker events feed the flight recorder's ring
    (observability/flight.py) — failure-path only, never the success
    path, so healthy control-plane traffic records nothing."""
    try:
        from horovod_tpu_torch.observability import flight
        flight.record("resilience", desc)
    except Exception:
        pass


def is_transient(e: BaseException) -> bool:
    """Default retryable predicate: transport-level failures and HTTP 5xx.

    Covers what a rendezvous-server restart or network blip produces:
    connection refused/reset, timeouts, unreachable peers, and 5xx from a
    proxy or a half-started server. 4xx (403 auth rejection, 404 missing
    key) is NOT transient — retrying would mask a real error.
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
    `deadline` bounds the TOTAL time spent inside `call` (attempts plus
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
    # Metrics label for this policy's retry/exhaustion counters; ""
    # disables per-policy instrumentation (ad-hoc inline policies).
    name: str = ""

    def __post_init__(self) -> None:
        if self.name:
            mx = _metrics()
            mx["retries"].labels(policy=self.name)
            mx["exhausted"].labels(policy=self.name)

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
        de-correlate (full-jitter style).
        """
        rng = rng or random
        d = self.base_delay
        for _ in range(max(self.max_attempts - 1, 0)):
            capped = min(d, self.max_delay)
            yield capped * (1.0 - self.jitter) + \
                capped * self.jitter * rng.random()
            d *= self.multiplier

    def call(self, fn: Callable, *args,
             rng: Optional[random.Random] = None,
             on_retry: Optional[Callable[[int, BaseException, float],
                                         None]] = None,
             **kwargs):
        """Run `fn(*args, **kwargs)` under this policy.

        Retries only exceptions for which `retryable(e)` is True; others
        propagate immediately. Exhaustion (attempts or deadline) raises
        `RetryError` from the last failure. `on_retry(attempt, exc, delay)`
        is invoked before each sleep (logging / test hooks).
        """
        start = time.monotonic()
        schedule = self.delays(rng)
        attempt = 0
        mx = _metrics() if self.name else None
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
                    if mx is not None:
                        mx["exhausted"].labels(policy=self.name).inc()
                    _flight_event(f"retry policy '{self.name or 'inline'}' "
                                  f"exhausted after {attempt} attempt(s): "
                                  f"{e}")
                    raise RetryError(
                        f"retries exhausted after {attempt} attempt(s): "
                        f"{e}") from e
                if self.deadline is not None:
                    remaining = self.deadline - (time.monotonic() - start)
                    if remaining <= 0:
                        if mx is not None:
                            mx["exhausted"].labels(policy=self.name).inc()
                        _flight_event(
                            f"retry policy '{self.name or 'inline'}' "
                            f"deadline {self.deadline}s exceeded after "
                            f"{attempt} attempt(s): {e}")
                        raise RetryError(
                            f"retry deadline {self.deadline}s exceeded "
                            f"after {attempt} attempt(s): {e}") from e
                    delay = min(delay, remaining)
                if mx is not None:
                    mx["retries"].labels(policy=self.name).inc()
                _flight_event(f"retry policy '{self.name or 'inline'}' "
                              f"attempt {attempt} failed ({e}); retrying "
                              f"in {delay:.2f}s")
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                time.sleep(delay)


# Default policy for rendezvous KV traffic. A rendezvous-server restart
# takes O(100ms) on loopback and O(s) across a pod; 8 attempts over ~6 s of
# backoff (cap 1 s) rides out a restart without hammering a dead endpoint.
KV_RETRY_DEFAULTS = dict(max_attempts=8, base_delay=0.05, max_delay=1.0,
                         deadline=30.0, name="kv")
# Discovery scripts flake for longer (cloud API hiccups); cap higher and
# let the driver loop re-arm the schedule — see ElasticDriver._discover_loop.
DISCOVERY_RETRY_DEFAULTS = dict(max_attempts=6, base_delay=0.5,
                                max_delay=10.0, deadline=60.0,
                                name="discovery")


def kv_retry_policy(**overrides) -> RetryPolicy:
    """The rendezvous-KV policy (env prefix HOROVOD_KV_RETRY)."""
    merged = dict(KV_RETRY_DEFAULTS)
    merged.update(overrides)
    return RetryPolicy.from_env("HOROVOD_KV_RETRY", **merged)


def discovery_retry_policy(**overrides) -> RetryPolicy:
    """The host-discovery policy (env prefix HOROVOD_DISCOVERY_RETRY)."""
    merged = dict(DISCOVERY_RETRY_DEFAULTS)
    merged.update(overrides)
    return RetryPolicy.from_env("HOROVOD_DISCOVERY_RETRY", **merged)


class CircuitBreaker:
    """Classic closed → open → half-open breaker for control-plane targets.

    After `failure_threshold` consecutive failures the circuit opens and
    `call` fails fast with `CircuitOpenError` (no network traffic) until
    `recovery_timeout` elapses; then one probe call is admitted
    (half-open) — success closes the circuit, failure re-opens it for
    another window. Protects a struggling rendezvous/discovery endpoint
    from a retry stampede of 10k workers (the ROADMAP's production-scale
    north star), which bare per-client retries would amplify.
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
        """Admission check. In half-open, only ONE caller gets the probe."""
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
            reopened = self._opened_at is not None
            self._failures = 0
            self._opened_at = None
            self._probing = False
        if reopened:
            _metrics()["breaker"].labels(state="closed").inc()
            _flight_event("circuit breaker closed (probe succeeded)")

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            opened = False
            if self._failures >= self.failure_threshold:
                opened = self._opened_at is None
                self._opened_at = self._clock()
            failures = self._failures
        if opened:
            _metrics()["breaker"].labels(state="open").inc()
            _flight_event(f"circuit breaker opened after {failures} "
                          f"consecutive failure(s)")

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


class PyStallInspector:
    """Pure-Python StallInspector with the native binding's contract
    (native/__init__.py:247; stall.cc). Used when the native library is
    unavailable (no toolchain), so the stall watchdog — and therefore
    bounded collective waits in elastic mode — never silently degrades
    to an unwatched hang.
    """

    def __init__(self, warn_sec: float = 60.0, shutdown_sec: float = 0.0):
        self.warn_sec = warn_sec
        self.shutdown_sec = shutdown_sec
        self._pending: dict = {}
        self._lock = threading.Lock()

    def submit(self, name: str) -> None:
        with self._lock:
            self._pending.setdefault(name, time.monotonic())

    def done(self, name: str) -> None:
        with self._lock:
            self._pending.pop(name, None)

    def check(self) -> tuple:
        """Returns (stalled_names, shutdown) like the native binding."""
        now = time.monotonic()
        stalled, shut = [], False
        with self._lock:
            for name, t0 in self._pending.items():
                age = now - t0
                if age >= self.warn_sec:
                    stalled.append(name)
                if self.shutdown_sec > 0 and age >= self.shutdown_sec:
                    shut = True
        return stalled, shut

    def free(self) -> None:
        with self._lock:
            self._pending.clear()
