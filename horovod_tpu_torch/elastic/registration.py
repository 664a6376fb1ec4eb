"""Worker state registry (a copy of horovod_tpu/elastic/registration.py):
rendezvous barriers on worker lifecycle events.

Reference: horovod/runner/elastic/registration.py WorkerStateRegistry —
workers report READY/SUCCESS/FAILURE; the driver waits for a quorum before
(re)starting a rendezvous round, and a failure triggers a reset once the
remaining workers check in.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    def __init__(self, verbose: bool = False):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._states: Dict[int, str] = {}
        self._barrier_results: List[Dict[int, str]] = []

    def record(self, rank: int, state: str) -> None:
        with self._cond:
            self._states[rank] = state
            self._cond.notify_all()

    def record_ready(self, rank: int) -> None:
        self.record(rank, READY)

    def record_success(self, rank: int) -> None:
        self.record(rank, SUCCESS)

    def record_failure(self, rank: int) -> None:
        self.record(rank, FAILURE)

    def state_of(self, rank: int) -> Optional[str]:
        with self._lock:
            return self._states.get(rank)

    def count(self, state: str) -> int:
        with self._lock:
            return sum(1 for s in self._states.values() if s == state)

    def wait_for_states(self, ranks: Set[int], timeout: float = 600.0) -> bool:
        """Block until every rank in `ranks` has reported something."""
        with self._cond:
            return self._cond.wait_for(
                lambda: all(r in self._states for r in ranks), timeout)

    def reset(self, size: int) -> None:
        with self._cond:
            self._barrier_results.append(dict(self._states))
            self._states = {}
            self._cond.notify_all()

    def last_round(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._barrier_results[-1]) if self._barrier_results \
                else {}
