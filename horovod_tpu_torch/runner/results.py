"""Per-rank result and error collection for launched jobs (counterpart
of horovod_tpu/runner/results.py): a rank's exception travels back as
data, and the driver raises one RemoteJobError naming every failed rank.
"""

from __future__ import annotations

import traceback
from typing import Any, Callable, Dict, List, Tuple

from horovod_tpu_torch.common.exceptions import HorovodError


class RemoteJobError(HorovodError):
    """One or more ranks failed; the message names each failed rank with
    its remote traceback."""


def capture(fn: Callable, *args, **kwargs) -> Tuple[bool, Any]:
    """Run `fn`, returning (ok, result-or-formatted-traceback). Workers use
    this so a user-code exception travels back as data."""
    try:
        return True, fn(*args, **kwargs)
    except BaseException:  # noqa: BLE001 — the driver re-raises
        return False, traceback.format_exc()


class PerRankResults:
    """Collects (rank, ok, payload) tuples; orders results; raises a
    summarizing RemoteJobError if any rank failed."""

    def __init__(self, size: int):
        self.size = size
        self._by_rank: Dict[int, Tuple[bool, Any]] = {}

    def add(self, rank: int, ok: bool, payload: Any) -> None:
        self._by_rank[rank] = (ok, payload)

    @property
    def failed_ranks(self) -> List[int]:
        return sorted(r for r, (ok, _) in self._by_rank.items() if not ok)

    @property
    def missing_ranks(self) -> List[int]:
        return [r for r in range(self.size) if r not in self._by_rank]

    def values(self) -> List[Any]:
        """Rank-ordered results; raises RemoteJobError on any failure or
        missing rank."""
        bad = self.failed_ranks
        missing = self.missing_ranks
        if bad or missing:
            parts = []
            if missing:
                parts.append(f"rank(s) {missing} returned no result")
            for r in bad:
                parts.append(f"rank {r} failed:\n{self._by_rank[r][1]}")
            raise RemoteJobError(
                f"{len(bad)} of {self.size} rank(s) failed"
                + (f", {len(missing)} missing" if missing else "") + ":\n"
                + "\n".join(parts))
        return [self._by_rank[r][1] for r in range(self.size)]


class RestartPolicy:
    """Decides whether a failed worker may be restarted (reference:
    ray/elastic_v2.py retries failed workers within limits)."""

    def __init__(self, max_restarts: int = 3):
        self.max_restarts = max_restarts
        self._restarts: Dict[int, int] = {}

    def should_restart(self, rank: int) -> bool:
        return self._restarts.get(rank, 0) < self.max_restarts

    def record_restart(self, rank: int) -> int:
        self._restarts[rank] = self._restarts.get(rank, 0) + 1
        return self._restarts[rank]

    def restarts(self, rank: int) -> int:
        return self._restarts.get(rank, 0)
