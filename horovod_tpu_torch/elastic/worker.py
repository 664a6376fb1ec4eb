"""Worker-side elastic notification + re-rendezvous (a copy of
horovod_tpu/elastic/worker.py on the port's rendezvous KV client).

Reference: horovod/runner/elastic/worker.py — WorkerNotificationService runs
an HTTP server inside every worker and the driver PUSHES host-change events
into it, raising HostsUpdatedInterrupt at the next `state.commit()`.

Design: workers POLL the launcher's rendezvous KV (scope "elastic")
for a round bump instead of running one server per worker. The driver
publishes each round's per-slot assignments *before* bumping the round key,
so by the time a worker observes the bump its new assignment (or its
removal) is already readable. Polling at sub-second cadence is
indistinguishable from push at training-step timescales and leaves the
worker with zero listening sockets.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

from horovod_tpu_torch.common.exceptions import (HorovodError,
                                                 HostsUpdatedInterrupt)

SCOPE = "elastic"
POLL_INTERVAL = 0.25

_notifier: Optional["WorkerNotificationClient"] = None


class WorkerNotificationClient:
    """Watches the rendezvous KV for new elastic rounds.

    Identity is (hostname, local_rank) — the slot key the driver preserves
    across rounds (reference: _update_host_assignments keeps running
    workers' host/slot, runner/elastic/driver.py:240).
    """

    def __init__(self, kv, hostname: str, local_rank: int, round_id: int):
        self._kv = kv
        self.hostname = hostname
        self.local_rank = local_rank
        self.round_id = round_id
        self._pending = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._poll_loop, name="hvd-elastic-notify", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- KV reads
    def current_round(self) -> int:
        try:
            data = self._kv.get(SCOPE, "round", timeout=0.0)
        except Exception:
            return self.round_id
        if not data:
            return self.round_id
        try:
            return int(data.decode())
        except ValueError:
            return self.round_id

    def fetch_assignment(self, round_id: int) -> Optional[Dict]:
        """This slot's assignment for `round_id`; None = removed from job."""
        data = self._kv.get(
            SCOPE, f"assign/{round_id}/{self.hostname}/{self.local_rank}",
            timeout=5.0)
        if not data:
            return None
        return json.loads(data.decode())

    # ------------------------------------------------------------ lifecycle
    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            if self.current_round() > self.round_id:
                self._pending.set()
            self._stop.wait(POLL_INTERVAL)

    def check(self) -> None:
        """Raise HostsUpdatedInterrupt if the driver started a new round
        (called from State.commit / check_host_updates; reference:
        State._handle_host_updates)."""
        if self._pending.is_set():
            raise HostsUpdatedInterrupt(skip_sync=False)

    def wait_for_new_round(self, timeout: float = 600.0) -> int:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            r = self.current_round()
            if r > self.round_id:
                return r
            time.sleep(POLL_INTERVAL)
        raise HorovodError(
            f"timed out after {timeout}s waiting for a new elastic round "
            f"(current round {self.round_id})")

    def advance(self, round_id: int) -> None:
        self.round_id = round_id
        self._pending.clear()

    def stop(self) -> None:
        self._stop.set()


def maybe_init_notifier() -> Optional[WorkerNotificationClient]:
    """Build the process-wide notifier from launcher-injected env, once.
    Returns None outside elastic launches (unit tests, static runs)."""
    global _notifier
    if _notifier is not None:
        return _notifier
    from horovod_tpu_torch.common import config as C
    if os.environ.get(C.HOROVOD_ELASTIC, "") not in ("1", "true"):
        return None
    addr = os.environ.get(C.HOROVOD_RENDEZVOUS_ADDR, "")
    port = int(os.environ.get(C.HOROVOD_RENDEZVOUS_PORT, "0") or 0)
    host = os.environ.get("HOROVOD_HOSTNAME", "")
    if not addr or not port or not host:
        return None
    from horovod_tpu_torch.runner.rendezvous import KVClient
    _notifier = WorkerNotificationClient(
        KVClient(addr, port), host,
        int(os.environ.get("HOROVOD_LOCAL_RANK", "0") or 0),
        int(os.environ.get("HOROVOD_ELASTIC_ROUND", "0") or 0))
    return _notifier


def get_notifier() -> Optional[WorkerNotificationClient]:
    return _notifier


def stop_notifier() -> None:
    global _notifier
    if _notifier is not None:
        _notifier.stop()
        _notifier = None


def _set_notifier_for_test(n) -> None:
    global _notifier
    _notifier = n
