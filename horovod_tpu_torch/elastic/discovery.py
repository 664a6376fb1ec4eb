"""Host discovery for elastic training (a copy of
horovod_tpu/elastic/discovery.py on the port's runner/hosts.py).

Reference: horovod/runner/elastic/discovery.py — HostDiscoveryScript runs a
user script that prints "hostname:slots" per line (:113+); HostManager
tracks current hosts and blacklists hosts whose workers failed, with a
cooldown before retrying (:33-111).
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.runner.hosts import HostInfo


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        raise NotImplementedError


class FixedHosts(HostDiscovery):
    """Static host set (non-elastic fallback / tests)."""

    def __init__(self, hosts: Dict[str, int]):
        self.hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self.hosts)


class HostDiscoveryScript(HostDiscovery):
    """Runs the user's discovery script (reference: discovery.py:113).

    The script prints one "hostname" or "hostname:slots" per line; missing
    slots default to --slots-per-host.
    """

    def __init__(self, script: str, default_slots: int = 1):
        self.script = script
        self.default_slots = default_slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        try:
            out = subprocess.run(
                self.script, shell=True, capture_output=True, text=True,
                timeout=60).stdout
        except subprocess.TimeoutExpired:
            raise HorovodError(
                f"host discovery script timed out: {self.script}")
        hosts: Dict[str, int] = {}
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                name, slots = line.rsplit(":", 1)
                hosts[name] = int(slots)
            else:
                hosts[line] = self.default_slots
        return hosts


class _Blacklist:
    """Failed-host tracking with cooldown (reference: discovery.py:33-76
    CooldownPeriod in HostState). Repeated failures back off exponentially;
    the range is tunable (reference: --blacklist-cooldown-range,
    launch.py)."""

    INIT_COOLDOWN = 10.0
    MAX_COOLDOWN = 300.0

    def __init__(self, cooldown_range: Optional[tuple] = None):
        if cooldown_range is not None:
            self.INIT_COOLDOWN, self.MAX_COOLDOWN = cooldown_range
        self._entries: Dict[str, tuple] = {}  # host -> (until, count)
        self._lock = threading.Lock()

    def blacklist(self, host: str) -> None:
        with self._lock:
            _, count = self._entries.get(host, (0.0, 0))
            count += 1
            cooldown = min(self.INIT_COOLDOWN * (2 ** (count - 1)),
                           self.MAX_COOLDOWN)
            self._entries[host] = (time.monotonic() + cooldown, count)

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            entry = self._entries.get(host)
            if entry is None:
                return False
            until, _ = entry
            return time.monotonic() < until

    def count(self, host: str) -> int:
        with self._lock:
            return self._entries.get(host, (0.0, 0))[1]


class HostManager:
    """Tracks current/available hosts (reference: discovery.py HostManager)."""

    def __init__(self, discovery: HostDiscovery,
                 cooldown_range: Optional[tuple] = None):
        self._discovery = discovery
        self._blacklist = _Blacklist(cooldown_range)
        self._current: Dict[str, int] = {}
        self._lock = threading.Lock()

    def update_available_hosts(self) -> bool:
        """Poll discovery; returns True if the usable host set changed.

        May raise (discovery script failure): callers own the retry —
        ElasticDriver._discover_loop backs off under its RetryPolicy,
        wait_for_available_slots absorbs until its timeout. The poll is
        the `discovery.poll` fault-injection site (testing/faults.py).
        """
        from horovod_tpu_torch.testing import faults
        faults.inject("discovery.poll")
        found = self._discovery.find_available_hosts_and_slots()
        usable = {h: s for h, s in found.items()
                  if not self._blacklist.is_blacklisted(h)}
        with self._lock:
            changed = usable != self._current
            self._current = usable
            return changed

    def blacklist(self, host: str) -> None:
        self._blacklist.blacklist(host)
        with self._lock:
            self._current.pop(host, None)

    @property
    def current_hosts(self) -> List[HostInfo]:
        with self._lock:
            return [HostInfo(h, s) for h, s in sorted(self._current.items())]

    def available_slots(self) -> int:
        with self._lock:
            return sum(self._current.values())
