"""Host/slot parsing and rank allocation (counterpart of
horovod_tpu/runner/hosts.py, itself after horovod/runner/common/util/
hosts.py). A slot is one GPU: one worker process per GPU, ranks
contiguous per host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from horovod_tpu_torch.common.exceptions import HorovodError


@dataclasses.dataclass(frozen=True)
class HostInfo:
    hostname: str
    slots: int


@dataclasses.dataclass(frozen=True)
class SlotInfo:
    """Env identity for one worker (reference: injected env,
    runner/gloo_run.py:69-75)."""
    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int

    def to_env(self) -> Dict[str, str]:
        return {
            "HOROVOD_HOSTNAME": self.hostname,
            "HOROVOD_RANK": str(self.rank),
            "HOROVOD_SIZE": str(self.size),
            "HOROVOD_LOCAL_RANK": str(self.local_rank),
            "HOROVOD_LOCAL_SIZE": str(self.local_size),
            "HOROVOD_CROSS_RANK": str(self.cross_rank),
            "HOROVOD_CROSS_SIZE": str(self.cross_size),
        }


def parse_hosts(hosts: str) -> List[HostInfo]:
    """Parse "host1:4,host2:4" (reference: hosts.py parse_hosts)."""
    out: List[HostInfo] = []
    for part in hosts.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots = part.rsplit(":", 1)
            try:
                n = int(slots)
            except ValueError:
                raise HorovodError(f"bad host spec '{part}': slot count "
                                      f"must be an integer")
        else:
            name, n = part, 1
        if n <= 0:
            raise HorovodError(f"bad host spec '{part}': slots must be >0")
        out.append(HostInfo(name, n))
    if not out:
        raise HorovodError(f"no hosts in spec '{hosts}'")
    return out


def get_host_assignments(hosts: List[HostInfo], np: int) -> List[SlotInfo]:
    """Assign np ranks to host slots, ranks contiguous per host (reference:
    hosts.py get_host_assignments — same ordering contract)."""
    total = sum(h.slots for h in hosts)
    if np > total:
        raise HorovodError(
            f"requested np={np} exceeds available slots {total}")
    assignments: List[SlotInfo] = []
    rank = 0
    # First pass: how many ranks each host actually gets.
    per_host: List[int] = []
    remaining = np
    for h in hosts:
        take = min(h.slots, remaining)
        per_host.append(take)
        remaining -= take
    for hi, (h, n) in enumerate(zip(hosts, per_host)):
        for local_rank in range(n):
            # Cross communicator groups equal local_ranks across hosts
            # (reference: MPIContext cross communicator, mpi_context.h:104):
            # only hosts that actually have this local_rank participate.
            peers = [j for j, m in enumerate(per_host) if m > local_rank]
            assignments.append(SlotInfo(
                hostname=h.hostname, rank=rank, size=np,
                local_rank=local_rank, local_size=n,
                cross_rank=peers.index(hi), cross_size=len(peers)))
            rank += 1
    return assignments
