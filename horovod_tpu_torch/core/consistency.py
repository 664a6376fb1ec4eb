"""Cross-rank collective consistency checking (counterpart of
horovod_tpu/core/consistency.py).

Every process must issue identical collectives in identical order; a
violation is otherwise an undiagnosable deadlock. With the check on
(HOROVOD_CONSISTENCY_CHECK; by default in a launched job of two or more
ranks, where the launcher injects the native KV server), each call
first agrees on a 16-byte hash of its descriptor through the native KV
store's bitwise AND/OR and counted get (native/src/kv_store.cc):

  fast path   : every rank ORs and ANDs its hash; when all k arrived and
                OR == AND == own hash, everyone agreed. Four KV requests
                (a presence put, OR, AND, and the two counted gets).
  mismatch    : ranks publish their full descriptors and everyone raises
                CollectiveMismatchError (a TensorShapeMismatchError, as in
                the JAX package, and a CollectiveDivergenceError) naming
                each rank's call.
  missing rank: the counted get times out; presence keys name exactly
                which ranks never issued the collective.

Sequencing is per process set, and all keys carry an epoch prefix so a
shutdown()+init() cycle within one launch never replays against an
earlier incarnation's values. The eager collectives check once a call;
DistributedOptimizer's hook path once a step, on the step's bucket
plan, before its first bucket goes out (ops/collectives.py `dispatch`).

At init the checker's first round is a version handshake: every rank
agrees on (package version, protocol version), and a rank whose pair
differs from its peers', or from the one the launcher published in the
native KV (`LAUNCHER_VERSION_KEY`), raises VersionMismatchError.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.common import config as C
from horovod_tpu_torch.common.exceptions import (CollectiveMismatchError,
                                                 HorovodError,
                                                 VersionMismatchError)

#: The control-plane protocol's version: bump when the key layout or the
#: descriptor text changes.
PROTOCOL_VERSION = 1
#: Where the launcher publishes its version in the native KV.
LAUNCHER_VERSION_KEY = "version/launcher"


def version_string() -> str:
    from horovod_tpu_torch import __version__
    return f"horovod_tpu_torch={__version__},protocol={PROTOCOL_VERSION}"

_checker: Optional["ConsistencyChecker"] = None
# Counts init() incarnations in this process. Under the SPMD contract every
# rank's Nth init() pairs with every other rank's Nth, so (elastic round,
# init count) is a rank-agreed epoch without any extra coordination.
_init_count = 0

# Completed rounds are garbage-collected this many sequence numbers behind
# the newest, leaving a window the stall watcher can still read.
_GC_LAG = 8


class ConsistencyChecker:
    def __init__(self, client, rank: int, size: int, epoch: str,
                 timeout: float = 60.0):
        self._kv = client
        self.rank = rank
        self.size = size
        self.timeout = timeout
        self._pfx = f"cc/{epoch}"
        self._seq: Dict[str, int] = {}
        # Agreement rounds run (each a handful of KV requests).
        self.rounds = 0
        # (group, seq, ranks) of the most recent check, for lagging_ranks.
        self._last: Optional[Tuple[str, int, Tuple[int, ...]]] = None

    # ------------------------------------------------------------------ api
    def check(self, desc: str, ranks: Optional[Sequence[int]] = None,
              group: str = "world") -> None:
        """Agree with `ranks` (default: all) that their collective #seq on
        `group` is `desc`.

        Raises TensorShapeMismatchError on disagreement (naming ranks) and
        HorovodError on timeout (naming the ranks that never arrived).
        """
        members: Tuple[int, ...] = (tuple(ranks) if ranks is not None
                                    else tuple(range(self.size)))
        seq = self._seq.get(group, 0)
        self._seq[group] = seq + 1
        self.rounds += 1
        self._last = (group, seq, members)
        pfx = f"{self._pfx}/{group}"
        # NEGOTIATE span (reference: the timeline's NEGOTIATE_* phases,
        # common.h:83-116 — here the agreement round IS the negotiation).
        tl = None
        try:
            from horovod_tpu_torch.core import topology as _topo
            tl = _topo.raw_state().timeline
        except Exception:
            pass
        if tl is not None:
            tl.span_begin(f"{group}/{seq}", "NEGOTIATE")
        try:
            self._check_inner(pfx, seq, members, desc)
        finally:
            if tl is not None:
                tl.span_end(f"{group}/{seq}", "NEGOTIATE")

    def handshake(self, version: Optional[str] = None) -> None:
        """Agree with every rank, and with the launcher where it published
        its version, on `version` (default `version_string()`); raises
        VersionMismatchError naming the ranks' versions otherwise."""
        version = version or version_string()
        launcher = self._kv.get(LAUNCHER_VERSION_KEY)
        if launcher is not None and launcher.decode() != version:
            raise VersionMismatchError(
                f"rank {self.rank} runs {version} but its launcher runs "
                f"{launcher.decode()}")
        try:
            self.check(f"version({version})", group="version")
        except CollectiveMismatchError as e:
            raise VersionMismatchError(
                f"ranks run different versions:\n"
                f"{str(e).split(chr(10), 1)[-1]}") from None

    def _check_inner(self, pfx: str, seq: int,
                     members: Tuple[int, ...], desc: str) -> None:
        h = hashlib.sha256(desc.encode()).digest()[:16]
        self._kv.put(f"{pfx}/seen/{seq}/{self.rank}", b"1")
        self._kv.bitwise(f"{pfx}/or/{seq}", h, op="or")
        self._kv.bitwise(f"{pfx}/and/{seq}", h, op="and")
        combined_or = self._kv.get_when(f"{pfx}/or/{seq}",
                                        expected=len(members),
                                        timeout=self.timeout)
        if combined_or is None:
            self._raise_missing(pfx, seq, members, desc, "or")
        combined_and = self._kv.get_when(f"{pfx}/and/{seq}",
                                         expected=len(members),
                                         timeout=self.timeout)
        if combined_and is None:
            # A rank died between its OR and AND contributions (or the KV
            # dropped): that is a missing rank, not a program divergence.
            self._raise_missing(pfx, seq, members, desc, "and")
        if combined_or == h and combined_and == h:
            # Group rank 0 retires the round that is now _GC_LAG behind —
            # everyone contributed to `seq`, so no one can still be inside
            # check(seq - _GC_LAG) (KV entries would otherwise grow without
            # bound over a training run).
            if self.rank == members[0] and seq >= _GC_LAG:
                old = seq - _GC_LAG
                try:
                    self._kv.delete(f"{pfx}/or/{old}")
                    self._kv.delete(f"{pfx}/and/{old}")
                    for r in members:
                        self._kv.delete(f"{pfx}/seen/{old}/{r}")
                except Exception:
                    pass
            return
        # Disagreement: publish details, gather, raise a naming diagnostic.
        self._kv.put(f"{pfx}/detail/{seq}/{self.rank}", desc.encode())
        deadline = time.monotonic() + self.timeout
        details: List[str] = []
        for r in members:
            data = None
            while time.monotonic() < deadline:
                data = self._kv.get(f"{pfx}/detail/{seq}/{r}")
                if data is not None:
                    break
                time.sleep(0.01)
            details.append(f"  rank {r}: "
                           f"{data.decode() if data else '<no response>'}")
        raise CollectiveMismatchError(
            f"ranks disagree on collective #{seq}, the first divergent "
            f"call:\n" + "\n".join(details))

    def _raise_missing(self, pfx: str, seq: int,
                       members: Tuple[int, ...], desc: str,
                       phase: str) -> None:
        missing = self._missing(pfx, seq, members)
        raise HorovodError(
            f"consistency check ({phase}) timed out for collective #{seq} "
            f"('{desc}'): rank(s) {missing or '<unknown>'} never issued it "
            f"within {self.timeout:.0f}s: every member process must run "
            f"the same collectives in the same order")

    def _missing(self, pfx: str, seq: int,
                 members: Sequence[int]) -> List[int]:
        return [r for r in members
                if self._kv.get(f"{pfx}/seen/{seq}/{r}") is None]

    def lagging_ranks(self) -> List[int]:
        """Ranks that have not reached this process's last collective —
        surfaced in stall warnings so the report is coordinator-aware
        (reference: stall_inspector.cc names uncommitted ranks)."""
        if self._last is None:
            return []
        group, seq, members = self._last
        try:
            return self._missing(f"{self._pfx}/{group}", seq, members)
        except Exception:
            return []

    def close(self) -> None:
        try:
            self._kv.close()
        except Exception:
            pass


def maybe_init(cfg, rank: int, size: int) -> Optional[ConsistencyChecker]:
    """Build the process-wide checker from launcher-injected env.

    Requires the native KV server the launcher starts
    (HOROVOD_NATIVE_KV_ADDR/PORT); logs and disables otherwise.
    """
    global _checker, _init_count
    if _checker is not None:
        return _checker
    if size <= 1:
        return None
    addr = os.environ.get(C.HOROVOD_NATIVE_KV_ADDR, "")
    port = int(os.environ.get(C.HOROVOD_NATIVE_KV_PORT, "0") or 0)
    from horovod_tpu_torch.common.hvd_logging import get_logger
    if not addr or not port:
        get_logger().warning(
            "HOROVOD_CONSISTENCY_CHECK=1 but no native KV server address "
            "was injected (launcher too old or native build unavailable); "
            "consistency checking disabled")
        return None
    try:
        from horovod_tpu_torch.native import NativeKVClient
        client = NativeKVClient(addr, port)
    except Exception as e:
        get_logger().warning("consistency checking disabled: %s", e)
        return None
    timeout = float(os.environ.get(C.HOROVOD_CONSISTENCY_TIMEOUT, "60"))
    _init_count += 1
    round_env = os.environ.get("HOROVOD_ELASTIC_ROUND")
    # Elastic: the launcher-assigned round id is the rank-agreed epoch —
    # survivors (which bump it in-process on reset, elastic/__init__.py)
    # and fresh joiners share it, while per-process init counts would
    # diverge between them. Static launch: every rank's Nth init() pairs
    # under the SPMD contract, so the init count is agreed.
    epoch = f"r{round_env}" if round_env else f"i{_init_count}"
    checker = ConsistencyChecker(client, rank, size, epoch, timeout)
    try:
        checker.handshake()
    except BaseException:
        checker.close()
        raise
    _checker = checker
    return _checker


def get() -> Optional[ConsistencyChecker]:
    return _checker


def reset() -> None:
    global _checker
    if _checker is not None:
        _checker.close()
    _checker = None
