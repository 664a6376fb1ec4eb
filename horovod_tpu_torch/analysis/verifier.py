"""Cross-rank collective fingerprint verifier, HOROVOD_CHECK_COLLECTIVES
(counterpart of horovod_tpu/analysis/verifier.py; the fingerprints are
the JAX package's for the same descriptors).

Every rank hashes its rolling sequence of collective descriptors at the
dispatch choke point (ops/collectives.py `dispatch`) and, every
``HOROVOD_CHECK_COLLECTIVES_INTERVAL`` calls, publishes the fingerprint
to the launcher's rendezvous KV and compares its ring successor's
already-published checkpoints (adjacent-pair equality is enough, and
keeps the KV load at O(1) per rank per interval). A divergent rank
raises CollectiveDivergenceError naming the rank, the call index, both
fingerprints and, from a retained window of recent descriptors, the
first divergent call.

Sequences are scoped per process set, like the consistency checker's
(core/consistency.py): only member ranks dispatch on a subset set.
Unlike that synchronous per-call round, this verifier costs one hash
update a call and a few small KV requests an interval, at the price of
detection up to two intervals late. When the stall watchdog fires
while the verifier is active, `stall_context()` is appended to its
HorovodInternalError: the last agreed call index and the first
divergent call.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.common.exceptions import CollectiveDivergenceError

#: Rendezvous-KV scope all verifier keys live under.
SCOPE = "checkfp"

#: Checkpoints kept behind the cluster-wide acknowledged watermark
#: before this rank garbage-collects its own KV keys.
_GC_LAG = 8

_verifier: Optional["FingerprintVerifier"] = None
_init_count = 0


class _GroupState:
    """One process set's rolling fingerprint + cross-check bookkeeping.

    Verification is a RING, not all-pairs: each member verifies only
    its successor among the group's members. If any two ranks' call
    sequences differ, some adjacent pair along the ring differs
    (equality is transitive), so the divergent rank is still caught —
    at O(1) KV reads per checkpoint per rank instead of O(size),
    which is what keeps the verifier production-viable at 256+ ranks
    against a single rendezvous server.
    """

    __slots__ = ("members", "peers", "readers", "calls", "rolling",
                 "pending", "segments", "next_verify", "last_agreed",
                 "oldest_kept", "skipped")

    def __init__(self, members: Tuple[int, ...], rank: int,
                 interval: int) -> None:
        self.members = members
        pos = members.index(rank)
        succ = members[(pos + 1) % len(members)]
        pred = members[(pos - 1) % len(members)]
        # Whom this rank verifies, and who verifies (reads) this rank —
        # the GC floor follows the READERS' acks, since they are the
        # ones still needing our keys.
        self.peers = (succ,) if succ != rank else ()
        self.readers = (pred,) if pred != rank else ()
        self.calls = 0
        self.rolling = hashlib.sha256()
        self.pending: List[str] = []
        # checkpoint idx -> (fingerprint hex, [desc per call in the
        # preceding interval]); pruned to ~window calls.
        self.segments: Dict[int, Tuple[str, List[str]]] = {}
        # next checkpoint index to verify, per peer.
        self.next_verify: Dict[int, int] = {p: interval for p in self.peers}
        # newest checkpoint this rank has verified against every peer.
        self.last_agreed = 0
        # oldest own checkpoint whose KV keys have not been GC'd yet.
        self.oldest_kept = interval
        # checkpoints that could no longer be compared because our
        # retained window had already been pruned (peer > window calls
        # behind) — surfaced in stall_context, never counted as agreed
        # silently.
        self.skipped = 0


class FingerprintVerifier:
    """Rolling per-process-set fingerprints with periodic KV cross-checks.

    ``record()`` is the hot path: a sha256 update and a list append
    under a short lock. KV traffic happens only at checkpoint
    boundaries, outside the lock, and peer reads are single-attempt
    (non-blocking): a peer that has not published yet is the stall
    watchdog's problem, not a reason to stall *this* rank.
    """

    def __init__(self, kv, rank: int, size: int, epoch: str,
                 interval: int = 10, window: int = 512,
                 diagnose_timeout: float = 5.0) -> None:
        self._kv = kv
        self.rank = rank
        self.size = size
        self.interval = max(1, interval)
        self.window = max(self.interval, window)
        self.diagnose_timeout = diagnose_timeout
        self._pfx = f"{epoch}"
        self._lock = threading.Lock()
        self._groups: Dict[str, _GroupState] = {}  # guarded-by: _lock
        # Serializes cross-check bookkeeping (next_verify / last_agreed
        # / oldest_kept walks) between the dispatch thread's checkpoint
        # path and the stall watchdog's stall_context() probe. Distinct
        # from _lock: KV reads happen under it, and the record() hot
        # path must never wait on the network.
        self._check_lock = threading.Lock()
        self.divergence: Optional[str] = None
        self._kv_down_logged = False
        self._mx_cache = None

    # ----------------------------------------------------------- metrics
    def _mx(self):
        from horovod_tpu_torch.observability import metrics as m
        reg = m.registry()
        if self._mx_cache is None or self._mx_cache[0] is not reg:
            self._mx_cache = (reg, {
                "checkpoints": reg.counter(
                    "horovod_check_collectives_checkpoints_total",
                    "Fingerprint checkpoints published"),
                "agreed": reg.gauge(
                    "horovod_check_collectives_last_agreed_index",
                    "Newest call index all ranks' fingerprints agree on",
                    labelnames=("group",)),
                "mismatch": reg.counter(
                    "horovod_check_collectives_mismatches_total",
                    "Cross-rank fingerprint mismatches detected"),
            })
        return self._mx_cache[1]

    def last_agreed_index(self, group: str = "world") -> int:
        """Newest call index of `group` verified against every peer."""
        with self._lock:
            gs = self._groups.get(group)
            return gs.last_agreed if gs is not None else 0

    # ------------------------------------------------------------- record
    def record(self, desc: str, ranks: Optional[Sequence[int]] = None,
               group: str = "world") -> None:
        """Fold one dispatched collective into `group`'s fingerprint.

        `desc` is the full call descriptor
        ``op(signature)|name=...``; `ranks` are the process set's member
        ranks (None ⇒ the whole world), the same scoping the
        consistency checker uses. Raises CollectiveDivergenceError when
        a checkpoint cross-check catches a peer whose fingerprint for
        this group differs.
        """
        members: Tuple[int, ...] = (tuple(ranks) if ranks is not None
                                    else tuple(range(self.size)))
        if self.rank not in members:
            return  # defensive: non-members never dispatch on the set
        with self._lock:
            gs = self._groups.get(group)
            if gs is None:
                gs = _GroupState(members, self.rank, self.interval)
                self._groups[group] = gs
            gs.rolling.update(desc.encode("utf-8"))
            gs.rolling.update(b"\x00")
            gs.pending.append(desc)
            gs.calls += 1
            if gs.calls % self.interval:
                return
            idx = gs.calls
            fp = gs.rolling.hexdigest()
            gs.segments[idx] = (fp, gs.pending)
            gs.pending = []
            # Prune retained segments beyond the window (plus slack for
            # peers lagging up to the GC horizon).
            horizon = idx - max(self.window, _GC_LAG * self.interval)
            for old in [i for i in gs.segments if i <= horizon]:
                del gs.segments[old]
        self._checkpoint(group, gs, idx, fp)

    # --------------------------------------------------------- checkpoint
    def _key(self, group: str, kind: str, rank: int, idx: int) -> str:
        return f"{self._pfx}/{group}/{kind}/{rank}/{idx}"

    def _ack_key(self, group: str, rank: int) -> str:
        return f"{self._pfx}/{group}/ack/{rank}"

    def _checkpoint(self, group: str, gs: _GroupState, idx: int,
                    fp: str) -> None:
        """Publish checkpoint `idx`, then verify peer checkpoints at
        least one interval OLDER (single-attempt reads).

        The one-interval lag is what makes detection deterministic and
        hang-free on synchronous backends: by the time this rank records
        call `idx` it has completed collective `idx-1`, which required
        every group member to have *dispatched* its own call `idx-1` —
        so every member's checkpoint `idx - interval` is already
        published. Comparing the same-index checkpoint instead would
        race: the first rank to detect would stop dispatching while a
        peer still has an unpaired collective in flight, turning a clean
        diagnosis back into the stall it was meant to prevent.
        """
        with self._lock:
            segment = gs.segments.get(idx, (fp, []))[1]
        # A rendezvous-KV blip must degrade the DIAGNOSTIC, never fail
        # the training step it rides on: skip the checkpoint (peers see
        # a missing fingerprint and simply stop advancing at it).
        try:
            self._kv.put(SCOPE, self._key(group, "fp", self.rank, idx),
                         fp.encode("ascii"))
            self._kv.put(SCOPE, self._key(group, "win", self.rank, idx),
                         json.dumps(segment).encode("utf-8"))
        except Exception as e:
            self._kv_trouble(f"checkpoint publish failed: {e}")
            return
        self._mx()["checkpoints"].inc()
        self._verify_available(group, gs, upto=idx - self.interval)

    def _kv_trouble(self, what: str) -> None:
        if self._kv_down_logged:
            return
        self._kv_down_logged = True
        try:
            from horovod_tpu_torch.common.hvd_logging import get_logger
            get_logger().warning(
                "HOROVOD_CHECK_COLLECTIVES: rendezvous KV unavailable "
                "(%s); fingerprint cross-checking degraded until it "
                "recovers", what)
        except Exception:
            pass

    def _peer_fp(self, group: str, peer: int, j: int,
                 timeout: float) -> Optional[bytes]:
        """One peer fingerprint read; transport trouble reads as
        'not published yet' rather than failing the collective."""
        try:
            v = self._kv.get(SCOPE, self._key(group, "fp", peer, j),
                             timeout=timeout)
            self._kv_down_logged = False
            return v
        except Exception as e:
            self._kv_trouble(f"fingerprint read failed: {e}")
            return None

    def _verify_available(self, group: str, gs: _GroupState, upto: int,
                          peer_timeout: float = 0.0) -> None:
        """Compare every peer checkpoint published so far (≤ `upto`)
        against ours; advance the agreement watermark or raise.

        Serialized by _check_lock: the stall watchdog thread probes the
        same per-group bookkeeping via stall_context() while the
        dispatch thread checkpoints."""
        with self._check_lock:
            for peer in gs.peers:
                while gs.next_verify[peer] <= upto:
                    j = gs.next_verify[peer]
                    theirs = self._peer_fp(group, peer, j, peer_timeout)
                    if theirs is None:
                        break  # peer not there yet — never block on it
                    with self._lock:
                        seg = gs.segments.get(j)
                    if seg is None:
                        # Our window for j was pruned (peer is >window
                        # calls behind): the compare is lost forever.
                        # Advance (nothing left to hold for) but count
                        # it — these calls are NOT agreed, and
                        # stall_context says so.
                        gs.skipped += 1
                    elif theirs.decode("ascii") != seg[0]:
                        self._mx()["mismatch"].inc()
                        self._raise_divergence(group, gs, peer, j,
                                               seg[0],
                                               theirs.decode("ascii"))
                    gs.next_verify[peer] = j + self.interval
            agreed = min((v - self.interval
                          for v in gs.next_verify.values()),
                         default=upto)
            if agreed > gs.last_agreed:
                gs.last_agreed = agreed
                self._mx()["agreed"].labels(group=group).set(agreed)
                # Publish how far WE have verified, so peers can GC
                # keys we no longer need (and vice versa).
                try:
                    self._kv.put(SCOPE, self._ack_key(group, self.rank),
                                 str(agreed).encode("ascii"))
                except Exception:
                    pass
                self._gc(group, gs)

    def _gc(self, group: str, gs: _GroupState) -> None:
        """Drop this rank's own KV keys below the watermark every peer
        has ACKNOWLEDGED verifying (their published ack), minus slack.

        This rank's own `last_agreed` says nothing about how far peers
        have read — GC keyed on it alone could delete fingerprints a
        lagging peer still needs, silently disabling its cross-checks.
        Missing acks simply pause GC; correctness never depends on it.
        """
        floor = gs.last_agreed
        try:
            for reader in gs.readers:
                raw = self._kv.get(SCOPE, self._ack_key(group, reader),
                                   timeout=0.0)
                if raw is None:
                    return  # our reader hasn't verified anything yet
                floor = min(floor, int(raw.decode("ascii")))
        except Exception:
            return  # GC is best-effort; never fail a collective on it
        floor -= _GC_LAG * self.interval
        while gs.oldest_kept <= floor:
            idx = gs.oldest_kept
            try:
                self._kv.delete(SCOPE,
                                self._key(group, "fp", self.rank, idx))
                self._kv.delete(SCOPE,
                                self._key(group, "win", self.rank, idx))
            except Exception:
                return
            gs.oldest_kept = idx + self.interval

    # --------------------------------------------------------- divergence
    def _first_divergent(self, group: str, gs: _GroupState, peer: int,
                         idx: int) -> Optional[Tuple[int, str, str]]:
        """(call index, our desc, their desc) of the first differing
        call in checkpoint `idx`'s window, if the peer's window segment
        is still fetchable."""
        raw = self._kv.get(SCOPE, self._key(group, "win", peer, idx),
                           timeout=self.diagnose_timeout)
        if raw is None:
            return None
        try:
            their_seg = json.loads(raw.decode("utf-8"))
        except ValueError:
            return None
        with self._lock:
            seg = gs.segments.get(idx)
        our_seg = seg[1] if seg is not None else []
        base = idx - self.interval
        for off in range(max(len(our_seg), len(their_seg))):
            mine = our_seg[off] if off < len(our_seg) else "<no call>"
            theirs = their_seg[off] if off < len(their_seg) else "<no call>"
            if mine != theirs:
                return base + off, mine, theirs
        return None

    def _raise_divergence(self, group: str, gs: _GroupState, peer: int,
                          idx: int, ours: str, theirs: str) -> None:
        detail = ""
        div = self._first_divergent(group, gs, peer, idx)
        if div is not None:
            call_idx, mine, their_desc = div
            detail = (f"; first divergent call #{call_idx}: rank "
                      f"{self.rank} issued '{mine}', rank {peer} "
                      f"issued '{their_desc}'")
        where = "" if group == "world" else f" on process set '{group}'"
        msg = (
            f"cross-rank collective divergence detected by "
            f"HOROVOD_CHECK_COLLECTIVES{where}: rank {peer} is out of "
            f"step with rank {self.rank} at call #{idx} — fingerprint "
            f"{ours[:16]} (rank {self.rank}) != {theirs[:16]} "
            f"(rank {peer}); last agreed checkpoint call "
            f"#{gs.last_agreed}{detail}. Every rank must issue the "
            f"same collectives in the same order (run "
            f"'python -m horovod_tpu_torch.analysis' on the training "
            f"script to find the rank-dependent call)")
        self.divergence = msg
        # Divergence is a flight-dump trigger: every rank's ring holds
        # the exact call sequence that disagreed, and the doctor can
        # merge the dumps into the full cross-rank story
        # (observability/flight.py; never let a broken dump mask the
        # divergence itself).
        try:
            from horovod_tpu_torch.observability import flight as _fl
            _fl.record("divergence", msg)
            _fl.dump("divergence")
            msg += _fl.dump_hint()
        except Exception:
            pass
        raise CollectiveDivergenceError(msg)

    # -------------------------------------------------------------- stall
    def stall_context(self) -> str:
        """One-line diagnosis for the stall watchdog: who is behind or
        divergent, as of the freshest KV state (bounded, best-effort
        reads — the watchdog has seconds to spare, the hot path does
        not)."""
        if self.divergence is not None:
            return self.divergence
        with self._lock:
            groups = list(self._groups.items())
        parts: List[str] = []
        for group, gs in groups:
            with self._lock:
                calls = gs.calls
            try:
                self._verify_available(
                    group, gs, upto=calls - (calls % self.interval),
                    peer_timeout=min(1.0, self.diagnose_timeout))
            except CollectiveDivergenceError as e:
                return str(e)
            except Exception:
                pass
            lagging = [p for p, nxt in gs.next_verify.items()
                       if nxt + self.interval <= calls]
            tag = "" if group == "world" else f" [{group}]"
            base = (f"collective fingerprints{tag} agree through call "
                    f"#{gs.last_agreed} of {calls} issued here")
            if gs.skipped:
                base += (f" ({gs.skipped} checkpoint(s) expired "
                         f"unverified — a peer fell more than "
                         f"{self.window} calls behind)")
            if lagging:
                parts.append(
                    f"{base}; rank(s) {sorted(lagging)} have not "
                    f"published checkpoint "
                    f"#{min(gs.next_verify[p] for p in lagging)} — "
                    f"likely a missing or extra collective on those "
                    f"ranks")
            else:
                parts.append(f"{base}; no peer checkpoint disagrees yet")
        return "; ".join(parts) if parts else \
            "no collectives fingerprinted yet"

    def close(self) -> None:
        pass  # KVClient holds no persistent connection


# ------------------------------------------------------------- process api

def maybe_init(cfg, rank: int, size: int
               ) -> Optional[FingerprintVerifier]:
    """Build the process-wide verifier from launcher-injected env.

    Needs the launcher rendezvous KV (HOROVOD_GLOO_RENDEZVOUS_ADDR /
    _PORT); logs and disables otherwise — unlike the consistency
    checker it has no native-KV dependency.
    """
    global _verifier, _init_count
    if _verifier is not None:
        return _verifier
    if size <= 1:
        return None
    from horovod_tpu_torch.common.hvd_logging import get_logger
    if not cfg.rendezvous_addr or not cfg.rendezvous_port:
        get_logger().warning(
            "HOROVOD_CHECK_COLLECTIVES=1 but no rendezvous KV address "
            "was injected (manual launch?); fingerprint verification "
            "disabled")
        return None
    from horovod_tpu_torch.common.resilience import RetryPolicy
    from horovod_tpu_torch.runner.rendezvous import KVClient
    # Single-attempt, tightly-bounded transport: verifier KV traffic
    # rides the collective dispatch path, so a rendezvous blip must
    # cost at most ~2s once — not the KV retry policy's 30s deadline
    # per op. Failures degrade the diagnostic (see _kv_trouble), so
    # retrying is the server's problem, not ours.
    kv = KVClient(cfg.rendezvous_addr, cfg.rendezvous_port,
                  retry_policy=RetryPolicy(max_attempts=1),
                  request_timeout=2.0)
    _init_count += 1
    round_env = os.environ.get("HOROVOD_ELASTIC_ROUND")
    # Same epoch rule as core/consistency.py: the launcher-assigned
    # elastic round is rank-agreed across survivors and joiners; in a
    # static launch every rank's Nth init() pairs under the SPMD
    # contract.
    epoch = f"r{round_env}" if round_env else f"i{_init_count}"
    _verifier = FingerprintVerifier(
        kv, rank, size, epoch,
        interval=cfg.check_collectives_interval,
        window=cfg.check_collectives_window,
        diagnose_timeout=cfg.check_collectives_timeout)
    get_logger().info(
        "collective fingerprint verifier active (interval=%d calls, "
        "window=%d)", _verifier.interval, _verifier.window)
    return _verifier


def get() -> Optional[FingerprintVerifier]:
    return _verifier


def reset() -> None:
    global _verifier
    if _verifier is not None:
        _verifier.close()
    _verifier = None


def stall_context() -> str:
    """Empty string when inactive; the watchdog appends this verbatim."""
    v = _verifier
    if v is None:
        return ""
    try:
        return "; " + v.stall_context()
    except Exception:
        return ""
