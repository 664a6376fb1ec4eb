"""hvdsched rules HVD401-HVD405: cross-device collective-schedule
contracts and the exposed-comms roofline (counterpart of
horovod_tpu/analysis/sched_rules.py).

Every rule defends what the runtime fingerprint verifier
(analysis/verifier.py) can only check live: every member of a replica
group must reach the same collectives, with the same shape, in the same
order, or the group deadlocks with no error anywhere.

HVD401  two devices sharing a replica group reach the same collective
        at different positions, or different (op, groups, bytes) at one
        position: the static deadlock. Cross-program only: in lowered
        text, a hand-split MPMD module pair; in the port, the programs
        the ranks of one step recorded (a rank that skips one
        all-reduce fires it).
HVD402  a collective-permute whose pairs are not a permutation or form
        an open chain, and send/recv channels with no partner. In
        recorded steps each rank holds one end of a transfer, so the
        pairing is checked across the ranks' programs: a send from r to
        p without p's receive from r at that position (or the other way
        round) fires.
HVD403  overlapping subset collectives ordered differently across
        member devices: a happens-before cycle of length >= 3.
HVD404  a >= HOROVOD_SCHED_MIN_STAGED_BYTES (1 MiB) all-reduce whose
        replica group crosses the declared machine boundary
        (HOROVOD_MESH_SLICES) as one flat collective while a machine
        holds >= 2 members: stage it (within-machine reduce-scatter,
        across-machine all-reduce, within-machine all-gather).
HVD405  predicted exposed comms: the analytic comms time
        (schedule.event_cost, over the H100 link table) exceeds the
        overlappable backward window (HOROVOD_SCHED_OVERLAP_WINDOW_MS,
        or dot FLOPs / HOROVOD_SCHED_PEAK_TFLOPS x the overlap
        fraction). Silent when no window is configured.

Findings are baselined (``analysis/hvdsched_baseline.json``), not
suppressed inline.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from horovod_tpu_torch.analysis.driver import Finding
from horovod_tpu_torch.analysis import schedule as S

HVD401 = "HVD401"
HVD402 = "HVD402"
HVD403 = "HVD403"
HVD404 = "HVD404"
HVD405 = "HVD405"

_MB = 1024 * 1024


# ------------------------------------------------------------- HVD401

def _shared_projection(ps: "S.ProgramSchedule", d1: int,
                       d2: int) -> List["S.CollectiveEvent"]:
    """d1's schedule restricted to collectives whose groups put d1 and
    d2 in the same group — the subsequence both must agree on."""
    out = []
    for e in ps.events:
        if any(d1 in g and d2 in g for g in e.groups):
            out.append(e)
    return out


def check_hvd401(sset: "S.ScheduleSet") -> Iterable[Finding]:
    scheds = sset.schedules
    seen: Set[Tuple] = set()
    for ia in range(len(scheds)):
        for ib in range(ia + 1, len(scheds)):
            A, B = scheds[ia], scheds[ib]
            for d1 in A.devices:
                for d2 in B.devices:
                    a = _shared_projection(A, d1, d2)
                    b = _shared_projection(B, d2, d1)
                    if not a and not b:
                        continue
                    n = min(len(a), len(b))
                    diverged = False
                    for pos in range(n):
                        ea, eb = a[pos], b[pos]
                        if ea.signature == eb.signature:
                            continue
                        diverged = True
                        key = (A.path, B.path, pos,
                               ea.signature, eb.signature)
                        if key in seen:
                            break
                        seen.add(key)
                        later = next(
                            (j for j in range(pos + 1, len(b))
                             if b[j].signature == ea.signature), None)
                        detail = (
                            f"; device {d2} reaches that same "
                            f"collective later, at position {later} — "
                            f"misordered schedules"
                            if later is not None else "")
                        yield Finding(
                            A.path, ea.line, HVD401,
                            f"device {d1} ({A.path}) and device {d2} "
                            f"({B.path}) share a replica group but "
                            f"diverge at shared-collective position "
                            f"{pos}: device {d1} issues "
                            f"{ea.describe()} while device {d2} "
                            f"issues {eb.describe()}{detail} — every "
                            f"group member must reach the same "
                            f"collective in the same order or the "
                            f"group deadlocks at step time")
                        break
                    if not diverged and len(a) != len(b):
                        key = (A.path, B.path, "len", len(a), len(b))
                        if key in seen:
                            continue
                        seen.add(key)
                        longer, dev, other = (
                            (a, d1, d2) if len(a) > len(b)
                            else (b, d2, d1))
                        ev = longer[n]
                        yield Finding(
                            ev.path, ev.line, HVD401,
                            f"device {dev} issues {len(longer)} "
                            f"collectives shared with device {other} "
                            f"but device {other} only issues {n}: "
                            f"{ev.describe()} at position {n} has no "
                            f"counterpart — the orphan collective "
                            f"blocks forever waiting for device "
                            f"{other}")


# ------------------------------------------------------------- HVD402

def check_hvd402(sset: "S.ScheduleSet") -> Iterable[Finding]:
    yield from _recorded_p2p(sset)
    for ps in sset.schedules:
        sends: Dict[Optional[int], "S.CollectiveEvent"] = {}
        recvs: Dict[Optional[int], "S.CollectiveEvent"] = {}
        for ev in ps.events:
            if ev.p2p is not None:
                continue  # one end of a recorded transfer: see above
            if ev.opcode == "send":
                sends.setdefault(ev.channel_id, ev)
            elif ev.opcode == "recv":
                recvs.setdefault(ev.channel_id, ev)
            if ev.pairs is None:
                continue
            srcs = [s for s, _ in ev.pairs]
            tgts = [t for _, t in ev.pairs]
            dup_s = sorted({x for x in srcs if srcs.count(x) > 1})
            dup_t = sorted({x for x in tgts if tgts.count(x) > 1})
            if dup_s or dup_t:
                yield Finding(
                    ps.path, ev.line, HVD402,
                    f"{ev.opcode} source_target_pairs "
                    f"{[list(p) for p in ev.pairs]} are not a "
                    f"permutation: duplicate source(s) {dup_s} / "
                    f"target(s) {dup_t} — two transfers contend for "
                    f"one rank's slot and the permute deadlocks or "
                    f"clobbers")
                continue
            orphan_send = sorted(set(srcs) - set(tgts))
            orphan_recv = sorted(set(tgts) - set(srcs))
            if orphan_send or orphan_recv:
                yield Finding(
                    ps.path, ev.line, HVD402,
                    f"{ev.opcode} source_target_pairs "
                    f"{[list(p) for p in ev.pairs]} form an open "
                    f"chain, not a union of disjoint cycles: rank(s) "
                    f"{orphan_send} send but never receive and "
                    f"rank(s) {orphan_recv} receive but never send — "
                    f"the 1F1B mispairing that wedges the pipeline; "
                    f"close the ring ((i+1) % stages) or pair the "
                    f"forward shift with its reverse")
        for ch in sorted(set(sends) - set(recvs), key=str):
            ev = sends[ch]
            yield Finding(
                ps.path, ev.line, HVD402,
                f"send on channel {ch} has no matching recv in the "
                f"program — the orphan sender blocks forever")
        for ch in sorted(set(recvs) - set(sends), key=str):
            ev = recvs[ch]
            yield Finding(
                ps.path, ev.line, HVD402,
                f"recv on channel {ch} has no matching send in the "
                f"program — the orphan receiver blocks forever")


def _recorded_p2p(sset: "S.ScheduleSet") -> Iterable[Finding]:
    """Recorded steps: each rank's program holds only its own end of a
    point-to-point transfer, so the pairing is checked across the set:
    every send from r to p needs a receive from r in p's program, and
    every receive the other way round, in the same order, when both
    ranks' programs are in the set (a transfer to a rank that was not
    recorded is not judged)."""
    recorded = {ps.prog.rank: ps for ps in sset.schedules
                if ps.prog.rank is not None}
    for r, ps in sorted(recorded.items()):
        for kind, other_kind in (("send", "recv"), ("recv", "send")):
            mine: Dict[int, List["S.CollectiveEvent"]] = {}
            for ev in ps.events:
                if ev.p2p != kind or not ev.pairs:
                    continue
                src, dst = ev.pairs[0]
                peer = dst if kind == "send" else src
                mine.setdefault(peer, []).append(ev)
            for peer, evs in sorted(mine.items()):
                if peer not in recorded:
                    continue
                theirs = [ev for ev in recorded[peer].events
                          if ev.p2p == other_kind and ev.pairs
                          and ev.pairs[0] == evs[0].pairs[0]]
                for i, ev in enumerate(evs):
                    if i < len(theirs) and theirs[i].nbytes == ev.nbytes:
                        continue
                    src, dst = ev.pairs[0]
                    yield Finding(
                        ps.path, ev.line, HVD402,
                        f"rank {r} posts its {kind} #{i} of "
                        f"{ev.nbytes / _MB:.2f} MB "
                        f"({'to' if kind == 'send' else 'from'} rank "
                        f"{peer}) but rank {peer} posts no matching "
                        f"{other_kind} {'from' if kind == 'send' else 'to'}"
                        f" rank {r} at that position — the orphan "
                        f"{kind} blocks forever; pair every shift with "
                        f"its partner on the peer (parallel/comm.py "
                        f"ring_shift)")
                    break


# ------------------------------------------------------------- HVD403

def check_hvd403(sset: "S.ScheduleSet") -> Iterable[Finding]:
    # Happens-before edges between collective signatures: for every
    # device's schedule, each event precedes every later one. A cycle
    # of length >= 3 means no global order satisfies every device —
    # the interleaving hazard on shared ranks of overlapping subset
    # collectives. (A 2-cycle is HVD401's pairwise position mismatch.)
    # A device only asserts "u before v" when the order is unambiguous
    # in its schedule (EVERY occurrence of u precedes every occurrence
    # of v) — repeated signatures interleaved within one device are a
    # normal pipeline shape, not an ordering claim.
    edges: Dict[Tuple, Set[Tuple]] = {}
    witness: Dict[Tuple[Tuple, Tuple],
                  Tuple[str, int, "S.CollectiveEvent"]] = {}
    for ps in sset.schedules:
        for d in ps.devices:
            seq = ps.device_events(d)
            first: Dict[Tuple, int] = {}
            last: Dict[Tuple, int] = {}
            for i, ev in enumerate(seq):
                first.setdefault(ev.signature, i)
                last[ev.signature] = i
            for u in first:
                for v in first:
                    if u == v or last[u] >= first[v]:
                        continue
                    bu, bv = seq[first[u]].batch, seq[first[v]].batch
                    if bu is not None and bu == bv:
                        continue  # posted together: no order
                    edges.setdefault(u, set()).add(v)
                    witness.setdefault(
                        (u, v), (ps.path, d, seq[first[u]]))

    color: Dict[Tuple, int] = {}  # 0 absent / 1 on stack / 2 done
    stack: List[Tuple] = []
    cycles: List[List[Tuple]] = []

    def visit(u: Tuple) -> None:
        color[u] = 1
        stack.append(u)
        for v in sorted(edges.get(u, ()), key=repr):
            c = color.get(v, 0)
            if c == 0:
                visit(v)
            elif c == 1:
                cyc = stack[stack.index(v):] + [v]
                if len(cyc) - 1 >= 3:
                    cycles.append(cyc)
        stack.pop()
        color[u] = 2

    for u in sorted(edges, key=repr):
        if color.get(u, 0) == 0:
            visit(u)

    reported: Set[frozenset] = set()
    for cyc in cycles:
        nodes = frozenset(cyc[:-1])
        if nodes in reported:
            continue
        reported.add(nodes)
        legs = []
        first = None
        for u, v in zip(cyc, cyc[1:]):
            path, d, ev = witness[(u, v)]
            if first is None:
                first = (path, ev.line)
            legs.append(f"device {d} ({path}) orders "
                        f"{u[0]} before {v[0]}")
        yield Finding(
            first[0], first[1], HVD403,
            f"overlapping subset collectives with no consistent "
            f"global order — {len(cyc) - 1}-cycle in the cross-device "
            f"happens-before graph: " + "; ".join(legs) +
            f" — shared ranks can interleave the groups and deadlock; "
            f"give the overlapping collectives one device-independent "
            f"issue order")


# ------------------------------------------------------------- HVD404

def check_hvd404(sset: "S.ScheduleSet") -> Iterable[Finding]:
    slices = S.declared_slices()
    if not slices or slices <= 1:
        return
    floor = S.min_staged_bytes()
    for ps in sset.schedules:
        ndev = ps.num_devices
        if ndev % slices:
            continue
        per = ndev // slices
        for ev in ps.events:
            if ev.opcode != "all_reduce" or ev.nbytes < floor:
                continue
            for g in ev.groups:
                spanned = {d // per for d in g}
                if len(spanned) > 1 and len(g) > len(spanned):
                    yield Finding(
                        ps.path, ev.line, HVD404,
                        f"{ev.nbytes / _MB:.1f} MB all-reduce over "
                        f"replica group {list(g)} crosses the "
                        f"declared slice boundary "
                        f"(HOROVOD_MESH_SLICES={slices}, {per} "
                        f"devices/slice) as one flat collective: the "
                        f"whole payload rides the slow inter-slice "
                        f"DCN tier; stage it as intra-slice "
                        f"reduce-scatter + inter-slice all-reduce "
                        f"(+ intra-slice all-gather) so only "
                        f"payload/{per} crosses the boundary")
                    break


# ------------------------------------------------------------- HVD405

def check_hvd405(sset: "S.ScheduleSet") -> Iterable[Finding]:
    slices = S.declared_slices()
    table = S.link_gbps()
    for ps in sset.schedules:
        if not ps.events:
            continue
        window = S.overlap_window_s(ps.prog)
        if window is None:
            continue  # no window configured: rule unarmed
        costs = [(ev, S.event_cost(ev, ps.num_devices, slices, table))
                 for ev in ps.events]
        total = sum(c.seconds for _, c in costs)
        if total <= window:
            continue
        top_ev, top_c = max(costs, key=lambda p: p[1].seconds)
        yield Finding(
            ps.path, top_ev.line, HVD405,
            f"predicted per-step comms {total * 1e3:.2f} ms exceeds "
            f"the overlappable backward window {window * 1e3:.2f} ms "
            f"({(total - window) * 1e3:.2f} ms exposed): the step is "
            f"predicted comms-bound; largest contributor "
            f"{top_ev.describe()} at {top_c.seconds * 1e3:.2f} ms on "
            f"the {top_c.tier} tier "
            f"({table[top_c.tier]:g} GB/s) — shard the payload, "
            f"stage it across the slice boundary, or raise the "
            f"declared window if measured overlap disagrees")


RULES = {
    HVD401: ("replica-group members reach different collectives or "
             "positions (static deadlock)", check_hvd401),
    HVD402: ("permute pairs not a union of disjoint cycles / orphan "
             "send-recv (1F1B hazard)", check_hvd402),
    HVD403: ("overlapping subset collectives ordered differently "
             "across member devices", check_hvd403),
    HVD404: ("flat >=1MiB all-reduce across the declared slice "
             "boundary where staging is available", check_hvd404),
    HVD405: ("predicted comms exceed the overlappable backward "
             "window (exposed comms)", check_hvd405),
}
