"""hvdshard rules HVD301-HVD305: sharding and memory contracts on a step
program (counterpart of horovod_tpu/analysis/shard_rules.py).

HVD301  a tensor >= HOROVOD_SHARD_LINT_MIN_REPLICATED_BYTES fully
        replicated across a >1-partition mesh (a recorded step: a
        world of more than one rank): every device pays its full
        memory and every update moves the full payload. Replication
        across a data axis while sharded on a model axis is normal;
        only shard_factor == 1 fires.
HVD302  an all-gather / all-to-all / collective-permute of >=
        HOROVOD_SHARD_LINT_MIN_RESHARD_BYTES nobody asked for. In HLO
        text: one the SPMD partitioner inserted (its metadata traces to
        a dot/gather/..., not to a user collective). The port has no
        partitioner: in a recorded step, one that did not pass through
        the port's collective API or parallel/comm.py
        (shard.traceable_to_user_collective).
HVD303  the static per-device peak-memory estimate (donation-aware
        liveness over the schedule, analysis/shard.py) exceeds the
        budget: HOROVOD_HLO_LINT_HBM_BUDGET when set, else the
        `total_memory` of the card a program was recorded on (an H100:
        80 GB). Silent on text and host recordings with no budget set.
HVD304  the mesh carries more devices than the program's sharding can
        use: some devices hold identical shards of every annotated
        tensor >= HOROVOD_SHARD_LINT_MIN_SHARDED_BYTES. Reads the
        pre-partition annotations of StableHLO text only: a recorded
        step has no pre-partition program, so it never fires there.
HVD305  an all-reduce >= HOROVOD_SHARD_LINT_MIN_RESHARD_BYTES whose
        every consumer slices out a shard and which together keep less
        than the whole result: a reduce-scatter at k times less memory
        and (k-1)/k less wire traffic. (Slices that cover the whole
        result unpack a fused bucket: every byte is kept, which is not
        this pattern.)

Findings are baselined (``analysis/hvdshard_baseline.json``), not
suppressed inline.
"""

from __future__ import annotations

from typing import Iterable, Optional

from horovod_tpu_torch.analysis.driver import Finding
from horovod_tpu_torch.analysis.hlo import HloOp, HloProgram
from horovod_tpu_torch.analysis import hlo_rules
from horovod_tpu_torch.analysis import shard as S

HVD301 = "HVD301"
HVD302 = "HVD302"
HVD303 = "HVD303"
HVD304 = "HVD304"
HVD305 = "HVD305"

_MB = 1024 * 1024


def _min_replicated_bytes() -> int:
    return S._bytes_env("HOROVOD_SHARD_LINT_MIN_REPLICATED_BYTES",
                        4 * _MB)


def _min_reshard_bytes() -> int:
    return S._bytes_env("HOROVOD_SHARD_LINT_MIN_RESHARD_BYTES", _MB)


def _min_sharded_bytes() -> int:
    return S._bytes_env("HOROVOD_SHARD_LINT_MIN_SHARDED_BYTES", _MB)


def hbm_budget_bytes(prog: Optional[HloProgram] = None) -> Optional[int]:
    """HVD303 gate: HOROVOD_HLO_LINT_HBM_BUDGET, else the memory of the
    card `prog` was recorded on; None (rule silent) when neither."""
    return S._bytes_env("HOROVOD_HLO_LINT_HBM_BUDGET",
                        prog.device_memory if prog is not None else None)


def check_hvd301(prog: HloProgram) -> Iterable[Finding]:
    if prog.num_partitions <= 1:
        return
    floor = _min_replicated_bytes()
    for p in prog.entry_params:
        spec = S.parse_sharding(p.sharding)
        if spec is None or not spec.fully_replicated:
            continue
        nb = p.type.nbytes if p.type is not None else None
        if nb is None or nb < floor:
            continue
        yield Finding(
            prog.path, p.line, HVD301,
            f"input {p.name} ({p.type}, {nb / _MB:.1f} MB) is fully "
            f"replicated across the {prog.num_partitions}-partition "
            "mesh: every device pays the full HBM cost and every "
            "update moves the full payload — shard it over a model "
            "axis (NamedSharding/PartitionSpec, docs/parallelism.md)")


_RESHARD_OPCODES = {"all_gather", "all_to_all", "collective_permute"}


def check_hvd302(prog: HloProgram) -> Iterable[Finding]:
    if not prog.per_device or prog.num_partitions <= 1:
        return
    floor = _min_reshard_bytes()
    for op in prog.ops:
        if op.opcode not in _RESHARD_OPCODES:
            continue
        if S.traceable_to_user_collective(op):
            continue
        nb = S._result_bytes(op)
        if nb < floor:
            continue
        if prog.fmt == "torch":
            yield Finding(
                prog.path, op.line, HVD302,
                f"{op.opcode} moving {nb / _MB:.1f} MB inside the step "
                f"was issued by '{_origin(op)}', outside the port's "
                "collective API (ops/collectives.py, parallel/comm.py): "
                "resharding traffic nobody asked for — align the "
                "producer's and the consumer's layouts")
            continue
        yield Finding(
            prog.path, op.line, HVD302,
            f"partitioner-inserted {op.opcode} moving {nb / _MB:.1f} "
            "MB inside the step body (metadata traces to "
            f"'{_origin(op)}', not to a user collective): the SPMD "
            "partitioner is resharding to reconcile inconsistent "
            "annotations — align the producer/consumer shardings "
            "(docs/static_analysis.md)")


def _origin(op: HloOp) -> str:
    m = S._OP_NAME_RE.search(op.attrs)
    if not m:
        return "<no metadata>"
    return m.group(1).rsplit("/", 1)[-1] or "<no metadata>"


def check_hvd303(prog: HloProgram) -> Iterable[Finding]:
    budget = hbm_budget_bytes(prog)
    if budget is None or not prog.per_device:
        return
    est = S.peak_memory(prog)
    if est is None or est.peak_bytes <= budget:
        return
    top = ", ".join(f"{n} {b / _MB:.1f} MB" for n, b in est.top)
    yield Finding(
        prog.path, est.peak_line, HVD303,
        f"static per-device peak-HBM estimate {est.peak_bytes / _MB:.1f}"
        f" MB exceeds the {budget / _MB:.1f} MB budget "
        "(HOROVOD_HLO_LINT_HBM_BUDGET) — this program OOMs at run "
        f"time; largest live buffers at the peak: {top}; donate dead "
        "inputs, shard the big tensors, or rematerialize "
        "(docs/static_analysis.md peak-memory model)")


def check_hvd304(prog: HloProgram) -> Iterable[Finding]:
    if prog.fmt != "stablehlo" or prog.num_partitions <= 1:
        return
    floor = _min_sharded_bytes()
    tensors = [t for t in S.annotated_tensors(prog)
               if t.type is not None and t.type.nbytes is not None
               and t.type.nbytes >= floor]
    if not tensors:
        return
    classes = S.partition_classes(tensors, prog.num_partitions)
    if classes is None or classes >= prog.num_partitions:
        return
    waste = prog.num_partitions // max(classes, 1)
    line = min(t.line for t in tensors)
    yield Finding(
        prog.path, line, HVD304,
        f"the mesh carries {prog.num_partitions} partitions but the "
        f"program's sharding only distinguishes {classes} device "
        f"group(s): {waste}x of the mesh holds identical shards of "
        f"every tensor >= {floor / _MB:.1f} MB — a mesh axis is paid "
        "for but shards nothing (drop the axis or shard a major "
        "tensor over it, docs/parallelism.md)")


_SLICE_OPCODES = {"dynamic_slice", "slice"}


def check_hvd305(prog: HloProgram) -> Iterable[Finding]:
    floor = _min_reshard_bytes()
    for op in prog.ops:
        if op.opcode != "all_reduce" or not op.result:
            continue
        nb = hlo_rules._collective_payload(op)
        if nb is None or nb < floor:
            continue
        uses = prog.uses(op.scope, op.result)
        if not uses:
            continue
        kept = sum(S._result_bytes(u) for u in uses)
        if all(u.opcode in _SLICE_OPCODES for u in uses) and kept < nb:
            yield Finding(
                prog.path, op.line, HVD305,
                f"all_reduce of {nb / _MB:.1f} MB whose every consumer "
                "immediately slices out one shard: every device "
                "materializes the full reduction only to keep 1/k of "
                "it — use reduce_scatter (lax.psum_scatter) for k x "
                "less peak HBM and (k-1)/k less wire traffic "
                "(docs/parallelism.md)")


RULES = {
    HVD301: ("tensor above the replication threshold fully replicated "
             "across a >1-partition mesh", check_hvd301),
    HVD302: ("partitioner-inserted resharding collective (all-gather/"
             "all-to-all/collective-permute not traceable to a user "
             "collective) above the reshard threshold", check_hvd302),
    HVD303: ("static per-device peak-HBM estimate exceeds "
             "HOROVOD_HLO_LINT_HBM_BUDGET (compile-time OOM gate)",
             check_hvd303),
    HVD304: ("mesh axis paid for but sharding no tensor above the "
             "threshold (unused parallelism)", check_hvd304),
    HVD305: ("all-reduce whose every consumer keeps only its own "
             "shard (should be reduce-scatter/psum_scatter)",
             check_hvd305),
}
