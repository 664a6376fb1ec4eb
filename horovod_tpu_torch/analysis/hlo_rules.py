"""hvdhlo rules HVD201-HVD205: performance contracts on a step program
(counterpart of horovod_tpu/analysis/hlo_rules.py).

Each rule guards a property an AST linter cannot see. They read the
model of ``analysis/hlo.py``: lowered text (both packages give the same
findings on a dump), or a torch step recorded by ``analysis/graph.py``.

HVD201  a fused all-reduce payload above the bucket cap, or every
        collective of the program in one serialized dependency chain:
        the "single giant allreduce after the backward" plan that the
        bucketed hook path (optim/optimizer.py, ops/fusion.py) exists
        to prevent. The payload limit is
        HOROVOD_HLO_LINT_MAX_COLLECTIVE_BYTES when set, else the live
        HOROVOD_BUCKET_CAP, else the 4 MiB default: a *lifted* cap falls
        back to the default, so the regression scenario (threshold
        raised, cap disabled) still gates.
HVD202  a device<->host transfer inside the step: infeed/outfeed, a
        host callback or host-transfer send/recv in lowered text; in a
        recorded step ``.item()``/``.tolist()``/``bool()`` of a tensor
        (``aten._local_scalar_dense``) and copies between the card and
        the host, recorded as outfeed/infeed. Each one stalls the host
        until the card drains.
HVD203  an entry buffer dead after its single use but not donated: the
        input stays alive beside the output. A recorded step's
        donation bit is an in-place update of the entry tensor.
HVD204  a conv/dot operand whose channel/contracting dim is not a
        multiple of the lane (`LANE`: the H100's 64, the smallest
        channel width of a Hopper conv instance; the JAX package's is
        the TPU's 128): the padding share is wasted work. The lane and
        the waste formula are the layout pass's own (ops/layout.py).
HVD205  a bf16->f32 upcast whose value feeds a dot/conv rather than an
        accumulator: the matmul runs at the f32 (tf32) rate for no
        precision benefit; keep its inputs bf16 (the tensor cores
        accumulate in f32).

Checks are heuristics; false positives are baselined
(``analysis/hvdhlo_baseline.json``), not suppressed inline: a program
has no comment to hang a suppression on.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Set

from horovod_tpu_torch.analysis.driver import Finding
from horovod_tpu_torch.analysis.hlo import HloOp, HloProgram, TensorType
# One lane constant and one waste formula, shared with the layout pass
# (ops/layout.py), so the pass and the lint agree on what "aligned"
# means.
from horovod_tpu_torch.ops.layout import (LANE, _min_pad_waste_pct,
                                          _pad_waste_pct)

HVD201 = "HVD201"
HVD202 = "HVD202"
HVD203 = "HVD203"
HVD204 = "HVD204"
HVD205 = "HVD205"

_MB = 1024 * 1024


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "").strip()
    try:
        return int(v) if v else default
    except ValueError:
        return default


def _payload_limit_bytes() -> int:
    """HVD201 limit; see module docstring for the fallback chain."""
    explicit = os.environ.get(
        "HOROVOD_HLO_LINT_MAX_COLLECTIVE_BYTES", "").strip()
    if explicit:
        try:
            return max(int(explicit), 1)
        except ValueError:
            pass
    from horovod_tpu_torch.common.config import DEFAULT_BUCKET_CAP_BYTES
    cap = _env_int("HOROVOD_BUCKET_CAP", DEFAULT_BUCKET_CAP_BYTES)
    return cap if cap > 0 else DEFAULT_BUCKET_CAP_BYTES


def _op_bytes(types: Iterable[Optional[TensorType]]) -> Optional[int]:
    total = 0
    saw = False
    for t in types:
        if t is None:
            continue
        nb = t.nbytes
        if nb is None:
            continue
        total += nb
        saw = True
    return total if saw else None


def _collective_payload(op: HloOp) -> Optional[int]:
    """Wire bytes of one collective: operand types when the text carries
    them, else result types (identical for all-reduce)."""
    return _op_bytes(op.operand_types) or _op_bytes(op.result_types)


_PAYLOAD_COLLECTIVES = {"all_reduce"}
_CHAIN_COLLECTIVES = {"all_reduce", "reduce_scatter", "all_gather"}


def check_hvd201(prog: HloProgram) -> Iterable[Finding]:
    limit = _payload_limit_bytes()
    per_scope: dict = {}
    for op in prog.ops:
        if op.opcode in _CHAIN_COLLECTIVES:
            per_scope.setdefault(op.scope, []).append(op)
        if op.opcode not in _PAYLOAD_COLLECTIVES:
            continue
        nbytes = _collective_payload(op)
        if nbytes is not None and nbytes > limit:
            yield Finding(
                prog.path, op.line, HVD201,
                f"fused all-reduce payload {nbytes / _MB:.1f} MB exceeds "
                f"the {limit / _MB:.1f} MB bucket cap — the single-giant-"
                "allreduce plan; gradient bucketing (ops/fusion.py, "
                "docs/perf.md) is not in effect for this program")
    for scope, colls in sorted(per_scope.items()):
        if len(colls) < 2:
            continue
        # Only gradient-scale chains matter: a tiny inherently-serial
        # pair (softmax's max->sum psums, a scalar norm before a small
        # rescale) is not the overlap regression this rule guards, so
        # the chain must carry more than the bucket cap in total.
        total = sum(_collective_payload(op) or 0 for op in colls)
        if total <= limit:
            continue
        colls.sort(key=lambda o: o.line)
        if all(prog.depends_on(colls[i + 1], colls[i])
               for i in range(len(colls) - 1)):
            yield Finding(
                prog.path, colls[0].line, HVD201,
                f"all {len(colls)} collectives in '{scope}' "
                f"({total / _MB:.1f} MB total) form one serialized "
                "dependency chain — no collective can overlap compute "
                "or another collective (docs/perf.md)")


_HOST_OPCODES = {"infeed", "outfeed"}
_HOST_TRANSFER_OPCODES = {"send", "recv", "send_done", "recv_done"}
#: custom-call targets that are host round-trips. Matched as substrings
#: of the lowercased target so jax version renames
#: (xla_python_cpu_callback -> xla_ffi_python_cpu_callback, ...) keep
#: matching; partition/sharding custom calls contain none of these.
_HOST_TARGET_MARKERS = ("callback", "host_", "tohost", "fromhost",
                        "xla_python")


def _custom_call_target(op: HloOp) -> str:
    import re
    m = re.search(r'custom_call_target="([^"]+)"', op.attrs)
    if m:
        return m.group(1)
    m = re.search(r"@([\w.$-]+)", op.attrs)
    return m.group(1) if m else ""


def check_hvd202(prog: HloProgram) -> Iterable[Finding]:
    for op in prog.ops:
        if op.opcode in _HOST_OPCODES:
            yield Finding(
                prog.path, op.line, HVD202,
                f"{op.opcode} inside the compiled step body: a device<->"
                "host transfer serializes the step on the host link — "
                "move host I/O out of the step (docs/perf.md)")
        elif op.opcode in _HOST_TRANSFER_OPCODES \
                and "is_host_transfer=true" in op.attrs:
            yield Finding(
                prog.path, op.line, HVD202,
                f"host-transfer {op.opcode} inside the compiled step "
                "body (docs/perf.md)")
        elif op.opcode == "custom_call":
            target = _custom_call_target(op)
            low = target.lower()
            if any(mk in low for mk in _HOST_TARGET_MARKERS):
                yield Finding(
                    prog.path, op.line, HVD202,
                    f"host callback '{target}' inside the compiled step "
                    "body: each call is a device->host->device round-trip "
                    "per step — gate debug callbacks out of production "
                    "steps (docs/perf.md)")


def _min_donation_bytes() -> int:
    return _env_int("HOROVOD_HLO_LINT_MIN_DONATION_BYTES", 1 * _MB)


#: Shape-preserving wrappers the partitioner threads entry values
#: through before anything consumes them: liveness must be judged past
#: them, at the real consumer.
_SHARDING_WRAPPERS = ("Sharding", "SPMDFullToShardShape",
                      "SPMDShardToFullShape")


def _dead_after_single_use(prog: HloProgram, scope: str, name: str,
                           depth: int = 0) -> bool:
    """True when `name` has exactly one consumer and that consumer
    really ends its life. Follows single-use chains through the SPMD
    sharding wrappers and into `call`ed computations (shard_map bodies)
    — the entry parameter's liveness is decided wherever the value is
    actually consumed, not at the partitioning boilerplate."""
    if depth > 6:
        return False  # give up conservatively on deep wrapper chains
    uses = prog.uses(scope, name)
    if len(uses) != 1:
        return False  # unused (XLA drops it) or live past first use
    use = uses[0]
    if use.opcode in ("return", "func_return", "tuple"):
        return False  # passthrough outputs are not reducible copies
    if use.opcode == "copy" and "recorded=true" not in use.attrs:
        return False  # (a recorded copy is a torch clone: a new buffer)
    if use.opcode == "custom_call" and use.result \
            and _custom_call_target(use) in _SHARDING_WRAPPERS:
        return _dead_after_single_use(prog, scope, use.result, depth + 1)
    if use.opcode == "call" and name in use.operands:
        import re
        cm = re.search(r"@([\w$.-]+)", use.attrs)
        if cm:
            callee = cm.group(1)
            pos = use.operands.index(name)
            for cp in prog.params:
                if cp.scope == callee and cp.index == pos:
                    return _dead_after_single_use(prog, callee, cp.name,
                                                  depth + 1)
        return False  # unresolvable callee: don't guess
    return True


def check_hvd203(prog: HloProgram) -> Iterable[Finding]:
    floor = _min_donation_bytes()
    for p in prog.entry_params:
        if p.donated or p.type is None:
            continue
        nb = p.type.nbytes
        if nb is None or nb < floor:
            continue
        if not _dead_after_single_use(prog, p.scope, p.name):
            continue
        if prog.fmt == "torch":
            yield Finding(
                prog.path, p.line, HVD203,
                f"input {p.name} ({p.type}, {nb / _MB:.1f} MB) is read "
                "once and never updated in place — its buffer stays "
                "alive beside the op's new result, a second copy per "
                "step; update it in place (an in-place or out= op) "
                "where the step owns it")
            continue
        yield Finding(
            prog.path, p.line, HVD203,
            f"input {p.name} ({p.type}, {nb / _MB:.1f} MB) is dead "
            "after its only use but not donated — XLA keeps the buffer "
            "alive next to the output, an extra HBM copy per step; "
            "donate it (jax.jit donate_argnums, docs/perf.md)")


def _check_lane_dim(prog: HloProgram, op: HloOp, what: str,
                    dim: int) -> Iterable[Finding]:
    if dim <= 0 or dim % LANE == 0:
        return
    waste = _pad_waste_pct(dim, LANE)
    if waste < _min_pad_waste_pct():
        return
    yield Finding(
        prog.path, op.line, HVD204,
        f"{op.opcode} {what} = {dim} is not a multiple of the {LANE}-"
        f"wide vector lanes: ~{waste:.1f}% of the op's FLOPs are "
        "padding — pad the channel/feature dim to the lane width "
        "(docs/perf.md, ROADMAP conv-MFU item)")


def _dims_list(text: str) -> List[int]:
    import re
    return [int(t) for t in re.findall(r"\d+", text)]


def check_hvd204(prog: HloProgram) -> Iterable[Finding]:
    import re
    for op in prog.ops:
        if op.opcode in ("dot", "dot_general"):
            lhs, rhs = (op.operand_types + (None, None))[:2]
            sides = []
            if prog.fmt == "stablehlo":
                m = re.search(
                    r"contracting_dims\s*=\s*\[([\d, ]*)\]\s*x\s*"
                    r"\[([\d, ]*)\]", op.attrs)
                if m:
                    sides = [("lhs", lhs, m.group(1)),
                             ("rhs", rhs, m.group(2))]
            else:
                for side, t, pat in (
                        ("lhs", lhs, r"lhs_contracting_dims=\{([\d,]*)\}"),
                        ("rhs", rhs, r"rhs_contracting_dims=\{([\d,]*)\}")):
                    g = re.search(pat, op.attrs)
                    if g:
                        sides.append((side, t, g.group(1)))
            for side, t, dims_text in sides:
                if t is None:
                    continue
                # XLA collapses all contracting dims into ONE extent
                # before tiling, so the PRODUCT is what pads to the
                # lane width (a (16,64)x... backward dL/dW contraction
                # is a 1024-extent — aligned — not two unaligned dims).
                extent = 1
                known = False
                for d in _dims_list(dims_text):
                    if d < len(t.dims):
                        extent *= t.dims[d]
                        known = True
                if known:
                    yield from _check_lane_dim(
                        prog, op, f"{side} contracting extent", extent)
        elif op.opcode == "convolution":
            lhs, rhs = (op.operand_types + (None, None))[:2]
            if prog.fmt == "stablehlo":
                m = re.search(
                    r"dim_numbers\s*=\s*\[([^\]]*)\]x\[([^\]]*)\]",
                    op.attrs)
                if not m:
                    continue
                lspec = [t.strip() for t in m.group(1).split(",")]
                rspec = [t.strip() for t in m.group(2).split(",")]
            else:
                m = re.search(r"dim_labels=(\w+)_(\w+)->", op.attrs)
                if not m:
                    continue
                lspec, rspec = list(m.group(1)), list(m.group(2))
            if lhs is not None and "f" in lspec \
                    and len(lhs.dims) == len(lspec):
                yield from _check_lane_dim(
                    prog, op, "input channel dim",
                    lhs.dims[lspec.index("f")])
            if rhs is not None and len(rhs.dims) == len(rspec):
                for label, what in (("i", "kernel input-feature dim"),
                                    ("o", "kernel output-feature dim")):
                    if label in rspec:
                        yield from _check_lane_dim(
                            prog, op, what, rhs.dims[rspec.index(label)])


#: Ops a value flows through unchanged enough that an upcast before
#: them is really an upcast of whatever they feed.
_PASSTHROUGH = {
    "add", "subtract", "multiply", "divide", "negate", "abs", "tanh",
    "exponential", "exp", "log", "logistic", "power", "pow", "sqrt",
    "rsqrt", "maximum", "minimum", "max", "min", "select", "clamp",
    "broadcast", "broadcast_in_dim", "reshape", "transpose", "slice",
    "concatenate", "pad", "copy", "bitcast", "dynamic_slice",
    "dynamic_update_slice", "rem", "floor", "ceil", "round",
    "round_nearest_even", "sign", "expm1", "log_plus_one", "log1p",
}
_MXU_OPS = {"dot", "dot_general", "convolution"}
_SOURCE_DTYPES = {"bf16", "f16"}


def check_hvd205(prog: HloProgram) -> Iterable[Finding]:
    for op in prog.ops:
        if op.opcode != "convert" or not op.result:
            continue
        src = op.operand_types[0] if op.operand_types else None
        dst = op.result_types[0] if op.result_types else None
        if src is None or dst is None:
            continue
        if src.dtype.lower() not in _SOURCE_DTYPES \
                or dst.dtype.lower() != "f32":
            continue
        hit = _reaches_mxu(prog, op)
        if hit is not None:
            yield Finding(
                prog.path, op.line, HVD205,
                f"f32 upcast of {src} feeds {hit.opcode} (line "
                f"{hit.line}) rather than an accumulator: the matmul "
                "runs at the f32 MXU rate for no precision benefit — "
                "keep MXU inputs bf16 and accumulate in f32 "
                "(preferred_element_type; docs/perf.md)")


def _reaches_mxu(prog: HloProgram, op: HloOp,
                 max_visits: int = 256) -> Optional[HloOp]:
    """First dot/conv the upcast value reaches through passthrough ops;
    None when every path ends in an accumulator/other sink."""
    seen: Set[str] = set()
    frontier = [op]
    visits = 0
    while frontier and visits < max_visits:
        cur = frontier.pop()
        if not cur.result or cur.result in seen:
            continue
        seen.add(cur.result)
        visits += 1
        for use in prog.uses(cur.scope, cur.result):
            if use.opcode in _MXU_OPS:
                return use
            if use.opcode in _PASSTHROUGH and use.result:
                frontier.append(use)
    return None


RULES = {
    HVD201: ("fused all-reduce payload above the bucket cap, or all "
             "collectives serialized in one dependency chain",
             check_hvd201),
    HVD202: ("infeed/outfeed/host callback inside the compiled step",
             check_hvd202),
    HVD203: ("large input dead after first use but not donated",
             check_hvd203),
    HVD204: ("conv/dot channel or contracting dim not a multiple of "
             "the 128-lane MXU width (padding waste)", check_hvd204),
    HVD205: ("f32 upcast of a bf16 tensor feeding a matmul/conv "
             "instead of an accumulator", check_hvd205),
}
