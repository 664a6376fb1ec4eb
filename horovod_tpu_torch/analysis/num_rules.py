"""hvdnum rules HVD501-HVD505: numerics and reduction-semantics
contracts on a step program (counterpart of
horovod_tpu/analysis/num_rules.py).

HVD501  a dot/conv (or kernel) whose accumulation type is bf16/f16/f8:
        every partial-product add rounds at the narrow precision. In a
        recorded step the type is the one the op really uses
        (numerics.accumulation_dtype): a bf16 ``aten.mm`` returns bf16
        and cuBLAS accumulates in f32 except for split-K partial sums,
        which may round in bf16 under ``torch.backends.cuda.matmul.
        allow_bf16_reduced_precision_reduction`` (on by default), so it
        fires on a bf16 matmul whose shape lets cuBLAS split K, unless
        that flag is off; cuDNN's convolutions and the port's kernels
        accumulate in f32.
HVD502  a precision-dropping convert on a gradient path before its
        reduce collective (downcast-then-reduce rounds every summand).
HVD503  a gradient-scale mismatch: the divide/multiply that normalizes
        a reduced gradient uses the world/partition count (or another
        group's size) instead of the reducing group's size.
HVD504  determinism hazards that void bit-identical resume: a fused
        multi-operand fp reduction, a keyless rng op (in torch: a
        random op drawn from the default generator, not an explicit
        ``generator=``), a reduce over groups of unequal sizes, and in
        torch an op that accumulates with CUDA atomics (``index_add_``,
        ``scatter_add_``, ``index_put_`` with accumulate=True).
HVD505  two programs of one step under different mesh shapes disagree
        on a reduction's effective multiplier (lint the pair as one
        set).

False positives are baselined (``analysis/hvdnum_baseline.json``), not
suppressed inline.
"""

from __future__ import annotations

from typing import Iterable

from horovod_tpu_torch.analysis.driver import Finding
from horovod_tpu_torch.analysis import numerics as N

HVD501 = "HVD501"
HVD502 = "HVD502"
HVD503 = "HVD503"
HVD504 = "HVD504"
HVD505 = "HVD505"

_MXU_OPS = ("dot", "dot_general", "convolution")


def check_hvd501(nset: "N.NumericsSet") -> Iterable[Finding]:
    allow = N.allowed_accum()
    for np_ in nset.programs:
        for op in np_.prog.ops:
            if op.opcode not in _MXU_OPS \
                    and not N.ACCUM_RE.search(op.attrs):
                continue
            out = N.accumulation_dtype(op)
            src = None
            for t in op.operand_types:
                src = N._fp_dtype(t)
                if src:
                    break
            if not out or not src:
                continue
            if src in N.LOW_PRECISION and out in N.LOW_PRECISION \
                    and out not in allow:
                yield Finding(
                    np_.path, op.line, HVD501,
                    f"{op.opcode} accumulates in {out}: {src} inputs "
                    "with no f32 accumulation type — every partial-"
                    f"product add rounds at {out} precision and the "
                    "contraction magnifies the error; request "
                    "preferred_element_type=f32 (narrow inputs, wide "
                    "accumulator) and downcast after the reduce")


def check_hvd502(nset: "N.NumericsSet") -> Iterable[Finding]:
    floor = N.min_reduce_bytes()
    for np_ in nset.programs:
        for r in np_.reductions:
            if r.nbytes < floor:
                continue
            for o in r.op.operands:
                f = np_.flow.get((r.op.scope, o))
                if f is None or f.narrowed_at is None \
                        or f.width is None or f.width >= f.max_width:
                    continue
                yield Finding(
                    np_.path, r.op.line, HVD502,
                    f"downcast-then-reduce: this {r.event.opcode} "
                    f"combines {r.dtype} values narrowed by the "
                    f"convert at line {f.narrowed_at.line} — every "
                    f"summand rounds BEFORE the {r.group_size}-way "
                    "reduction accumulates; reduce first and downcast "
                    "the single result after (reduce-then-downcast), "
                    "or keep the gradient path f32")
                break  # one finding per reduction


def check_hvd503(nset: "N.NumericsSet") -> Iterable[Finding]:
    floor = N.min_reduce_bytes()
    tol = N.scale_tol()
    for np_ in nset.programs:
        counts = {r.group_size for r in np_.reductions}
        if np_.prog.num_partitions > 1:
            counts.add(np_.prog.num_partitions)
        if np_.schedule.num_devices > 1:
            counts.add(np_.schedule.num_devices)
        for r in np_.reductions:
            if r.nbytes < floor or r.dynamic or r.divisor is None:
                continue
            k = r.group_size
            if N.close(r.divisor, k, tol):
                continue  # true mean over the reducing group
            hit = next((c for c in sorted(counts)
                        if c != k and N.close(r.divisor, c, tol)), None)
            if hit is None:
                continue  # arbitrary math constant, not a group count
            yield Finding(
                np_.path, r.op.line, HVD503,
                f"gradient-scale mismatch: this {r.event.opcode} "
                f"reduces over a {k}-member group but the scale at "
                f"line {r.divisor_line} divides by {r.divisor:g} — a "
                f"baked world/partition count ({hit}), not the "
                "reducing group's size; after an elastic rescale or "
                "process-set change the constant goes stale and the "
                f"effective learning rate shifts {k / r.divisor:g}x "
                "from the intended mean — divide by the live group "
                "size instead")


def check_hvd504(nset: "N.NumericsSet") -> Iterable[Finding]:
    for np_ in nset.programs:
        for r in np_.reductions:
            fp_operands = [t for t in r.op.operand_types
                           if N._fp_dtype(t)]
            if len(r.op.operands) >= 2 and len(fp_operands) >= 2:
                yield Finding(
                    np_.path, r.op.line, HVD504,
                    f"unordered multi-operand fp reduction: this "
                    f"{r.event.opcode} fuses {len(r.op.operands)} fp "
                    "operands into one combining step — the order the "
                    "fused buffers round in is schedule-dependent, so "
                    "a re-lowered or re-bucketed program resumes with "
                    "different bits; reduce per tensor (or pin the "
                    "bucket composition) for bit-identical resume")
            sizes = sorted({len(g) for g in r.event.groups})
            if len(sizes) > 1:
                yield Finding(
                    np_.path, r.op.line, HVD504,
                    f"reduction-tree shape divergence: this "
                    f"{r.event.opcode} partitions replicas into groups "
                    f"of sizes {sizes} — per-device schedules disagree "
                    "on the combining tree, fp rounding differs across "
                    "replicas, and a restore onto a differently-sized "
                    "group is not bit-identical; use equal-size groups "
                    "for gradient reductions")
        for op in np_.prog.ops:
            if N.ATOMIC_ATTR in op.attrs:
                yield Finding(
                    np_.path, op.line, HVD504,
                    f"atomic accumulation: {op.opcode} sums with CUDA "
                    "atomics, whose order differs from run to run, so "
                    "the result's bits do too and a resumed run is not "
                    "bit-identical; use a sort-based or segmented "
                    "reduction, or torch.use_deterministic_algorithms")
            if op.opcode in N.KEYLESS_RNG_OPS:
                yield Finding(
                    np_.path, op.line, HVD504,
                    f"keyless rng: {op.opcode} draws from implicit "
                    "per-device generator state, which a checkpoint "
                    "restore does not replay — the resumed run "
                    "diverges bitwise at the first draw; thread an "
                    "explicit key (jax.random / rng_bit_generator) "
                    "through the step instead")


def check_hvd505(nset: "N.NumericsSet") -> Iterable[Finding]:
    progs = nset.programs
    if len(progs) < 2:
        return
    tol = N.scale_tol()
    for i in range(len(progs)):
        for j in range(i + 1, len(progs)):
            a, b = progs[i], progs[j]
            if not a.reductions \
                    or len(a.reductions) != len(b.reductions):
                continue  # not a lowering pair of one step
            for x, y in zip(a.reductions, b.reductions):
                mx, my = x.multiplier, y.multiplier
                if mx is None or my is None or N.close(mx, my, tol):
                    continue
                yield Finding(
                    b.path, y.op.line, HVD505,
                    "cross-mesh gradient-scale inequivalence: this "
                    f"{y.event.opcode} applies effective multiplier "
                    f"{my:g} (group {y.group_size}, divisor "
                    f"{y.divisor if y.divisor is not None else 'none'})"
                    f" but its mesh twin {a.path}:{x.op.line} applies "
                    f"{mx:g} (group {x.group_size}) — restoring a "
                    "checkpoint between these mesh shapes changes the "
                    f"effective learning rate {my / mx:g}x; normalize "
                    "each reduction by its own group's size (true "
                    "mean) so the invariant holds under any mesh")


RULES = {
    HVD501: ("dot/conv accumulating in bf16/fp16/f8 — no f32 "
             "accumulation type", check_hvd501),
    HVD502: ("precision-dropping convert on a gradient path before "
             "its reduce (downcast-then-reduce ordering)",
             check_hvd502),
    HVD503: ("gradient-scale divisor is a baked world/partition "
             "count, not the reducing group's size (stale on elastic "
             "rescale)", check_hvd503),
    HVD504: ("determinism hazard voiding bit-identical resume: "
             "multi-operand fp reduction, keyless rng, or divergent "
             "reduction-tree shape", check_hvd504),
    HVD505: ("cross-mesh gradient-scale inequivalence between "
             "programs lowered from one step (effective LR changes "
             "on restore)", check_hvd505),
}
