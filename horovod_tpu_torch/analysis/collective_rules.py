"""Collective-consistency lint rules (HVD001-HVD005)
(counterpart of horovod_tpu/analysis/collective_rules.py).

The SPMD contract behind every backend this framework has (and the
reference's coordinator protocol, controller.cc:74-447) is: **every rank
issues the same collectives, in the same order, with the same
signature**. Violations don't crash — they stall, 1000 chips deep. These
rules flag the source patterns that most often break the contract, on
user/training code and the repo's own examples:

HVD001  collective invoked under rank-dependent control flow
        (``if hvd.rank() == 0: hvd.broadcast(...)``) — only some ranks
        submit it, the rest hang at the next collective. Since the
        interprocedural upgrade this also catches a *helper* that
        (transitively) issues a collective being called under the
        guard — the exact refactor that used to blind the lexical rule.
HVD002  collective name derived from iteration over an unordered
        container (a set) — iteration order differs per process, so
        ranks pair up different tensors under the same call index.
HVD003  unnamed collective inside a loop — auto-assigned names collide
        across iterations once calls overlap (async handles, reference
        DUPLICATE_NAME_ERROR) and make timeline/stall diagnostics
        ambiguous.
HVD004  ``process_set=`` differs between branches of one ``if`` — if the
        condition isn't globally uniform, member sets disagree about who
        participates. Checked across call sites too: a helper whose
        ``process_set`` parameter gets different arguments per branch is
        the same bug one frame deeper.
HVD005  collective ``name=`` derived from a rank-tainted value
        (``name=f"g{hvd.rank()}"`` — directly, through locals, or
        through a helper parameter): every rank submits a *different*
        name at the same call index, the naming twin of HVD001.

The dataflow lives in ``analysis/callgraph.py``; the graph is built once
per lint run by the driver and attached as ``sf.graph``. A false
positive is one ``disable=... -- rationale`` suppression comment away,
while a missed stall costs a debugging session on a live cluster.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from horovod_tpu_torch.analysis.callgraph import (
    COLLECTIVE_NAMES, FOREIGN_ROOTS, NAME_ARG_POS, NAMED_OP_NAMES, RANK,
    RANK_CALL_NAMES, CallGraph, _scope_walk, contains_rank_call,
    is_collective_call, kwarg as _kwarg, name_argument as _name_argument,
    terminal_name as _terminal_name,
)
from horovod_tpu_torch.analysis.driver import Finding, SourceFile

# Legacy aliases: the collective-call model moved to callgraph.py when
# it grew interprocedural consumers; these names stay importable here.
_RANK_CALL_NAMES = RANK_CALL_NAMES
_FOREIGN_ROOTS = FOREIGN_ROOTS


def _graph(sf: SourceFile) -> CallGraph:
    """The lint run's call graph (driver attaches it; single-blob unit
    runs build their own one-file graph on demand)."""
    graph = getattr(sf, "graph", None)
    if graph is None:
        graph = CallGraph([sf])
        sf.graph = graph
    return graph


def _walk_pruned(root: ast.stmt) -> Iterator[Tuple[ast.Call, str]]:
    """Collective calls under `root`, pruning nested def/class bodies
    (callgraph._scope_walk): a ``def`` inside a rank-guard only runs if
    something calls it, and that callsite is what the rule should (and
    does) anchor to."""
    for node in _scope_walk(root):
        op = is_collective_call(node)
        if op is not None:
            yield node, op  # grouped calls can nest args: walk recurses


def _calls_pruned(root: ast.stmt) -> Iterator[ast.Call]:
    """Every call under `root` with the same def/class pruning."""
    for node in _scope_walk(root):
        if isinstance(node, ast.Call):
            yield node


def _collectives_under_stmts(stmts: Iterable[ast.stmt]
                             ) -> Iterator[Tuple[ast.Call, str]]:
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue  # see _walk_pruned: flag callsites, not def bodies
        yield from _walk_pruned(stmt)


def _calls_under_stmts(stmts: Iterable[ast.stmt]) -> Iterator[ast.Call]:
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield from _calls_pruned(stmt)


# --------------------------------------------------------------- HVD001

def _contains_rank_call(node: ast.AST) -> bool:
    return contains_rank_call(node)


def check_rank_dependent(sf: SourceFile) -> Iterator[Finding]:
    graph = _graph(sf)
    for node in ast.walk(sf.tree):
        branches: List[List[ast.stmt]] = []
        desc = ""
        if isinstance(node, ast.If) and _contains_rank_call(node.test):
            branches = [node.body, node.orelse]
            desc = "if"
        elif isinstance(node, ast.While) \
                and _contains_rank_call(node.test):
            branches = [node.body]
            desc = "while"
        elif isinstance(node, ast.IfExp) \
                and _contains_rank_call(node.test):
            for side in (node.body, node.orelse):
                op = is_collective_call(side)
                if op is not None:
                    yield sf.finding(
                        side, "HVD001",
                        f"collective '{op}' in a rank-dependent "
                        f"conditional expression: every rank must issue "
                        f"the same collectives in the same order")
            continue
        for branch in branches:
            for call, op in _collectives_under_stmts(branch):
                yield sf.finding(
                    call, "HVD001",
                    f"collective '{op}' under rank-dependent control "
                    f"flow ({desc} at line {node.lineno}): every rank "
                    f"must issue the same collectives in the same order")
            # Interprocedural: a call that lands in a linted function
            # whose summary (transitively) issues collectives is the
            # same bug one frame deeper — flag the callsite.
            for call in _calls_under_stmts(branch):
                effects = graph.call_effects(sf, call)
                if not effects:
                    continue
                op, _ps, origin = effects[0]
                callee = _terminal_name(call.func) or "<call>"
                yield sf.finding(
                    call, "HVD001",
                    f"call to '{callee}' under rank-dependent control "
                    f"flow ({desc} at line {node.lineno}) issues "
                    f"collective '{op}' ({origin}): every rank must "
                    f"issue the same collectives in the same order")


# --------------------------------------------------------------- HVD002

def _unordered_iter_reason(it: ast.expr) -> Optional[str]:
    """Why iterating `it` has process-dependent order, or None."""
    if isinstance(it, ast.Set):
        return "a set literal"
    if isinstance(it, ast.SetComp):
        return "a set comprehension"
    if isinstance(it, ast.Call):
        name = _terminal_name(it.func)
        if name in ("set", "frozenset"):
            return f"{name}()"
        if name in ("vars", "globals", "locals"):
            return f"{name}()"
    return None


def _loop_targets(target: ast.expr) -> Set[str]:
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}


def check_unordered_naming(sf: SourceFile) -> Iterator[Finding]:
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.For, ast.AsyncFor)):
            continue
        reason = _unordered_iter_reason(node.iter)
        if reason is None:
            continue
        targets = _loop_targets(node.target)
        for call, op in _collectives_under_stmts(node.body):
            name_expr = _name_argument(call, op)
            if name_expr is None:
                continue
            used = {n.id for n in ast.walk(name_expr)
                    if isinstance(n, ast.Name)}
            if used & targets:
                yield sf.finding(
                    call, "HVD002",
                    f"collective '{op}' name derives from iteration "
                    f"over an unordered container ({reason}): iteration "
                    f"order differs across processes, so ranks submit "
                    f"mismatched names at the same call index — iterate "
                    f"a sorted/ordered sequence instead")


# --------------------------------------------------------------- HVD003

def check_unnamed_in_loop(sf: SourceFile) -> Iterator[Finding]:
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            continue
        for call, op in _collectives_under_stmts(node.body):
            if op not in NAMED_OP_NAMES:
                continue
            name_expr = _name_argument(call, op)
            if name_expr is None or (isinstance(name_expr, ast.Constant)
                                     and name_expr.value is None):
                yield sf.finding(
                    call, "HVD003",
                    f"unnamed collective '{op}' inside a loop: "
                    f"auto-assigned names collide across iterations "
                    f"(reference DUPLICATE_NAME_ERROR) and make "
                    f"timeline/stall diagnostics ambiguous — pass "
                    f"name=")


# --------------------------------------------------------------- HVD004

def _ps_entries(stmts: Iterable[ast.stmt], sf: SourceFile,
                graph: CallGraph
                ) -> Iterator[Tuple[str, ast.Call, Optional[str]]]:
    """(op, anchor call, process_set repr) for every collective a
    branch issues — directly, or transitively through a resolvable
    helper (with the helper's symbolic process_set substituted from
    this call site's arguments)."""
    for call, op in _collectives_under_stmts(stmts):
        ps = _kwarg(call, "process_set")
        yield op, call, (ast.dump(ps) if ps is not None else None)
    for call in _calls_under_stmts(stmts):
        for op, ps, _origin in graph.call_effects(sf, call):
            yield op, call, ps


def check_process_set_branches(sf: SourceFile) -> Iterator[Finding]:
    graph = _graph(sf)
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.If) or not node.orelse:
            continue
        body_ps: Dict[str, Tuple[ast.Call, Set[Optional[str]]]] = {}
        for op, call, ps in _ps_entries(node.body, sf, graph):
            anchor, seen = body_ps.setdefault(op, (call, set()))
            seen.add(ps)
        for op, call, ps in _ps_entries(node.orelse, sf, graph):
            if op not in body_ps:
                continue
            other_call, seen = body_ps[op]
            if ps not in seen:
                yield sf.finding(
                    call, "HVD004",
                    f"'{op}' uses a different process_set than the "
                    f"matching call in the other branch (line "
                    f"{other_call.lineno}): unless the condition is "
                    f"globally uniform, ranks disagree on who "
                    f"participates")


# --------------------------------------------------------------- HVD005

def _scopes(sf: SourceFile) -> Iterator[Optional[ast.AST]]:
    """Module top level plus every (async) function/method — the taint
    scopes. Async defs carry the same divergence bug class."""
    yield None
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _scope_stmts(sf: SourceFile,
                 scope: Optional[ast.AST]) -> List[ast.stmt]:
    return (sf.tree.body if scope is None else scope.body)


def check_rank_tainted_name(sf: SourceFile) -> Iterator[Finding]:
    graph = _graph(sf)
    for scope in _scopes(sf):
        env = graph.taint_env(sf, scope)
        for stmt in _scope_stmts(sf, scope):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # covered by its own taint scope
            for call in _calls_pruned(stmt):
                op = is_collective_call(call)
                if op is not None:
                    name_expr = _name_argument(call, op)
                    if name_expr is not None \
                            and env.rank_tainted(name_expr):
                        yield sf.finding(
                            call, "HVD005",
                            f"collective '{op}' name derives from a "
                            f"rank-dependent value: ranks submit "
                            f"DIFFERENT names at the same call index "
                            f"and pair up mismatched tensors — "
                            f"collective names must be identical on "
                            f"every rank")
                    continue
                for callee in graph.resolve(sf, call):
                    for idx in sorted(callee.name_taint_params):
                        arg = CallGraph._arg_for_param(callee, call, idx)
                        if arg is not None and env.rank_tainted(arg):
                            pname = (callee.params[idx]
                                     if idx < len(callee.params)
                                     else f"#{idx}")
                            yield sf.finding(
                                call, "HVD005",
                                f"argument '{pname}' of "
                                f"{callee.label()} flows into a "
                                f"collective name and is "
                                f"rank-dependent here: collective "
                                f"names must be identical on every "
                                f"rank")


RULES = {
    "HVD001": ("collective under rank-dependent control flow "
               "(direct or through a helper call)",
               check_rank_dependent),
    "HVD002": ("collective named from iteration over an unordered "
               "container", check_unordered_naming),
    "HVD003": ("unnamed collective inside a loop (auto-name collision)",
               check_unnamed_in_loop),
    "HVD004": ("process_set differs across branches (direct or across "
               "call sites)", check_process_set_branches),
    "HVD005": ("collective name derived from a rank-dependent value",
               check_rank_tainted_name),
}
