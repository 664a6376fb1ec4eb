"""Concurrency-discipline lint rules (HVD101-HVD103)
(counterpart of horovod_tpu/analysis/concurrency_rules.py).

This runtime spawns many background threads (exporter, watchdog,
elastic driver, rendezvous server, data service, timeline writer,
checkpoint writer, serving replicas). These rules make the locking
discipline *checkable*:

HVD101  ``# guarded-by: <lock>`` convention. Annotate the assignment
        that creates shared state::

            self._pending_spans = {}  # guarded-by: _lock

        and every later access of ``._pending_spans`` in the module must
        sit lexically inside ``with <something>.<lock>:``. Accesses in
        the creating scope (``__init__`` / the class body / module top
        level) are exempt — the object is not shared yet.
HVD102  ``threading.Thread(...)`` without an explicit ``daemon=``: an
        undecided thread lifetime is how launchers hang at exit. Decide
        (``daemon=True``, or ``daemon=False`` plus a join path) and say
        so at the spawn site.
HVD103  blocking call (``time.sleep``, socket/HTTP ops, ``Event.wait``,
        ``serve_forever``, ``block_until_ready``, ``subprocess.run``,
        ``Popen.wait``, timeout-less ``queue.Queue.get``/``put``) while
        lexically holding a lock: every other thread needing that lock
        now waits on the network/timer too — the shape of a
        control-plane stall.

Lexical scope is the contract: lock handoffs through helper calls are
invisible to these rules and should either be refactored or suppressed
with a rationale.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from horovod_tpu_torch.analysis.driver import Finding, SourceFile

GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")

#: Terminal callee names considered blocking for HVD103. `join` and
#: `get` are deliberately absent (str.join / dict.get false positives;
#: `wait` covers `Popen.wait` along with Event/Condition waits).
BLOCKING_NAMES: Set[str] = {
    "sleep", "urlopen", "wait", "accept", "recv", "recvfrom", "recv_into",
    "sendall", "connect", "create_connection", "getaddrinfo", "select",
    "serve_forever", "block_until_ready", "check_output", "check_call",
    "communicate",
}

#: (receiver root, terminal) pairs blocking only under that exact
#: qualification — names too common to flag on any receiver.
BLOCKING_QUALIFIED: Set[Tuple[str, str]] = {
    ("subprocess", "run"), ("subprocess", "call"),
}

#: Queue-ish receiver names whose `.get(...)`/`.put(...)` block
#: indefinitely unless a timeout is given. Matching is by receiver name
#: (``self._queue.get()``, ``q.put(item)``) — dict/KV ``.get`` stays
#: exempt because plain data receivers aren't named like queues.
_QUEUEISH = ("queue", "_q", "q")


def _queueish(name: str) -> bool:
    return "queue" in name.lower() or name.lower() in _QUEUEISH


def _terminal(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _with_lock_names(node: ast.With) -> Set[str]:
    """Terminal names of every context-manager expression in `node`
    (``with self._lock:`` -> {"_lock"}; ``with a.b.lock:`` -> {"lock"})."""
    names: Set[str] = set()
    for item in node.items:
        expr = item.context_expr
        # `with lock.acquire_timeout(..)`-style helpers: use the
        # receiver's name too.
        if isinstance(expr, ast.Call):
            t = _terminal(expr.func)
            if t is not None:
                names.add(t)
            if isinstance(expr.func, ast.Attribute):
                r = _terminal(expr.func.value)
                if r is not None:
                    names.add(r)
        else:
            t = _terminal(expr)
            if t is not None:
                names.add(t)
    return names


def _lockish(name: str) -> bool:
    return "lock" in name.lower()


# --------------------------------------------------------------- HVD101

class _Annotation:
    __slots__ = ("attr", "lock", "line", "owner", "cls")

    def __init__(self, attr: str, lock: str, line: int,
                 owner: Optional[ast.AST],
                 cls: Optional[str] = None) -> None:
        self.attr = attr
        self.lock = lock
        self.line = line
        self.owner = owner  # the function/class scope that may touch it
        #                     unguarded (creation scope)
        self.cls = cls  # enclosing class name — binds the annotation to
        #                 a runtime class for hvdrace (analysis/race.py)

    @property
    def class_level(self) -> bool:
        """True when the annotated state lives on the class itself
        (assignment in the class body), not per-instance."""
        return isinstance(self.owner, ast.ClassDef)


def _assigned_names(stmt: ast.stmt) -> List[Tuple[str, bool]]:
    """(name, is_attribute) for each target assigned by `stmt`."""
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    out: List[Tuple[str, bool]] = []
    for t in targets:
        if isinstance(t, ast.Attribute):
            out.append((t.attr, True))
        elif isinstance(t, ast.Name):
            out.append((t.id, False))
    return out


def _collect_annotations(sf: SourceFile) -> List[_Annotation]:
    """Find ``# guarded-by:`` comments and bind each to the state it
    annotates (the assignment on that physical line)."""
    lock_by_line: Dict[int, str] = {}
    for lineno, line in enumerate(sf.lines, 1):
        m = GUARDED_BY_RE.search(line)
        if m:
            lock_by_line[lineno] = m.group(1)
    if not lock_by_line:
        return []
    anns: List[_Annotation] = []
    bound: Set[int] = set()

    def visit(node: ast.AST, scope: Optional[ast.AST],
              cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            child_scope, child_cls = scope, cls
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_scope = child
            elif isinstance(child, ast.ClassDef):
                child_scope = child
                child_cls = child.name
            if isinstance(child, (ast.Assign, ast.AnnAssign,
                                  ast.AugAssign)):
                # The annotation comment may sit on any line the
                # statement spans (long dict literals).
                for ln in range(child.lineno,
                               (child.end_lineno or child.lineno) + 1):
                    if ln in lock_by_line and ln not in bound:
                        for name, _is_attr in _assigned_names(child):
                            anns.append(_Annotation(
                                name, lock_by_line[ln], ln, scope, cls))
                            bound.add(ln)
            visit(child, child_scope, child_cls)

    visit(sf.tree, None, None)
    return anns


def check_guarded_by(sf: SourceFile) -> Iterator[Finding]:
    anns = _collect_annotations(sf)
    if not anns:
        return
    by_attr: Dict[str, _Annotation] = {a.attr: a for a in anns}

    # Creation scopes where unguarded access is allowed: the annotated
    # assignment's own function (typically __init__) or class body.
    def walk(node: ast.AST, scope: Optional[ast.AST],
             held: Set[str]) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            child_scope = scope
            child_held = held
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_scope = child
                child_held = set()  # locks don't span call boundaries
            elif isinstance(child, ast.ClassDef):
                child_scope = child
            if isinstance(child, ast.With):
                inner = held | _with_lock_names(child)
                # The with-items themselves evaluate pre-acquisition of
                # the later items, but flagging `with self._lock:` for
                # touching `_lock` would be absurd; item exprs are
                # exempt via `held|names` covering them too.
                for stmt in child.body:
                    yield from walk_stmt(stmt, child_scope, inner)
                continue
            yield from check_node(child, child_scope, child_held)
            yield from walk(child, child_scope, child_held)

    def walk_stmt(stmt: ast.AST, scope, held) -> Iterator[Finding]:
        yield from check_node(stmt, scope, held)
        yield from walk(stmt, scope, held)

    def check_node(node: ast.AST, scope, held: Set[str]
                   ) -> Iterator[Finding]:
        name = None
        if isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, ast.Name):
            name = node.id
        if name is None:
            return
        ann = by_attr.get(name)
        if ann is None or ann.lock in held:
            return
        if scope is ann.owner:  # creation scope (None = module top level)
            return
        yield sf.finding(
            node, "HVD101",
            f"'{name}' is guarded-by '{ann.lock}' (annotation at line "
            f"{ann.line}) but accessed outside 'with ...{ann.lock}:'")

    yield from walk(sf.tree, None, set())


# --------------------------------------------------------------- HVD102

def check_thread_daemon(sf: SourceFile) -> Iterator[Finding]:
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        t = _terminal(node.func)
        if t != "Thread":
            continue
        if isinstance(node.func, ast.Attribute):
            root = node.func.value
            if not (isinstance(root, ast.Name)
                    and root.id == "threading"):
                continue
        if not any(kw.arg == "daemon" for kw in node.keywords):
            yield sf.finding(
                node, "HVD102",
                "threading.Thread without an explicit daemon=: decide "
                "the thread's lifetime at the spawn site (daemon=True, "
                "or daemon=False with a join path)")


# --------------------------------------------------------------- HVD103

def _has_timeout(call: ast.Call) -> bool:
    """True when a queue get/put is bounded: a ``timeout=`` keyword, the
    positional timeout slot (``get(block, timeout)`` /
    ``put(item, block, timeout)``), or a non-blocking ``block=False``
    (raises Empty/Full immediately — it cannot wait at all)."""
    if any(kw.arg == "timeout" for kw in call.keywords):
        return True
    if any(kw.arg == "block"
           and isinstance(kw.value, ast.Constant)
           and kw.value.value is False for kw in call.keywords):
        return True
    block_pos = 0 if _terminal(call.func) == "get" else 1
    if len(call.args) > block_pos \
            and isinstance(call.args[block_pos], ast.Constant) \
            and call.args[block_pos].value is False:
        return True
    pos = 1 if _terminal(call.func) == "get" else 2
    return len(call.args) > pos


def _blocking_reason(call: ast.Call) -> Optional[str]:
    """Why `call` can block indefinitely, or None."""
    t = _terminal(call.func)
    if t in BLOCKING_NAMES:
        return f"'{t}(...)'"
    if isinstance(call.func, ast.Attribute):
        root = _terminal(call.func.value)
        if root is not None and (root, t) in BLOCKING_QUALIFIED:
            return f"'{root}.{t}(...)'"
        if t in ("get", "put") and root is not None \
                and _queueish(root) and not _has_timeout(call):
            return f"queue '{root}.{t}(...)' without a timeout"
    return None


def check_blocking_under_lock(sf: SourceFile) -> Iterator[Finding]:
    def walk(node: ast.AST, held: Set[str]) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            child_held = held
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                child_held = set()
            elif isinstance(child, ast.With):
                lock_names = {n for n in _with_lock_names(child)
                              if _lockish(n)}
                if lock_names:
                    child_held = held | lock_names
            if isinstance(child, ast.Call) and held:
                reason = _blocking_reason(child)
                if reason is not None:
                    yield sf.finding(
                        child, "HVD103",
                        f"blocking call {reason} while holding lock "
                        f"{sorted(held)}: every thread needing the lock "
                        f"now waits on the timer/network too — move the "
                        f"blocking work outside the critical section")
            yield from walk(child, child_held)

    yield from walk(sf.tree, set())


RULES = {
    "HVD101": ("guarded-by state accessed outside its lock",
               check_guarded_by),
    "HVD102": ("threading.Thread without explicit daemon=",
               check_thread_daemon),
    "HVD103": ("blocking call while holding a lock",
               check_blocking_under_lock),
}
