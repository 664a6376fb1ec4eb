"""Module-level call graph + rank-taint dataflow for hvdlint
(counterpart of horovod_tpu/analysis/callgraph.py).

Lexical HVD0xx rules go blind the moment a collective moves into a
helper::

    def sync(x):
        return hvd.allreduce(x, name="s")

    if hvd.rank() == 0:
        sync(x)          # lexical HVD001 sees no collective here

This module closes that hole. ``CallGraph`` is built once per lint run
over every parsed file, then shared by the rules through ``sf.graph``:

* **Function summaries.** For each module-level function and each method
  it records which collectives the function issues *transitively* (with
  the ``process_set=`` expression, parameter references kept symbolic so
  call sites can substitute their own argument), whether its return
  value is rank-tainted, which parameters flow through to the return
  value, and which parameters flow into a collective ``name=``.
  Summaries are computed to a fixpoint, so chains and recursion are
  handled (sets only grow, so iteration terminates).

* **Taint.** A value is *rank-tainted* when it derives from
  ``hvd.rank()`` / ``local_rank()`` / ``cross_rank()`` /
  ``process_index()`` — the seed of every SPMD-divergence bug this
  package hunts. Taint is tracked flow-insensitively per scope
  (module top level seeds the functions below it) and across calls via
  the summaries: resolvable callees contribute exactly what their
  summary says; unresolvable calls conservatively union their argument
  taints (``str(rank())`` stays tainted, ``helper()`` with clean args
  stays clean).

* **Resolution is deliberately narrow** to keep false positives out of
  ``make lint``: a bare name resolves to a same-module function, or —
  when the name was brought in by ``from m import f`` — to any linted
  module-level function of that name; ``self.m()`` resolves within the
  enclosing class; ``alias.f()`` resolves only when ``alias`` is an
  imported *module* name in that file. Arbitrary attribute calls
  (``obj.save()``) stay unresolved: guessing there is how a linter
  starts crying wolf.

This module is the lower layer: it owns the collective-call model
(``COLLECTIVE_NAMES`` et al.) so both rule families and the graph can
share it without an import cycle. The name sets are the JAX package's
plus the port's own collectives: the in-place forms (``allreduce_``,
``grouped_allreduce_``, ``broadcast_`` and their ``_async_`` forms),
``grouped_allgather_async``, ``grouped_reducescatter_async`` and the
sparse all-reduce, with the positions of their ``name`` parameters in
``horovod_tpu_torch/ops/collectives.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

#: Taint-source sentinel for process-identity values.
RANK = "rank()"

#: Calls that return this process's identity — the seed of
#: rank-dependent control flow and rank-dependent names.
RANK_CALL_NAMES: Set[str] = {
    "rank", "local_rank", "cross_rank", "process_index",
}

#: The eager collective API surface (ops/collectives.py) plus the
#: high-level wrappers that submit collectives on the caller's behalf
#: (optim/functions.py).
COLLECTIVE_NAMES: Set[str] = {
    "allreduce", "grouped_allreduce", "bucketed_allreduce", "allgather",
    "grouped_allgather",
    "broadcast", "reducescatter", "grouped_reducescatter", "alltoall",
    "barrier",
    "allreduce_async", "grouped_allreduce_async", "bucketed_allreduce_async",
    "allgather_async",
    "broadcast_async", "alltoall_async", "reducescatter_async",
    "broadcast_object", "broadcast_parameters", "broadcast_variables",
    "broadcast_optimizer_state", "allgather_object",
    # the port's own
    "allreduce_", "allreduce_async_", "grouped_allreduce_",
    "grouped_allreduce_async_", "broadcast_", "broadcast_async_",
    "grouped_allgather_async", "grouped_reducescatter_async",
    "sparse_allreduce", "sparse_allreduce_async",
}

#: Ops whose reference auto-naming collides across loop iterations
#: (HVD003), mapped to the 0-based POSITIONAL index of their `name`
#: parameter (ops/collectives.py signatures; the frontends mirror
#: them). The broadcast_* / *_object wrappers name their tensors
#: internally and barrier takes no name.
NAME_ARG_POS: Dict[str, Tuple[int, ...]] = {
    "allreduce": (2,), "grouped_allreduce": (2,),
    "bucketed_allreduce": (2,), "bucketed_allreduce_async": (2,),
    "allgather": (1,), "grouped_allgather": (1,),
    "broadcast": (2,), "reducescatter": (2,),
    "grouped_reducescatter": (2,), "alltoall": (2,),
    "allreduce_async": (2,),
    # torch's async wrapper takes name at position 1
    # (frontends/torch.py), the core alias at 2 — accept either.
    "grouped_allreduce_async": (1, 2),
    "allgather_async": (1,), "broadcast_async": (2,),
    "alltoall_async": (2,), "reducescatter_async": (2,),
    # the port's own (sparse_allreduce takes no name)
    "allreduce_": (2,), "allreduce_async_": (2,),
    "grouped_allreduce_": (2,), "grouped_allreduce_async_": (2,),
    "broadcast_": (2,), "broadcast_async_": (2,),
    "grouped_allgather_async": (1,), "grouped_reducescatter_async": (2,),
    "sparse_allreduce_async": (1,),
}
NAMED_OP_NAMES: Set[str] = set(NAME_ARG_POS)

#: Receivers whose methods share names with our API but are NOT Horovod
#: collectives (np.broadcast, tf.broadcast_to's relatives, etc.).
FOREIGN_ROOTS: Set[str] = {
    "np", "numpy", "jnp", "jax", "lax", "torch", "tf", "tensorflow",
    "mx", "mxnet", "keras", "K",
}


def terminal_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def root_name(func: ast.AST) -> Optional[str]:
    node = func
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def is_collective_call(node: ast.AST) -> Optional[str]:
    """The collective's op name if `node` is a Horovod collective call."""
    if not isinstance(node, ast.Call):
        return None
    name = terminal_name(node.func)
    if name not in COLLECTIVE_NAMES:
        return None
    if isinstance(node.func, ast.Attribute) \
            and root_name(node.func) in FOREIGN_ROOTS:
        return None
    return name


def kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def name_argument(call: ast.Call, op: str) -> Optional[ast.expr]:
    """The expression passed as `name` — keyword or positional."""
    expr = kwarg(call, "name")
    if expr is not None:
        return expr
    for pos in NAME_ARG_POS.get(op, ()):
        if len(call.args) > pos \
                and not isinstance(call.args[pos], ast.Starred):
            return call.args[pos]
    return None


def contains_rank_call(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) \
                and terminal_name(sub.func) in RANK_CALL_NAMES:
            return True
    return False


# ------------------------------------------------------------- summaries

#: A symbolic ``process_set=`` value: ("none",) when absent,
#: ("param", i) when the callee passes its own i-th parameter through,
#: ("expr", <ast.dump>) otherwise.
PsToken = Tuple[str, ...]
PS_NONE: PsToken = ("none",)


class FunctionInfo:
    """One linted function/method and its transitive-effect summary."""

    __slots__ = ("name", "cls", "path", "lineno", "node", "sf", "params",
                 "collectives", "origins", "tainted_return",
                 "return_taint_params", "name_taint_params")

    def __init__(self, name: str, cls: Optional[str], sf, node) -> None:
        self.name = name
        self.cls = cls
        self.sf = sf
        self.path = sf.path
        self.lineno = node.lineno
        self.node = node
        self.params = [a.arg for a in node.args.args]
        # op -> set of PsToken this function (transitively) issues it with
        self.collectives: Dict[str, Set[PsToken]] = {}
        # op -> human-readable origin ("m.py:12" or "via 'g' (m.py:3)")
        self.origins: Dict[str, str] = {}
        self.tainted_return = False
        self.return_taint_params: Set[int] = set()
        self.name_taint_params: Set[int] = set()

    def label(self) -> str:
        qual = f"{self.cls}.{self.name}" if self.cls else self.name
        return f"'{qual}' ({self.path}:{self.lineno})"


def _path_is_module(path: str, module: str) -> bool:
    """Does the file at `path` implement dotted `module`? Suffix-matched
    so relative imports ("checkpoint") and absolute ones
    ("horovod_tpu_torch.checkpoint") both pair with
    "horovod_tpu_torch/checkpoint.py" (or the package's __init__.py)."""
    p = path.replace("\\", "/")
    if p.endswith("/__init__.py"):
        p = p[: -len("/__init__.py")]
    elif p.endswith(".py"):
        p = p[:-3]
    dotted = p.strip("/").replace("/", ".")
    return dotted == module or dotted.endswith("." + module)


class CallGraph:
    """Call graph + summaries over a set of parsed SourceFiles."""

    #: Fixpoint bounds — generous for any real repo, tiny for safety.
    _MAX_ROUNDS = 20
    _MAX_LOCAL_ROUNDS = 8

    def __init__(self, sfs: Sequence) -> None:
        self._sfs = list(sfs)
        self._by_name: Dict[str, List[FunctionInfo]] = {}
        self._methods: Dict[Tuple[str, str, str], FunctionInfo] = {}
        # per file: from-imported name -> source module ("" = unknowable,
        # e.g. `from . import x`; resolution then stays empty rather than
        # guessing across same-named functions).
        self._from_imports: Dict[str, Dict[str, str]] = {}
        # per file: bound import name -> the module it denotes
        # (`import a.b as z` -> {"z": "a.b"}; `import a.b` -> {"a": "a"}).
        self._module_aliases: Dict[str, Dict[str, str]] = {}
        # (path, id(call node)) -> enclosing class name (for self.x())
        self._call_cls: Dict[Tuple[str, int], Optional[str]] = {}
        self._taint_cache: Dict[Tuple[str, int], "_TaintEnv"] = {}
        for sf in self._sfs:
            self._index_file(sf)
        self._summarize_all()
        # Taint envs built DURING the summary fixpoint saw half-built
        # summaries (e.g. a module global assigned from a helper whose
        # tainted_return had not been discovered yet). Drop them so the
        # rules recompute against the final summaries.
        self._taint_cache.clear()

    # ------------------------------------------------------------ indexing
    def _index_file(self, sf) -> None:
        froms: Dict[str, str] = {}
        aliases: Dict[str, str] = {}
        self._from_imports[sf.path] = froms
        self._module_aliases[sf.path] = aliases

        def visit(node: ast.AST, cls: Optional[str], depth: int) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.Import):
                    for a in child.names:
                        if a.asname:
                            aliases[a.asname] = a.name
                        else:
                            root = a.name.split(".")[0]
                            aliases[root] = root
                elif isinstance(child, ast.ImportFrom):
                    for a in child.names:
                        froms[a.asname or a.name] = child.module or ""
                if isinstance(child, ast.Call):
                    self._call_cls[(sf.path, id(child))] = cls
                child_cls, child_depth = cls, depth
                if isinstance(child, ast.ClassDef):
                    child_cls = child.name
                    child_depth = depth + 1
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    fi = FunctionInfo(child.name, cls, sf, child)
                    if depth == 0 and cls is None:
                        self._by_name.setdefault(child.name,
                                                 []).append(fi)
                    elif cls is not None:
                        self._methods[(sf.path, cls, child.name)] = fi
                    else:
                        # nested def: indexed nowhere, but its calls
                        # still carry class context for self.x().
                        pass
                    child_depth = depth + 1
                visit(child, child_cls, child_depth)

        visit(sf.tree, None, 0)

    def _all_functions(self) -> Iterator[FunctionInfo]:
        for fis in self._by_name.values():
            yield from fis
        yield from self._methods.values()

    # ---------------------------------------------------------- resolution
    def resolve(self, sf, call: ast.Call) -> List[FunctionInfo]:
        """Linted functions a call may land in ([] = unknown/foreign)."""
        func = call.func
        if isinstance(func, ast.Name):
            cands = self._by_name.get(func.id, [])
            local = [f for f in cands if f.path == sf.path]
            if local:
                return local
            mod = self._from_imports.get(sf.path, {}).get(func.id)
            if mod:
                # Only functions defined in THAT module: a name imported
                # from an unlinted module must not resolve to an
                # unrelated same-named linted function.
                return [f for f in cands if _path_is_module(f.path, mod)]
            return []
        if isinstance(func, ast.Attribute):
            # Full receiver chain: `a.b.f(...)` -> segs ["a","b"],
            # terminal "f".
            segs: List[str] = []
            node = func.value
            while isinstance(node, ast.Attribute):
                segs.append(node.attr)
                node = node.value
            if not isinstance(node, ast.Name):
                return []
            segs.append(node.id)
            segs.reverse()
            root = segs[0]
            if root in ("self", "cls") and len(segs) == 1:
                encl = self._call_cls.get((sf.path, id(call)))
                if encl is not None:
                    fi = self._methods.get((sf.path, encl, func.attr))
                    if fi is not None:
                        return [fi]
                return []
            if root in FOREIGN_ROOTS:
                return []
            aliasmod = self._module_aliases.get(sf.path, {}).get(root)
            if aliasmod:
                # The callee must live in the module the alias denotes —
                # never "any linted function with that name".
                module = ".".join([aliasmod] + segs[1:])
                return [f for f in self._by_name.get(func.attr, [])
                        if _path_is_module(f.path, module)]
        return []

    # ------------------------------------------------------------- effects
    def call_effects(self, sf, call: ast.Call
                     ) -> List[Tuple[str, Optional[str], str]]:
        """(op, concrete ps repr, origin label) for every collective a
        resolvable non-collective call transitively issues, with
        parameter-symbolic process sets substituted from this call's
        arguments. Empty for direct collectives and unresolved calls."""
        if is_collective_call(call) is not None:
            return []
        out: List[Tuple[str, Optional[str], str]] = []
        for fi in self.resolve(sf, call):
            for op, tokens in fi.collectives.items():
                origin = (f"via {fi.label()}"
                          if fi.origins.get(op, "").startswith("via")
                          else f"in {fi.label()}")
                for tok in tokens:
                    out.append((op, self._subst_ps(fi, call, tok), origin))
        return out

    def _subst_ps(self, fi: FunctionInfo, call: ast.Call,
                  tok: PsToken) -> Optional[str]:
        if tok == PS_NONE:
            return None
        if tok[0] == "expr":
            return tok[1]
        idx = int(tok[1])
        arg = self._arg_for_param(fi, call, idx)
        return ast.dump(arg) if arg is not None else None

    @staticmethod
    def _arg_for_param(fi: FunctionInfo, call: ast.Call,
                       idx: int) -> Optional[ast.expr]:
        """The call-site expression bound to `fi`'s idx-th parameter."""
        pos = idx
        if fi.params and fi.params[0] in ("self", "cls") \
                and isinstance(call.func, ast.Attribute):
            pos = idx - 1  # bound method: self is implicit at the call
        if 0 <= pos < len(call.args) \
                and not any(isinstance(a, ast.Starred)
                            for a in call.args[:pos + 1]):
            return call.args[pos]
        if 0 <= idx < len(fi.params):
            return kwarg(call, fi.params[idx])
        return None

    # --------------------------------------------------------------- taint
    def taint_env(self, sf, scope: Optional[ast.AST]) -> "_TaintEnv":
        """Flow-insensitive taint for one scope (None = module top
        level); function scopes are seeded with the module scope's
        tainted globals."""
        node = scope if scope is not None else sf.tree
        key = (sf.path, id(node))
        env = self._taint_cache.get(key)
        if env is None:
            seed: Dict[str, Set[str]] = {}
            if scope is not None:
                seed = dict(self.taint_env(sf, None).vars)
            env = _TaintEnv(self, sf, node, seed)
            self._taint_cache[key] = env
        return env

    # ------------------------------------------------------------ summaries
    def _summarize_all(self) -> None:
        funcs = list(self._all_functions())
        for _ in range(self._MAX_ROUNDS):
            changed = False
            for fi in funcs:
                if self._summarize(fi):
                    changed = True
            if not changed:
                return

    def _summarize(self, fi: FunctionInfo) -> bool:
        """One summary pass; True if anything grew."""
        env = _TaintEnv(self, fi.sf, fi.node,
                        dict(self.taint_env(fi.sf, None).vars))
        changed = False
        for node in _scope_walk(fi.node):
            if isinstance(node, ast.Return) and node.value is not None:
                t = env.expr(node.value)
                if RANK in t and not fi.tainted_return:
                    fi.tainted_return = changed = True
                for src in t:
                    if isinstance(src, tuple) \
                            and src[1] not in fi.return_taint_params:
                        fi.return_taint_params.add(src[1])
                        changed = True
            if not isinstance(node, ast.Call):
                continue
            op = is_collective_call(node)
            if op is not None:
                tok = self._ps_token(fi, node)
                if tok not in fi.collectives.setdefault(op, set()):
                    fi.collectives[op].add(tok)
                    changed = True
                fi.origins.setdefault(op, f"{fi.path}:{node.lineno}")
                name_expr = name_argument(node, op)
                if name_expr is not None:
                    for src in env.expr(name_expr):
                        if isinstance(src, tuple) \
                                and src[1] not in fi.name_taint_params:
                            fi.name_taint_params.add(src[1])
                            changed = True
                continue
            for callee in self.resolve(fi.sf, node):
                for op, tokens in callee.collectives.items():
                    mine = fi.collectives.setdefault(op, set())
                    for tok in tokens:
                        tok = self._retoken(fi, callee, node, tok)
                        if tok not in mine:
                            mine.add(tok)
                            changed = True
                    fi.origins.setdefault(op, f"via {callee.label()}")
                for idx in callee.name_taint_params:
                    arg = self._arg_for_param(callee, node, idx)
                    if arg is None:
                        continue
                    for src in env.expr(arg):
                        if isinstance(src, tuple) \
                                and src[1] not in fi.name_taint_params:
                            fi.name_taint_params.add(src[1])
                            changed = True
        return changed

    def _ps_token(self, fi: FunctionInfo, call: ast.Call) -> PsToken:
        ps = kwarg(call, "process_set")
        if ps is None:
            return PS_NONE
        if isinstance(ps, ast.Name) and ps.id in fi.params:
            return ("param", fi.params.index(ps.id))
        return ("expr", ast.dump(ps))

    def _retoken(self, fi: FunctionInfo, callee: FunctionInfo,
                 call: ast.Call, tok: PsToken) -> PsToken:
        """Rewrite a callee's symbolic ps token into this function's
        frame: callee-parameter references become either our own
        parameter references or the concrete call-site expression."""
        if tok == PS_NONE or tok[0] == "expr":
            return tok
        arg = self._arg_for_param(callee, call, int(tok[1]))
        if arg is None:
            return PS_NONE
        if isinstance(arg, ast.Name) and arg.id in fi.params:
            return ("param", fi.params.index(arg.id))
        return ("expr", ast.dump(arg))


def _scope_walk(root: ast.AST) -> Iterator[ast.AST]:
    """ast.walk pruned at nested function/class boundaries."""
    stack: List[ast.AST] = [root]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node is not root:
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class _TaintEnv:
    """Per-scope taint table: name -> set of sources (RANK and/or
    ("param", i))."""

    def __init__(self, graph: CallGraph, sf, scope: ast.AST,
                 seed: Dict[str, Set[str]]) -> None:
        self.graph = graph
        self.sf = sf
        self.vars: Dict[str, Set] = dict(seed)
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for i, a in enumerate(scope.args.args):
                self.vars.setdefault(a.arg, set()).add(("param", i))
        self._solve(scope)

    def _solve(self, scope: ast.AST) -> None:
        binds: List[Tuple[ast.expr, ast.expr]] = []
        for node in _scope_walk(scope):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    binds.append((t, node.value))
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                if node.value is not None:
                    binds.append((node.target, node.value))
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                binds.append((node.target, node.iter))
            elif isinstance(node, ast.NamedExpr):
                binds.append((node.target, node.value))
        for _ in range(CallGraph._MAX_LOCAL_ROUNDS):
            changed = False
            for target, value in binds:
                t = self.expr(value)
                if not t:
                    continue
                for n in ast.walk(target):
                    if isinstance(n, ast.Name):
                        cur = self.vars.setdefault(n.id, set())
                        if not t <= cur:
                            cur.update(t)
                            changed = True
            if not changed:
                return

    def expr(self, e: ast.AST) -> Set:
        if isinstance(e, ast.Name):
            return set(self.vars.get(e.id, ()))
        if isinstance(e, ast.Call):
            if terminal_name(e.func) in RANK_CALL_NAMES:
                return {RANK}
            callees = self.graph.resolve(self.sf, e)
            if callees:
                out: Set = set()
                for fi in callees:
                    if fi.tainted_return:
                        out.add(RANK)
                    for idx in fi.return_taint_params:
                        arg = CallGraph._arg_for_param(fi, e, idx)
                        if arg is not None:
                            out |= self.expr(arg)
                return out
            # Unresolved call: conservatively, taint flows through
            # arguments (str(rank()), format(...), sorted(...)).
            out = set()
            for a in e.args:
                out |= self.expr(a)
            for kw in e.keywords:
                out |= self.expr(kw.value)
            return out
        if isinstance(e, (ast.Lambda, ast.FunctionDef,
                          ast.AsyncFunctionDef, ast.ClassDef)):
            return set()
        out: Set = set()
        for child in ast.iter_child_nodes(e):
            out |= self.expr(child)
        return out

    def rank_tainted(self, e: ast.AST) -> bool:
        return RANK in self.expr(e)
