"""hvdlint driver: rule registry, suppression handling, CLI
(counterpart of horovod_tpu/analysis/driver.py).

One entrypoint (``python -m horovod_tpu_torch.analysis``), one exit
code, one output format::

    file:line RULE-ID message

Rules have stable IDs (HVD0xx collective consistency, HVD1xx concurrency
discipline, HVD-ENV documentation drift). A finding on a line is
suppressed by a trailing ``hvdlint: disable=HVD001 -- root-only by
design`` comment on that line. The rationale after ``--`` is mandatory:
a bare suppression is itself a finding (HVD000), so every silenced rule
carries an explanation a reviewer can audit. ``disable`` with no ID list
suppresses every rule on the line (rationale still required).

Findings also feed the process metrics registry
(``hvdlint_findings_total{rule}``, observability/metrics.py) so lint runs
wired into jobs surface in the same telemetry plane as the runtime.

The JAX package's analyzers of lowered XLA programs (``--hlo``,
``--shard``, ``--sched``, ``--num``, ``--hlo-step``) have no port yet:
they need an analog over torch graphs (ROADMAP A15), and the options
exit 2 saying so.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import pathlib
import re
import sys
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: Suppression comment grammar (docs/static_analysis.md). A rule ID
#: token may contain single dashes (HVD-ENV) but the token pattern
#: cannot cross the ``--`` rationale separator.
_ID_TOKEN = r"[A-Za-z0-9_]+(?:-[A-Za-z0-9_]+)*"
_SUPPRESS_RE = re.compile(
    r"#\s*hvdlint:\s*disable"
    rf"(?:=(?P<ids>{_ID_TOKEN}(?:\s*,\s*{_ID_TOKEN})*))?"
    r"(?:\s*--\s*(?P<why>\S.*))?")

#: Suppress-all sentinel in a parsed suppression entry.
_ALL = "*"

HVD000 = "HVD000"

#: Shared by the AST pass and the HVD-ENV pass — lint_paths dedupes
#: cross-pass findings by exact message, so there must be ONE copy.
MSG_NO_RATIONALE = ("suppression comment lacks a rationale: append "
                    "' -- <why this is safe>' to the disable comment")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, anchored to a source location."""

    path: str
    line: int
    rule_id: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule_id} {self.message}"

    def as_dict(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line,
                "rule": self.rule_id, "message": self.message}


def parse_suppression(line: str) -> Optional[Tuple[Set[str], bool]]:
    """(suppressed rule ids or {"*"}, has_rationale) for one source
    line, or None if it carries no suppression comment. Shared by the
    AST rules (via SourceFile) and the repo-level HVD-ENV rule."""
    m = _SUPPRESS_RE.search(line)
    if not m:
        return None
    ids = m.group("ids")
    ruleset = ({_ALL} if ids is None else
               {i.strip().upper() for i in ids.split(",") if i.strip()})
    return ruleset, m.group("why") is not None


def suppression_covers(entry: Optional[Tuple[Set[str], bool]],
                       rule_id: str) -> bool:
    if entry is None:
        return False
    ruleset, _ = entry
    return _ALL in ruleset or rule_id.upper() in ruleset


class SourceFile:
    """Parsed source + per-line suppression table shared by every rule."""

    def __init__(self, path: str, text: str) -> None:
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        # line -> (set of suppressed rule ids or {_ALL}, has_rationale)
        self.suppressions: Dict[int, Tuple[Set[str], bool]] = {}
        for lineno, line in enumerate(self.lines, 1):
            entry = parse_suppression(line)
            if entry is not None:
                self.suppressions[lineno] = entry

    def suppressed(self, line: int, rule_id: str) -> bool:
        return suppression_covers(self.suppressions.get(line), rule_id)

    def finding(self, node: ast.AST, rule_id: str, message: str) -> Finding:
        return Finding(self.path, getattr(node, "lineno", 1), rule_id,
                       message)


def _rationale_findings(sf: SourceFile) -> Iterable[Finding]:
    """HVD000: a suppression without a ``-- rationale`` is a finding."""
    for lineno, (_ids, has_why) in sorted(sf.suppressions.items()):
        if not has_why:
            yield Finding(sf.path, lineno, HVD000, MSG_NO_RATIONALE)


def registry() -> Dict[str, Tuple[str, object]]:
    """rule_id -> (one-line description, check(sf) -> iterable[Finding]).

    Imported lazily so the CLI only pays for (and only can fail on) the
    rule modules it actually runs.
    """
    from horovod_tpu_torch.analysis import collective_rules, concurrency_rules
    reg: Dict[str, Tuple[str, object]] = {}
    reg.update(collective_rules.RULES)
    reg.update(concurrency_rules.RULES)
    return reg


def lint_source(text: str, path: str = "<string>",
                select: Optional[Sequence[str]] = None,
                ignore: Sequence[str] = (),
                graph: Optional[object] = None) -> List[Finding]:
    """Run the AST rule families over one source blob (unit-test surface).

    Returns surviving findings (suppressions applied), sorted by line.
    `graph` is the lint run's shared CallGraph; a single-blob run builds
    its own one-file graph.
    """
    sf = SourceFile(path, text)
    return _lint_sf(sf, select=select, ignore=ignore, graph=graph)


def _lint_sf(sf: SourceFile,
             select: Optional[Sequence[str]] = None,
             ignore: Sequence[str] = (),
             graph: Optional[object] = None) -> List[Finding]:
    if graph is None:
        from horovod_tpu_torch.analysis.callgraph import CallGraph
        graph = CallGraph([sf])
    sf.graph = graph
    reg = registry()
    wanted = {r.upper() for r in select} if select is not None else None
    ignored = {r.upper() for r in ignore}
    out: List[Finding] = []
    if (wanted is None or HVD000 in wanted) and HVD000 not in ignored:
        out.extend(_rationale_findings(sf))
    for rule_id, (_desc, check) in sorted(reg.items()):
        if wanted is not None and rule_id not in wanted:
            continue
        if rule_id in ignored:
            continue
        for f in check(sf):
            if not sf.suppressed(f.line, f.rule_id):
                out.append(f)
    out.sort(key=lambda f: (f.line, f.rule_id))
    return out


def _iter_py_files(paths: Sequence[str]) -> Iterable[pathlib.Path]:
    seen: Set[pathlib.Path] = set()
    for p in paths:
        path = pathlib.Path(p)
        candidates = (sorted(path.rglob("*.py")) if path.is_dir()
                      else [path])
        for c in candidates:
            c = c.resolve()
            if c in seen or c.suffix != ".py" or not c.exists():
                continue
            # Generated/vendored trees have no lint contract.
            if "__pycache__" in c.parts:
                continue
            seen.add(c)
            yield c


def lint_paths(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               ignore: Sequence[str] = (),
               root: Optional[str] = None,
               env_rule: bool = True) -> List[Finding]:
    """Lint every ``*.py`` under `paths` + the repo-level HVD-ENV rule."""
    findings: List[Finding] = []
    for p in paths:
        # A typo'd path must FAIL the gate, not silently lint nothing —
        # this command fronts CI.
        if not pathlib.Path(p).exists():
            findings.append(Finding(str(p), 1, "HVD999",
                                    "path does not exist"))
    # Parse everything FIRST: the interprocedural rules need one call
    # graph spanning every linted file before any rule runs.
    sfs: List[SourceFile] = []
    for path in _iter_py_files(paths):
        rel = path
        if root is not None:
            try:
                rel = path.relative_to(pathlib.Path(root).resolve())
            except ValueError:
                pass
        try:
            text = path.read_text(encoding="utf-8")
            sfs.append(SourceFile(str(rel), text))
        except SyntaxError as e:
            findings.append(Finding(str(rel), e.lineno or 1, "HVD999",
                                    f"syntax error: {e.msg}"))
        except OSError as e:
            findings.append(Finding(str(rel), 1, "HVD999",
                                    f"unreadable: {e}"))
    from horovod_tpu_torch.analysis.callgraph import CallGraph
    graph = CallGraph(sfs)
    for sf in sfs:
        findings.extend(_lint_sf(sf, select=select, ignore=ignore,
                                 graph=graph))
    if env_rule and (select is None or "HVD-ENV" in
                     {s.upper() for s in select}) \
            and "HVD-ENV" not in {i.upper() for i in ignore}:
        from horovod_tpu_torch.analysis import env_rule as env_mod
        findings.extend(env_mod.check_project(root))
    # The AST pass and the project-level HVD-ENV pass can both report
    # the same location (e.g. HVD000 for one bare suppression): dedupe.
    unique: Dict[Tuple[str, int, str, str], Finding] = {}
    for f in findings:
        unique.setdefault((f.path, f.line, f.rule_id, f.message), f)
    findings = list(unique.values())
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return findings


def _baseline_key(f: Finding) -> Tuple[str, str, str]:
    """Baseline identity for a finding. Line numbers churn with every
    unrelated edit, so they are excluded — both the anchor line and any
    line references embedded in the message (normalized to 'N')."""
    return (f.path, f.rule_id, re.sub(r"\d+", "N", f.message))


def load_baseline(path: str) -> Counter:
    """Multiset of accepted findings from a ``--format json`` dump (or a
    bare JSON list of finding objects)."""
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data.get("findings", []) if isinstance(data, dict) else data
    # Shape errors must surface as ValueError so the CLI's 'unreadable
    # baseline' exit-2 path catches them (not an AttributeError crash).
    if not isinstance(entries, list) \
            or not all(isinstance(e, dict) for e in entries):
        raise ValueError(
            "baseline must be a --format json dump (or a JSON list of "
            "finding objects)")
    keys = []
    for e in entries:
        keys.append((str(e.get("path", "")), str(e.get("rule", "")),
                     re.sub(r"\d+", "N", str(e.get("message", "")))))
    return Counter(keys)


def apply_baseline(findings: Sequence[Finding],
                   baseline: Counter) -> Tuple[List[Finding], int]:
    """(new findings, count matched by the baseline). Multiplicity-aware:
    a baseline entry absorbs at most as many findings as it was recorded
    with, so a *new* duplicate of a baselined finding still gates."""
    budget = Counter(baseline)
    new: List[Finding] = []
    matched = 0
    for f in findings:
        key = _baseline_key(f)
        if budget[key] > 0:
            budget[key] -= 1
            matched += 1
        else:
            new.append(f)
    return new, matched


def render_json(findings: Sequence[Finding]) -> str:
    """The ``--format json`` payload — also the baseline file format."""
    return json.dumps(
        {"findings": [f.as_dict() for f in findings],
         "count": len(findings)}, indent=2, sort_keys=True) + "\n"


def _record_metrics(findings: Sequence[Finding]) -> None:
    """Feed findings into the metrics plane (observability/metrics.py);
    lint must still work in environments without the runtime deps, so
    any import failure is swallowed."""
    try:
        from horovod_tpu_torch.observability import metrics as m
        counter = m.registry().counter(
            "hvdlint_findings_total", "hvdlint findings by rule",
            labelnames=("rule",))
        for f in findings:
            counter.labels(rule=f.rule_id).inc()
    except Exception:
        pass


#: The JAX package's options for lowered XLA programs, which wait for
#: their port (ROADMAP A15).
HLO_OPTIONS = ("--hlo", "--shard", "--sched", "--num", "--hlo-step")


def run_cli(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis",
        description="hvdlint: collective-consistency and concurrency "
                    "static analysis of Python source")
    parser.add_argument("paths", nargs="*", default=[],
                        help="files or directories to lint")
    for flag in HLO_OPTIONS[:-1]:
        parser.add_argument(flag, action="store_true",
                            help="an analyzer of lowered XLA programs: "
                                 "not in the port yet (exits 2; ROADMAP "
                                 "A15)")
    parser.add_argument("--hlo-step", default=None, metavar="PROGRAM",
                        help="lint a lowered step program: not in the "
                             "port yet (exits 2; ROADMAP A15)")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule IDs to run (default all)")
    parser.add_argument("--ignore", default="",
                        help="comma-separated rule IDs to skip")
    parser.add_argument("--no-env", action="store_true",
                        help="skip the repo-level HVD-ENV docs-drift rule")
    parser.add_argument("--root", default=None,
                        help="repo root for HVD-ENV and relative paths "
                             "(default: auto-detected from this package)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text", dest="fmt",
                        help="output format; json doubles as the "
                             "--baseline file format")
    parser.add_argument("--baseline", default=None, metavar="FILE",
                        help="diff-aware mode: findings recorded in FILE "
                             "(a --format json dump) are accepted; only "
                             "NEW findings are printed and gate the exit "
                             "code")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    hlo = [flag for flag in HLO_OPTIONS
           if getattr(args, flag[2:].replace("-", "_")) not in (None, False)]
    if hlo:
        print(f"hvdlint: {', '.join(hlo)}: the analyzers of lowered "
              f"programs (hvdhlo, hvdshard, hvdsched, hvdnum) are not in "
              f"the port yet: they need an analog over torch graphs, "
              f"ROADMAP A15", file=sys.stderr)
        return 2
    if args.list_rules:
        from horovod_tpu_torch.analysis import env_rule as env_mod
        reg = dict(registry())
        reg[env_mod.RULE_ID] = (env_mod.DESCRIPTION, None)
        reg[HVD000] = ("suppression comment lacks a rationale", None)
        for rule_id in sorted(reg):
            print(f"{rule_id}  {reg[rule_id][0]}")
        return 0
    if not args.paths:
        parser.error("no paths given (try: horovod_tpu_torch/)")

    root = args.root
    if root is None:
        # horovod_tpu_torch/analysis/driver.py -> the repo root, two
        # levels up from the package directory.
        root = str(pathlib.Path(__file__).resolve().parent.parent.parent)
    select = ([s.strip() for s in args.select.split(",") if s.strip()]
              if args.select else None)
    ignore = [s.strip() for s in args.ignore.split(",") if s.strip()]
    findings = lint_paths(args.paths, select=select, ignore=ignore,
                          root=root, env_rule=not args.no_env)
    matched = 0
    if args.baseline is not None:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            # A broken baseline must fail the gate, not pass everything.
            print(f"hvdlint: unreadable baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
        findings, matched = apply_baseline(findings, baseline)
    _record_metrics(findings)
    if args.fmt == "json":
        sys.stdout.write(render_json(findings))
    else:
        for f in findings:
            print(f.render())
    if findings:
        tag = " new" if args.baseline is not None else ""
        print(f"hvdlint: {len(findings)}{tag} finding(s)"
              + (f" ({matched} baselined)" if matched else ""),
              file=sys.stderr)
        return 1
    if args.fmt != "json":
        print("hvdlint: clean"
              + (f" ({matched} baselined)" if matched else ""))
    return 0


def main() -> None:
    sys.exit(run_cli())
