"""HVD-ENV: every HOROVOD_* env var the port's code names is documented
(counterpart of horovod_tpu/analysis/env_rule.py).

The knob surface drifts: code grows ``HOROVOD_FOO`` reads faster than
docs grow tables. This rule extracts every quoted ``"HOROVOD_..."``
string literal from ``horovod_tpu_torch/**/*.py`` and requires the exact
name to be documented in one of two places:

* ``docs/env_vars.md``, the JAX package's catalog, whose knobs the port
  reads under the same names (read, never edited from here);
* a table of the port's own knobs in README.md's port section (the
  ``## PyTorch/CUDA port`` section up to the next ``## `` heading; only
  its table rows count).

Composed names (a policy prefix like HOROVOD_KV_RETRY plus a
``_MAX_ATTEMPTS`` suffix) are covered by documenting the prefix in
either place: a literal that is a documented literal plus a documented
suffix pattern passes.
"""

from __future__ import annotations

import pathlib
import re
from typing import Dict, List, Optional, Set, Tuple

from horovod_tpu_torch.analysis.driver import (Finding, MSG_NO_RATIONALE,
                                               parse_suppression,
                                               suppression_covers)

RULE_ID = "HVD-ENV"
DESCRIPTION = "HOROVOD_* env var referenced in code but undocumented"

LITERAL_RE = re.compile(r"""["'](HOROVOD_[A-Z0-9_]+)["']""")
NAME_RE = re.compile(r"HOROVOD_[A-Z0-9_]+")

# Suffixes appended to documented prefixes at runtime (RetryPolicy.from_env
# env scheme): HOROVOD_KV_RETRY + _MAX_ATTEMPTS etc.
COMPOSED_SUFFIXES = ("_MAX_ATTEMPTS", "_BASE_DELAY", "_MAX_DELAY",
                     "_MULTIPLIER", "_JITTER", "_DEADLINE")

#: The heading of README.md's section on the port.
PORT_SECTION = "## PyTorch/CUDA port"


def referenced_vars(code_dir: pathlib.Path
                    ) -> Dict[str, List[Tuple[str, int, str]]]:
    """name -> [(relative path, line, line text), ...] references."""
    found: Dict[str, List[Tuple[str, int, str]]] = {}
    root = code_dir.parent
    for path in sorted(code_dir.glob("**/*.py")):
        rel = str(path.relative_to(root))
        for lineno, line in enumerate(
                path.read_text(encoding="utf-8").splitlines(), 1):
            for name in LITERAL_RE.findall(line):
                found.setdefault(name, []).append((rel, lineno, line))
    return found


def readme_port_knobs(readme: pathlib.Path) -> Set[str]:
    """HOROVOD_* names in the table rows of README.md's port section."""
    if not readme.exists():
        return set()
    names: Set[str] = set()
    inside = False
    for line in readme.read_text(encoding="utf-8").splitlines():
        if line.startswith("## "):
            inside = line.strip() == PORT_SECTION
        elif inside and line.lstrip().startswith("|"):
            names.update(NAME_RE.findall(line))
    return names


def documented_vars(root: pathlib.Path) -> Set[str]:
    catalog = root / "docs" / "env_vars.md"
    names = set(NAME_RE.findall(catalog.read_text(encoding="utf-8"))) \
        if catalog.exists() else set()
    return names | readme_port_knobs(root / "README.md")


def check_project(root: Optional[str] = None) -> List[Finding]:
    """Repo-level check; returns one finding per undocumented var."""
    root_path = (pathlib.Path(root) if root is not None
                 else pathlib.Path(__file__).resolve().parent.parent.parent)
    code_dir = root_path / "horovod_tpu_torch"
    if not code_dir.is_dir() or not (root_path / "docs").is_dir():
        return []  # not running inside the repo: nothing to check
    refs = referenced_vars(code_dir)
    docs = documented_vars(root_path)
    findings: List[Finding] = []
    for name, sites in sorted(refs.items()):
        if name in docs:
            continue
        if any(name.endswith(sfx) and name[: -len(sfx)] in docs
               for sfx in COMPOSED_SUFFIXES):
            continue
        # The driver's suppression grammar applies here too: a covering
        # suppression on ANY referencing line silences the var; without
        # a rationale it degrades to HVD000, as for the AST rules.
        entries = [(path, lineno, parse_suppression(text))
                   for path, lineno, text in sites]
        covering = [(p, ln, e) for p, ln, e in entries
                    if suppression_covers(e, RULE_ID)]
        if covering:
            for p, ln, e in covering:
                if not e[1]:
                    findings.append(Finding(p, ln, "HVD000",
                                            MSG_NO_RATIONALE))
            continue
        path, lineno, _ = sites[0]
        findings.append(Finding(
            path, lineno, RULE_ID,
            f"undocumented env var {name}: add it to the table of the "
            f"port's knobs in README.md's port section"))
    return findings
