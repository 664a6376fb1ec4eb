"""The port's hvdlint (horovod_tpu_torch/analysis/) against the JAX
package's (horovod_tpu/analysis/).

The rule corpus of tests/test_hvdlint.py, one parametrised case per
snippet: each goes through both packages' `lint_source` (and the
multi-file cases through both `lint_paths`) and must give the same
(line, rule, message) list, which must also hold the rule IDs the JAX
test expects. Then the port's own surface: the driver's output, exit
codes, JSON and baseline, the HVD-ENV rule over `horovod_tpu_torch/`
(with README.md's table of the port's knobs), the options for lowered
programs exiting 2 naming ROADMAP A15, the checked-in empty baseline,
and the port linting clean under both packages' lints.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from horovod_tpu.analysis import driver as jdriver
from horovod_tpu_torch.analysis import driver as tdriver
from horovod_tpu_torch.analysis import env_rule as tenv
from horovod_tpu_torch.analysis.driver import lint_paths, run_cli

run_jax_cli = jdriver.run_cli

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "horovod_tpu_torch"


def src(text):
    return textwrap.dedent(text)


def triples(findings):
    return [(f.line, f.rule_id, f.message) for f in findings]


# (case id, source, rule IDs the JAX test expects, select)
CORPUS = [
    ("hvd001_rank_guarded", """
        import horovod_tpu as hvd
        def f(x):
            if hvd.rank() == 0:
                hvd.broadcast(x, root_rank=0)
    """, ["HVD001"], None),
    ("hvd001_else_and_while", """
        import horovod_tpu as hvd
        def f(x):
            if hvd.rank() == 0:
                pass
            else:
                hvd.allreduce(x)
            while hvd.local_rank() != 0:
                hvd.barrier()
    """, ["HVD001", "HVD001"], None),
    ("hvd001_ifexp", """
        import horovod_tpu as hvd
        def f(x):
            return hvd.allreduce(x, name="a") if hvd.rank() == 0 else x
    """, ["HVD001"], None),
    ("hvd001_no_collective_under_guard", """
        import horovod_tpu as hvd
        def f(x):
            y = hvd.allreduce(x, name="t")
            if hvd.rank() == 0:
                print(y)
    """, [], None),
    ("hvd001_nested_def_not_flagged", """
        import horovod_tpu as hvd
        def f(x):
            if hvd.rank() == 0:
                def helper():
                    return hvd.allreduce(x)
            return 0
    """, [], None),
    ("hvd001_suppressed", """
        import horovod_tpu as hvd
        def f(x):
            if hvd.rank() == 0:
                hvd.broadcast(x, root_rank=0)  # hvdlint: disable=HVD001 -- every rank reaches this branch via a synced flag
    """, [], None),
    ("hvd000_bare_suppression", """
        import horovod_tpu as hvd
        def f(x):
            if hvd.rank() == 0:
                hvd.broadcast(x, root_rank=0)  # hvdlint: disable=HVD001
    """, ["HVD000"], None),
    ("hvd000_suppress_all_with_rationale", """
        import horovod_tpu as hvd
        def f(x):
            if hvd.rank() == 0:
                hvd.broadcast(x, root_rank=0)  # hvdlint: disable -- root-only on purpose
    """, [], None),
    ("foreign_receivers", """
        import numpy as np, jax.numpy as jnp, horovod_tpu as hvd
        def f(x):
            if hvd.rank() == 0:
                np.broadcast(x, x)
                jnp.broadcast(x, x)
    """, [], None),
    ("foreign_torch_receiver", """
        import torch, horovod_tpu_torch as hvd
        def f(x):
            if hvd.rank() == 0:
                torch.broadcast_tensors(x, x)
                torch.distributed.broadcast(x, 0)
    """, [], None),
    ("hvd002_set_iteration", """
        import horovod_tpu as hvd
        def f(tensors):
            for k in {"a", "b"}:
                hvd.allreduce(tensors[k], name="grad." + k)
    """, ["HVD002"], None),
    ("hvd002_set_call_fstring", """
        import horovod_tpu as hvd
        def f(d):
            for k in set(d):
                hvd.allreduce(d[k], name=f"g.{k}")
    """, ["HVD002"], None),
    ("hvd002_ordered_iteration", """
        import horovod_tpu as hvd
        def f(d):
            for k in sorted(d):
                hvd.allreduce(d[k], name=f"g.{k}")
            for k in ["a", "b"]:
                hvd.allreduce(d[k], name=f"g.{k}")
    """, [], None),
    ("hvd002_name_not_from_loop_var", """
        import horovod_tpu as hvd
        def f(d):
            for i, k in enumerate(sorted({"a", "b"})):
                hvd.allreduce(d[k], name="fixed")
    """, [], None),
    ("hvd003_unnamed_in_loop", """
        import horovod_tpu as hvd
        def f(ts):
            for t in ts:
                hvd.allreduce(t)
    """, ["HVD003"], None),
    ("hvd003_named_or_wrapper", """
        import horovod_tpu as hvd
        def f(ts, params):
            for i, t in enumerate(ts):
                hvd.allreduce(t, name=f"t{i}")
            for p in params:
                hvd.broadcast_parameters(p, root_rank=0)
            hvd.allreduce(ts[0])  # not in a loop
    """, [], None),
    ("hvd003_positional_name", """
        import horovod_tpu as hvd
        def f(ts):
            for i, t in enumerate(ts):
                hvd.allreduce(t, None, f"t{i}")
                hvd.broadcast(t, 0, f"b{i}")
                hvd.allgather(t, f"g{i}")
    """, [], None),
    ("hvd003_name_none_and_while", """
        import horovod_tpu as hvd
        def f(ts):
            while ts:
                hvd.allgather(ts.pop(), name=None)
    """, ["HVD003"], None),
    ("hvd003_suppressed", """
        import horovod_tpu as hvd
        def f(ts):
            for t in ts:
                hvd.allreduce(t)  # hvdlint: disable=HVD003 -- single-iteration loop in this config
    """, [], None),
    ("hvd004_process_set_differs", """
        import horovod_tpu as hvd
        def f(x, cond, ps_a, ps_b):
            if cond:
                hvd.allreduce(x, name="t", process_set=ps_a)
            else:
                hvd.allreduce(x, name="t", process_set=ps_b)
    """, ["HVD004"], None),
    ("hvd004_missing_in_one_branch", """
        import horovod_tpu as hvd
        def f(x, cond, ps_a):
            if cond:
                hvd.allreduce(x, name="t", process_set=ps_a)
            else:
                hvd.allreduce(x, name="t")
    """, ["HVD004"], None),
    ("hvd004_same_process_set", """
        import horovod_tpu as hvd
        def f(x, cond, ps_a):
            if cond:
                hvd.allreduce(x, name="t", process_set=ps_a)
            else:
                hvd.allreduce(x * 2, name="t", process_set=ps_a)
    """, [], None),
    ("hvd001_interprocedural_helper", """
        import horovod_tpu as hvd
        def sync(x):
            return hvd.allreduce(x, name="s")
        def f(x):
            if hvd.rank() == 0:
                sync(x)
    """, ["HVD001"], None),
    ("hvd001_interprocedural_select", """
        import horovod_tpu as hvd
        def sync(x):
            return hvd.allreduce(x, name="s")
        def f(x):
            if hvd.rank() == 0:
                sync(x)
    """, ["HVD001"], ["HVD001"]),
    ("hvd001_two_hops", """
        import horovod_tpu as hvd
        def inner(x):
            return hvd.barrier()
        def outer(x):
            return inner(x)
        def f(x):
            if hvd.rank() == 0:
                outer(x)
    """, ["HVD001"], None),
    ("hvd001_clean_helper", """
        import horovod_tpu as hvd
        def log(x):
            print(x)
        def f(x):
            if hvd.rank() == 0:
                log(x)
    """, [], None),
    ("hvd001_method", """
        import horovod_tpu as hvd
        class Trainer:
            def _sync(self, x):
                return hvd.allreduce(x, name="s")
            def run(self, x):
                if hvd.rank() == 0:
                    self._sync(x)
    """, ["HVD001"], None),
    ("hvd004_across_call_sites", """
        import horovod_tpu as hvd
        def sync(x, ps):
            return hvd.allreduce(x, name="t", process_set=ps)
        def f(x, cond, ps_a, ps_b):
            if cond:
                sync(x, ps_a)
            else:
                sync(x, ps_b)
    """, ["HVD004"], None),
    ("hvd004_across_call_sites_same_ps", """
        import horovod_tpu as hvd
        def sync(x, ps):
            return hvd.allreduce(x, name="t", process_set=ps)
        def f(x, cond, ps_a):
            if cond:
                sync(x, ps_a)
            else:
                sync(x * 2, ps_a)
    """, [], None),
    ("hvd005_async_def", """
        import horovod_tpu as hvd
        async def f(x):
            return hvd.allreduce(x, name=f"g{hvd.rank()}")
    """, ["HVD005"], None),
    ("hvd005_direct", """
        import horovod_tpu as hvd
        def f(x):
            return hvd.allreduce(x, name=f"g{hvd.rank()}")
    """, ["HVD005"], None),
    ("hvd005_through_local", """
        import horovod_tpu as hvd
        def f(x):
            r = hvd.rank()
            tag = "worker-%d" % r
            return hvd.allreduce(x, name=tag)
    """, ["HVD005"], None),
    ("hvd005_interprocedural_param", """
        import horovod_tpu as hvd
        def helper(x, tag):
            return hvd.allreduce(x, name=f"g.{tag}")
        def f(x):
            return helper(x, hvd.rank())
    """, ["HVD005"], None),
    ("hvd005_module_global_via_helper", """
        import horovod_tpu as hvd
        def myrank():
            return hvd.rank()
        R = myrank()
        def f(x):
            return hvd.allreduce(x, name="g%d" % R)
    """, ["HVD005"], None),
    ("hvd005_tainted_return", """
        import horovod_tpu as hvd
        def myrank():
            return hvd.rank()
        def f(x):
            r = myrank()
            return hvd.allreduce(x, name=f"g{r}")
    """, ["HVD005"], None),
    ("hvd005_clean_names", """
        import horovod_tpu as hvd
        def title(s):
            return s.upper()
        def f(x, step):
            r = hvd.rank()
            if r == 0:
                print("chief")
            hvd.broadcast(x, 0, "epoch")
            return hvd.allreduce(x, name=title("grad"))
    """, [], None),
    ("hvd005_suppressed", """
        import horovod_tpu as hvd
        def f(x):
            return hvd.allgather(x, f"g{hvd.rank()}")  # hvdlint: disable=HVD005 -- per-rank shards gathered under distinct names by design
    """, [], None),
    ("hvd101_outside_lock", """
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._d = {}  # guarded-by: _lock
            def bad(self):
                return self._d.get(1)
            def good(self):
                with self._lock:
                    return self._d.get(1)
    """, ["HVD101"], None),
    ("hvd101_init_exempt_cross_object_lock", """
        import threading
        class H:
            store = {}  # guarded-by: lock
            lock = threading.Lock()
            def touch(self):
                with self.lock:
                    self.store["k"] = 1
        class S:
            def __init__(self, h):
                self._h = h
            def put(self, k, v):
                with self._h.lock:
                    self._h.store[k] = v
    """, [], None),
    ("hvd101_module_global", """
        import threading
        _lk = threading.Lock()
        _state = {}  # guarded-by: _lk
        def bad():
            _state["x"] = 1
        def good():
            with _lk:
                _state["x"] = 1
    """, ["HVD101"], None),
    ("hvd101_suppressed", """
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._d = {}  # guarded-by: _lock
            def fast(self):
                return self._d.get(1)  # hvdlint: disable=HVD101 -- racy read is benign: add-only dict, atomic get under the GIL
    """, [], None),
    ("hvd101_same_named_function", """
        import threading
        class T:
            def __init__(self):
                self._lock = threading.Lock()
                self._table = {}  # guarded-by: _lock
        def _table():
            return T()
        def use():
            return _table()
    """, ["HVD101"], None),
    ("hvd102_thread_without_daemon", """
        import threading
        def f():
            t = threading.Thread(target=f)
            t.start()
    """, ["HVD102"], None),
    ("hvd102_daemon_given", """
        import threading
        def f():
            threading.Thread(target=f, daemon=True).start()
            threading.Thread(target=f, daemon=False).start()
    """, [], None),
    ("hvd102_other_thread_classes", """
        import foo
        def f():
            foo.Thread(target=f)
    """, [], None),
    ("hvd103_sleep_under_lock", """
        import threading, time
        lock = threading.Lock()
        def f():
            with lock:
                time.sleep(1)
    """, ["HVD103"], None),
    ("hvd103_outside_lock_or_non_lock_cm", """
        import threading, time
        lock = threading.Lock()
        def f(path):
            with lock:
                x = 1
            time.sleep(1)
            with open(path) as fh:
                time.sleep(0.1)  # not under a lock-ish context
    """, [], None),
    ("hvd103_subprocess_and_popen_wait", """
        import subprocess, threading
        lock = threading.Lock()
        def f(proc):
            with lock:
                subprocess.run(["hostname"])
                subprocess.check_output(["hostname"])
                proc.wait(timeout=5)
    """, ["HVD103", "HVD103", "HVD103"], None),
    ("hvd103_subprocess_outside_lock", """
        import subprocess
        def f(run):
            subprocess.run(["hostname"])
            run()  # bare `run` callables are not subprocess.run
    """, [], None),
    ("hvd103_queue_without_timeout", """
        import queue, threading
        lock = threading.Lock()
        q = queue.Queue()
        def f(item):
            with lock:
                q.get()
                q.put(item)
    """, ["HVD103", "HVD103"], None),
    ("hvd103_queue_nonblocking", """
        import queue, threading
        lock = threading.Lock()
        q = queue.Queue()
        def f(item):
            with lock:
                q.get(False)
                q.get(block=False)
                q.put(item, False)
                q.put(item, block=False)
    """, [], None),
    ("hvd103_queue_with_timeout_and_dicts", """
        import queue, threading
        lock = threading.Lock()
        q = queue.Queue()
        def f(item, d, kv):
            with lock:
                q.get(timeout=1.0)
                q.put(item, True, 2.0)
                d.get("key")          # dict.get: not a queue
                kv.put("scope", "k")  # KV client: not queue-named
            q.get()  # queue op, but not under a lock
    """, [], None),
    ("hvd103_wait_and_urlopen", """
        import threading
        from urllib.request import urlopen
        lock = threading.Lock()
        def f(ev):
            with lock:
                ev.wait(5)
                urlopen("http://x")
    """, ["HVD103", "HVD103"], None),
    ("select_ignores_other_rules", """
        import horovod_tpu as hvd
        def f(ts):
            for t in ts:
                hvd.allreduce(t)  # hvdlint: disable=HVD003
    """, [], ["HVD001"]),
]


@pytest.mark.parametrize("code,want,select",
                         [c[1:] for c in CORPUS],
                         ids=[c[0] for c in CORPUS])
def test_corpus_matches_jax(code, want, select):
    text = src(code)
    got = tdriver.lint_source(text, select=select)
    ref = jdriver.lint_source(text, select=select)
    assert triples(got) == triples(ref)
    assert [f.rule_id for f in got] == want


# Multi-file cases: {file name: source}, and (file, rule) the JAX test
# expects from lint_paths.
TREES = [
    ("module_alias_foreign_roots", {
        "helpers.py": """
            import horovod_tpu as hvd
            def broadcast(x):
                return hvd.broadcast(x, root_rank=0)
            def sync(x):
                return hvd.allreduce(x, name="s")
        """,
        "b.py": """
            import numpy as np
            import othermod
            import horovod_tpu as hvd
            def f(x):
                if hvd.rank() == 0:
                    np.broadcast(x, x)
                    othermod.sync(x)
        """}, []),
    ("module_alias_of_linted_module", {
        "helpers.py": """
            import horovod_tpu as hvd
            def sync(x):
                return hvd.allreduce(x, name="s")
        """,
        "c.py": """
            import helpers
            import horovod_tpu as hvd
            def f(x):
                if hvd.rank() == 0:
                    helpers.sync(x)
        """}, [("c.py", "HVD001")]),
    ("from_import_of_unlinted_module", {
        "a.py": """
            import horovod_tpu as hvd
            def sync(x):
                return hvd.allreduce(x, name="s")
        """,
        "b.py": """
            import horovod_tpu as hvd
            from mymath import sync
            def f(x):
                if hvd.rank() == 0:
                    sync(x)
        """}, []),
    ("from_import_of_linted_module", {
        "helpers.py": """
            import horovod_tpu as hvd
            def sync(x):
                return hvd.allreduce(x, name="s")
        """,
        "b.py": """
            import horovod_tpu as hvd
            from helpers import sync
            def f(x):
                if hvd.rank() == 0:
                    sync(x)
        """}, [("b.py", "HVD001")]),
    ("port_package_path_resolves", {
        "horovod_tpu_torch/util.py": """
            import horovod_tpu_torch as hvd
            def sync(x):
                return hvd.allreduce(x, name="s")
        """,
        "train.py": """
            import horovod_tpu_torch as hvd
            from horovod_tpu_torch.util import sync
            def f(x):
                if hvd.rank() == 0:
                    sync(x)
        """}, [("train.py", "HVD001")]),
    ("syntax_error_is_hvd999", {"bad.py": "def f(:\n"}, [("bad.py", "HVD999")]),
]


@pytest.mark.parametrize("files,want", [t[1:] for t in TREES],
                         ids=[t[0] for t in TREES])
def test_trees_match_jax(files, want, tmp_path):
    for name, code in files.items():
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src(code))
    got = tdriver.lint_paths([str(tmp_path)], env_rule=False)
    ref = jdriver.lint_paths([str(tmp_path)], env_rule=False)
    assert [(f.path, *t) for f, t in zip(got, triples(got))] == \
        [(f.path, *t) for f, t in zip(ref, triples(ref))]
    assert [(pathlib.Path(f.path).name, f.rule_id) for f in got] == \
        [(pathlib.Path(p).name, r) for p, r in want]


# ------------------------------------------------ the port's own names

@pytest.mark.parametrize("call,rule", [
    ("hvd.allreduce_(t)", "HVD003"),
    ("hvd.grouped_allreduce_async_([t])", "HVD003"),
    ("hvd.broadcast_(t, 0)", "HVD003"),
    ("hvd.sparse_allreduce_async(t)", "HVD003"),
    ("hvd.allreduce_(t, None, f'g{i}')", None),
    ("hvd.broadcast_(t, 0, name=f'b{i}')", None),
    ("hvd.grouped_allgather_async([t], f'g{i}')", None),
    ("hvd.sparse_allreduce(t)", None),
])
def test_port_collectives_in_a_loop(call, rule):
    """The port's in-place, grouped-async and sparse collectives are in
    its name sets (callgraph.COLLECTIVE_NAMES, NAME_ARG_POS), with their
    `name` positions; the JAX package's sets do not hold them."""
    text = src(f"""
        import horovod_tpu_torch as hvd
        def f(ts):
            for i, t in enumerate(ts):
                {call}
    """)
    assert [f.rule_id for f in tdriver.lint_source(text)] == \
        ([rule] if rule else [])
    assert jdriver.lint_source(text) == []


def test_port_collective_under_rank_guard():
    text = src("""
        import horovod_tpu_torch as hvd
        def f(x):
            if hvd.rank() == 0:
                hvd.broadcast_(x, 0, name="b")
    """)
    assert [f.rule_id for f in tdriver.lint_source(text)] == ["HVD001"]


# --------------------------------------------------------------- HVD-ENV

def _mk_repo(tmp_path, code, docs, readme=""):
    (tmp_path / "horovod_tpu_torch").mkdir()
    (tmp_path / "docs").mkdir()
    (tmp_path / "horovod_tpu_torch" / "m.py").write_text(code)
    (tmp_path / "docs" / "env_vars.md").write_text(docs)
    (tmp_path / "README.md").write_text(readme)
    return tmp_path


README = """# x
## PyTorch/CUDA port
| Knob | Default |
| --- | --- |
| `HOROVOD_PORT_ONLY` | 0 |
`HOROVOD_IN_PROSE` is not a table row.
## Other
| `HOROVOD_ELSEWHERE` | 1 |
"""


@pytest.mark.parametrize("name,documented", [
    ("HOROVOD_IN_CATALOG", True),
    ("HOROVOD_PORT_ONLY", True),
    ("HOROVOD_PORT_ONLY_MAX_ATTEMPTS", True),
    ("HOROVOD_KV_RETRY_DEADLINE", True),
    ("HOROVOD_IN_PROSE", False),
    ("HOROVOD_ELSEWHERE", False),
    ("HOROVOD_MYSTERY", False),
])
def test_env_rule_reads_catalog_and_readme_table(tmp_path, name,
                                                 documented):
    root = _mk_repo(tmp_path, f'import os\nv = os.environ.get("{name}")\n',
                    "`HOROVOD_IN_CATALOG` and the `HOROVOD_KV_RETRY` "
                    "prefix\n", README)
    findings = tenv.check_project(str(root))
    if documented:
        assert findings == []
    else:
        assert [f.rule_id for f in findings] == ["HVD-ENV"]
        assert name in findings[0].message
        assert findings[0].path == "horovod_tpu_torch/m.py"


def test_env_rule_outside_repo_is_noop(tmp_path):
    assert tenv.check_project(str(tmp_path)) == []


@pytest.mark.parametrize("why,want", [
    (" -- internal-only knob, not a supported surface", []),
    ("", ["HVD000"]),
])
def test_env_rule_suppression(tmp_path, why, want):
    root = _mk_repo(tmp_path, 'import os\nv = os.environ.get('
                    f'"HOROVOD_SECRET_KNOB")  # hvdlint: disable=HVD-ENV{why}\n',
                    "nothing documented\n")
    assert [f.rule_id for f in tenv.check_project(str(root))] == want


def test_env_rule_hvd000_not_duplicated(tmp_path):
    root = _mk_repo(tmp_path,
                    'X = "HOROVOD_SECRET_KNOB"  # hvdlint: disable=HVD-ENV\n',
                    "nothing documented\n")
    findings = lint_paths([str(root / "horovod_tpu_torch")], root=str(root))
    assert [f.rule_id for f in findings] == ["HVD000"]


def test_every_port_knob_is_documented():
    """Every HOROVOD_* literal of the port is in docs/env_vars.md or in
    README.md's table of the port's knobs."""
    assert tenv.check_project(str(REPO)) == []
    assert "HOROVOD_DYNAMIC_PROCESS_SETS" in tenv.readme_port_knobs(
        REPO / "README.md")


# ------------------------------------------------------- driver surface

BAD = """
    import horovod_tpu_torch as hvd
    def f(x):
        if hvd.rank() == 0:
            hvd.broadcast(x, root_rank=0)
"""


def test_driver_output_format_and_exit(tmp_path, capsys):
    bad = tmp_path / "train.py"
    bad.write_text(src(BAD))
    assert run_cli([str(bad), "--no-env"]) == 1
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if "HVD001" in ln][0]
    loc, rule, *_ = line.split(" ", 2)
    assert loc.endswith("train.py:5") and rule == "HVD001"


def test_driver_clean_exit_and_list_rules(tmp_path, capsys):
    ok = tmp_path / "ok.py"
    ok.write_text("x = 1\n")
    assert run_cli([str(ok), "--no-env"]) == 0
    assert "hvdlint: clean" in capsys.readouterr().out
    assert run_cli(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("HVD000", "HVD001", "HVD002", "HVD003", "HVD004",
                 "HVD005", "HVD101", "HVD102", "HVD103", "HVD-ENV"):
        assert rule in out
    # the analyzers of step programs, every family, as the JAX CLI
    listed = {ln.split()[0] for ln in out.splitlines() if ln.strip()}
    for fam in (2, 3, 4, 5):
        for i in range(1, 6):
            assert f"HVD{fam}0{i}" in listed
    assert run_jax_cli(["--list-rules"]) == 0
    jax_listed = {ln.split()[0] for ln in capsys.readouterr().out.splitlines()
                  if ln.strip()}
    assert {r for r in listed if r.startswith(("HVD2", "HVD3", "HVD4",
                                               "HVD5"))} == \
        {r for r in jax_listed if r.startswith(("HVD2", "HVD3", "HVD4",
                                                "HVD5"))}


FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "hlo")


def _fixture(name):
    return os.path.join(FIXDIR, name)


#: The JAX CLI's options over the dumps (and one recorded step), at the
#: JAX lane and budget; each case's exit code and findings must match.
PROGRAM_OPTIONS = [
    ["--hlo", _fixture("hvd201_giant_allreduce.mlir"),
     _fixture("hvd204_resnet_block.mlir"), _fixture("hvd203_donated.mlir")],
    ["--shard", _fixture("hvd301_replicated_emb.mlir"),
     _fixture("hvd303_overbudget.hlo"), _fixture("hvd305_psum_scatter.mlir")],
    ["--sched", _fixture("hvd401_pair_a.hlo"), _fixture("hvd401_pair_b.hlo"),
     "--format", "json"],
    ["--num", _fixture("hvd505_mesh4_sum.hlo"),
     _fixture("hvd505_mesh8_sum.hlo"), _fixture("hvd501_f32_accum.mlir")],
    ["--hlo-step", "lm"],
    ["--hlo", "--num", _fixture("hvd502_downcast_then_reduce.mlir"),
     _fixture("hvd205_upcast_accum.mlir")],
]


@pytest.mark.parametrize("opts", PROGRAM_OPTIONS,
                         ids=["hlo", "shard", "sched", "num", "hlo-step",
                              "hlo+num"])
def test_lowered_program_options_match_the_jax_cli(monkeypatch, capsys,
                                                   opts):
    from horovod_tpu_torch.analysis import hlo_rules
    monkeypatch.setattr(hlo_rules, "LANE", 128)
    monkeypatch.setenv("HOROVOD_HLO_LINT_HBM_BUDGET", "56M")
    results = {}
    extra = ["--device", "cpu"] if "--hlo-step" in opts else []
    for side, cli in (("jax", run_jax_cli), ("port", run_cli)):
        rc = cli(opts + (extra if side == "port" else []))
        cap = capsys.readouterr()
        if "--format" in opts:
            found = {(f["rule"], f["line"], os.path.basename(f["path"]))
                     for f in json.loads(cap.out)["findings"]}
        else:
            found = {(ln.split(" ")[1], ln.split(" ")[0].rsplit(":", 1)[1],
                      os.path.basename(ln.split(" ")[0].rsplit(":", 1)[0]))
                     for ln in cap.out.splitlines() if " HVD" in ln}
        tail = (cap.err.strip().splitlines() or cap.out.strip().splitlines()
                or [""])[-1]
        results[side] = (rc, found, tail.split(":")[0])
    assert results["port"] == results["jax"]
    if opts[0] != "--hlo-step":
        assert results["port"][0] == 1  # each set really fires


def test_select_and_ignore_cover_hvd000(tmp_path):
    f = tmp_path / "m.py"
    f.write_text(src("""
        import horovod_tpu_torch as hvd
        def g(ts):
            for t in ts:
                hvd.allreduce(t)  # hvdlint: disable=HVD003
    """))
    assert [x.rule_id for x in lint_paths([str(f)], env_rule=False)] \
        == ["HVD000"]
    assert lint_paths([str(f)], ignore=["HVD000"], env_rule=False) == []
    assert lint_paths([str(f)], select=["HVD001"], env_rule=False) == []


@pytest.mark.parametrize("bogus", ["no_such_dir", "nope.py"])
def test_nonexistent_path_fails_the_gate(tmp_path, bogus):
    findings = lint_paths([str(tmp_path / bogus)], env_rule=False)
    assert [f.rule_id for f in findings] == ["HVD999"]
    assert "does not exist" in findings[0].message


def test_driver_json_format_and_metric(tmp_path, capsys):
    from horovod_tpu_torch.observability import metrics as m
    bad = tmp_path / "train.py"
    bad.write_text(src(BAD))
    counter = m.registry().counter("hvdlint_findings_total",
                                   "hvdlint findings by rule",
                                   labelnames=("rule",))
    before = counter.labels(rule="HVD001").value
    assert run_cli([str(bad), "--no-env", "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["count"] == 1
    f = payload["findings"][0]
    assert f["rule"] == "HVD001" and f["line"] == 5
    assert f["path"].endswith("train.py")
    if m.registry().enabled:
        assert counter.labels(rule="HVD001").value == before + 1


def test_driver_baseline_filters_known_findings(tmp_path, capsys):
    bad = tmp_path / "train.py"
    bad.write_text(src(BAD))
    baseline = tmp_path / "baseline.json"
    assert run_cli([str(bad), "--no-env", "--format", "json"]) == 1
    baseline.write_text(capsys.readouterr().out)
    assert run_cli([str(bad), "--no-env", "--baseline", str(baseline)]) == 0
    assert "HVD001" not in capsys.readouterr().out
    bad.write_text(src("""
        import horovod_tpu_torch as hvd

        def g(ts):
            for t in ts:
                hvd.allreduce(t)
        def f(x):
            if hvd.rank() == 0:
                hvd.broadcast(x, root_rank=0)
    """))
    assert run_cli([str(bad), "--no-env", "--baseline", str(baseline)]) == 1
    out = capsys.readouterr().out
    assert "HVD003" in out and "HVD001" not in out


@pytest.mark.parametrize("payload", [None, "[1, 2]", '{"findings": "oops"}'])
def test_driver_baseline_unreadable_fails(tmp_path, payload):
    ok = tmp_path / "ok.py"
    ok.write_text("x = 1\n")
    bad = tmp_path / "bad.json"
    if payload is not None:
        bad.write_text(payload)
    assert run_cli([str(ok), "--no-env", "--baseline", str(bad)]) == 2


def test_checked_in_baseline_is_empty_and_loadable():
    baseline = tdriver.load_baseline(
        str(PORT / "analysis" / "hvdlint_baseline.json"))
    assert sum(baseline.values()) == 0


def test_repo_lints_clean():
    """The port's acceptance bar: hvdlint over horovod_tpu_torch/ with
    every rule enabled reports nothing."""
    findings = lint_paths([str(PORT)], root=str(REPO))
    assert findings == [], "\n".join(f.render() for f in findings)


def test_jax_lint_agrees_the_port_is_clean():
    """The JAX package's lint over the port finds nothing either (its
    HVD-ENV rule reads the JAX package's own tree)."""
    findings = jdriver.lint_paths([str(PORT)], root=str(REPO))
    assert findings == [], "\n".join(f.render() for f in findings)


def test_module_entry_point_with_the_baseline(tmp_path):
    """`python -m horovod_tpu_torch.analysis` is hvdlint: one clean file
    and one with a finding, against the checked-in baseline."""
    ok, bad = tmp_path / "ok.py", tmp_path / "bad.py"
    ok.write_text("x = 1\n")
    bad.write_text(src(BAD))
    base = str(PORT / "analysis" / "hvdlint_baseline.json")
    runs = [subprocess.run([sys.executable, "-m",
                            "horovod_tpu_torch.analysis", str(p),
                            "--no-env", "--baseline", base],
                           cwd=REPO, capture_output=True, text=True,
                           timeout=120) for p in (ok, bad)]
    assert runs[0].returncode == 0, runs[0].stderr
    assert "hvdlint: clean" in runs[0].stdout
    assert runs[1].returncode == 1 and "HVD001" in runs[1].stdout
