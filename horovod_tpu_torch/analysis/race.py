"""hvdrace: runtime lockset race detector enforcing ``# guarded-by:``
(counterpart of horovod_tpu/analysis/race.py).

HVD101 checks the ``# guarded-by: <lock>`` convention *lexically* — an
annotation whose lock is never actually held at runtime still passes
lint, and a lock handed through a helper is invisible to it. This
module closes the loop at runtime, following the Eraser lockset
algorithm (Savage et al., SOSP '97) specialized by the annotations:
instead of inferring candidate locksets, the annotation *declares* the
required lock, so the detector only has to answer "was the declared
lock held by this thread when the guarded attribute was touched?".

Enabled by ``HOROVOD_RACE_CHECK=1`` (read at ``horovod_tpu_torch``
import time), the detector:

* parses the runtime modules' ``# guarded-by:`` annotations with the
  same extractor HVD101 uses (``concurrency_rules._collect_annotations``)
  and binds each to its enclosing class;
* instruments those classes: ``__getattribute__``/``__setattr__`` hooks
  observe every touch of a guarded attribute, and ``threading.Lock`` /
  ``RLock`` objects stored under a declared lock name are wrapped in
  :class:`TrackedLock` so each thread's held-lock set is known;
* applies Eraser's ownership state machine per (object, attribute):
  the first accessing thread owns the state silently (``__init__`` and
  single-threaded use never report); the moment a second thread
  touches it, every access without the declared lock produces a
  :class:`RaceReport` naming the attribute, the declared lock, the
  current thread+stack and the previous conflicting access;
* honors the lexical suppression grammar at runtime: an access line
  carrying ``hvdlint: disable=HVD101 -- rationale`` (the
  double-checked-locking reads in observability/metrics.py) never
  reports;
* flags *stale* annotations — attributes touched from a second thread
  (provably past creation) while their declared lock was never once
  held — via :func:`stale_annotations`;
* feeds ``hvdrace_reports_total{site}`` into the metrics registry.

``HOROVOD_RACE_CHECK_FAIL=1`` promotes each report to an immediate
:class:`RaceError`; ``HOROVOD_RACE_CHECK_MAX_REPORTS`` caps retained
reports (per site AND total). :func:`capture` scopes detection in a
test; :func:`drain` returns and clears what a run reported, so a run
under the detector can gate on zero reports.

Overhead exists only when enabled: without ``HOROVOD_RACE_CHECK=1`` no
class is ever instrumented and the runtime is byte-for-byte untouched.
"""

from __future__ import annotations

import dataclasses
import linecache
import os
import sys
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

HOROVOD_RACE_CHECK = "HOROVOD_RACE_CHECK"
HOROVOD_RACE_CHECK_FAIL = "HOROVOD_RACE_CHECK_FAIL"
HOROVOD_RACE_CHECK_MAX_REPORTS = "HOROVOD_RACE_CHECK_MAX_REPORTS"

#: Runtime modules scanned for ``# guarded-by:`` annotations when the
#: detector is enabled: the port's counterparts of the JAX package's
#: list, plus the serving engine (its CUDA graphs and their pool are
#: guarded by the engine's lock). perfboard, schedule and numerics join
#: when their modules are ported.
DEFAULT_MODULES: Tuple[str, ...] = (
    "horovod_tpu_torch.profiler.timeline",
    "horovod_tpu_torch.profiler.perfscope",
    "horovod_tpu_torch.observability.metrics",
    "horovod_tpu_torch.observability.flight",
    "horovod_tpu_torch.observability.tracing",
    "horovod_tpu_torch.observability.watch",
    "horovod_tpu_torch.elastic.driver",
    "horovod_tpu_torch.runner.rendezvous",
    "horovod_tpu_torch.runner.kv_ha",
    "horovod_tpu_torch.analysis.verifier",
    "horovod_tpu_torch.core.topology",
    "horovod_tpu_torch.core.process_sets",
    "horovod_tpu_torch.serve.batching",
    "horovod_tpu_torch.serve.pool",
    "horovod_tpu_torch.serve.engine",
    "horovod_tpu_torch.ckpt.async_ckpt",
    "horovod_tpu_torch.analysis.schedule",
    "horovod_tpu_torch.analysis.numerics",
)

_LOCK_TYPES = (type(threading.Lock()), type(threading.RLock()))

#: Frames kept per access record — enough to name the caller chain
#: without paying a full traceback per touch.
_STACK_DEPTH = 6


class RaceError(RuntimeError):
    """Raised at the access site under HOROVOD_RACE_CHECK_FAIL=1."""


@dataclasses.dataclass
class RaceReport:
    """One guarded-by violation observed at runtime."""

    cls: str
    attr: str
    lock: str
    access: str                 # "read" | "write"
    site: str                   # "path:lineno" of the touching line
    thread: str
    stack: List[str]            # innermost-last "path:line in func"
    lockset: List[str]          # tracked locks held instead
    other_thread: Optional[str] = None
    other_site: Optional[str] = None
    other_stack: Optional[List[str]] = None

    def render(self) -> str:
        head = (f"hvdrace: '{self.cls}.{self.attr}' is guarded-by "
                f"'{self.lock}' but {self.access} at {self.site} on "
                f"thread '{self.thread}' without it "
                f"(held locks: {self.lockset or 'none'})")
        lines = [head, "  this access:"]
        lines += [f"    {f}" for f in self.stack]
        if self.other_site is not None:
            lines.append(f"  previous access: thread "
                         f"'{self.other_thread}' at {self.other_site}")
            lines += [f"    {f}" for f in (self.other_stack or [])]
        return "\n".join(lines)


_token_counter = [0]
_token_mu = threading.Lock()


class _Held(threading.local):
    """Per-thread multiset of held TrackedLocks (id -> count), plus a
    NEVER-REUSED thread token: ``threading.get_ident()`` is recycled
    once a thread dies, which would let a later thread masquerade as a
    dead owner in the Eraser state machine."""

    def __init__(self) -> None:
        self.locks: Dict[int, int] = {}
        self.names: Dict[int, str] = {}
        with _token_mu:
            _token_counter[0] += 1
            self.token = _token_counter[0]


_held = _Held()

_obj_token_counter = [0]


def _obj_token(obj) -> int:
    """A never-reused identity for `obj` (``id()`` is recycled after
    collection, which would let a fresh object inherit a dead object's
    Eraser state). Stamped on the object on first use; objects that
    refuse attributes (__slots__) fall back to id()."""
    tok = getattr(obj, "_hvdrace_token", None)
    if tok is not None:
        return tok
    with _token_mu:
        tok = getattr(obj, "_hvdrace_token", None)
        if tok is None:
            _obj_token_counter[0] += 1
            tok = _obj_token_counter[0]
            try:
                object.__setattr__(obj, "_hvdrace_token", tok)
            except Exception:
                tok = id(obj)
    return tok


class TrackedLock:
    """Transparent Lock/RLock proxy that maintains the per-thread
    held-lock set. Wraps the ORIGINAL lock object, so references taken
    before instrumentation still synchronize with wrapped ones."""

    def __init__(self, inner, name: str) -> None:
        self._inner = inner
        self.name = name
        self.ever_acquired = False

    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self.ever_acquired = True
            _held.locks[id(self)] = _held.locks.get(id(self), 0) + 1
            _held.names[id(self)] = self.name
        return got

    def release(self) -> None:
        n = _held.locks.get(id(self), 0)
        if n <= 1:
            _held.locks.pop(id(self), None)
            _held.names.pop(id(self), None)
        else:
            _held.locks[id(self)] = n - 1
        self._inner.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def held_by_current_thread(self) -> bool:
        return _held.locks.get(id(self), 0) > 0

    def __getattr__(self, item):
        # Uncommon surface (e.g. Condition internals) falls through to
        # the real lock; such paths bypass held-set tracking.
        return getattr(self._inner, item)


def _current_lockset() -> List[str]:
    return sorted(set(_held.names.values()))


class _AttrState:
    """Eraser ownership state for one (object/class, attribute)."""

    __slots__ = ("owner_tid", "shared", "last")

    def __init__(self) -> None:
        self.owner_tid: Optional[int] = None
        self.shared = False
        # (thread name, site, stack) of the most recent access
        self.last: Optional[Tuple[str, str, List[str]]] = None


class _AnnStat:
    """Aggregated runtime evidence for one annotation (stale check)."""

    __slots__ = ("lock", "accesses", "post_accesses", "held_accesses",
                 "shared_seen")

    def __init__(self, lock: str) -> None:
        self.lock = lock
        self.accesses = 0
        self.post_accesses = 0   # accesses from a non-owner thread
        self.held_accesses = 0
        self.shared_seen = False


class _ClassAnnotation:
    __slots__ = ("cls", "attr", "lock", "class_level", "line")

    def __init__(self, cls: str, attr: str, lock: str,
                 class_level: bool, line: int) -> None:
        self.cls = cls
        self.attr = attr
        self.lock = lock
        self.class_level = class_level
        self.line = line


class Detector:
    """Process-wide hvdrace state (singleton: module-level `_detector`)."""

    def __init__(self) -> None:
        self.enabled = False
        self.fail_fast = False
        self.max_reports = 100
        self.reports: List[RaceReport] = []
        self._sink: Optional[List[RaceReport]] = None  # capture() target
        self._mu = threading.Lock()  # internal — deliberately untracked
        self._state: Dict[Tuple[int, str], _AttrState] = {}
        self._ann_stats: Dict[Tuple[str, str], _AnnStat] = {}
        self._site_counts: Dict[str, int] = {}
        self._suppressed_sites: Dict[str, bool] = {}
        self._instrumented: Set[type] = set()

    # ------------------------------------------------------------- config
    def configure_from_env(self) -> None:
        self.fail_fast = os.environ.get(
            HOROVOD_RACE_CHECK_FAIL, "").strip().lower() in (
                "1", "true", "yes", "on")
        try:
            self.max_reports = int(os.environ.get(
                HOROVOD_RACE_CHECK_MAX_REPORTS, "") or 100)
        except ValueError:
            self.max_reports = 100

    # ------------------------------------------------------------ reports
    def _emit(self, report: RaceReport) -> None:
        with self._mu:
            n = self._site_counts.get(report.site, 0) + 1
            self._site_counts[report.site] = n
            target = self._sink if self._sink is not None else self.reports
            if n <= self.max_reports and len(target) < self.max_reports:
                target.append(report)
        try:
            from horovod_tpu_torch.observability import metrics as m
            m.registry().counter(
                "hvdrace_reports_total",
                "guarded-by violations observed by hvdrace",
                labelnames=("site",)).labels(site=report.site).inc()
        except Exception:
            pass
        if self.fail_fast:
            raise RaceError(report.render())

    # ------------------------------------------------------------- checks
    def check_access(self, obj, cls: type, ann: _ClassAnnotation,
                     access: str) -> None:
        if not self.enabled:
            return
        held = self._lock_held(obj, ann.lock)
        key_obj = cls if ann.class_level else obj
        key = (_obj_token(key_obj), ann.attr)
        thread = threading.current_thread()
        site, stack = _caller_site()
        report: Optional[RaceReport] = None
        with self._mu:
            st = self._state.get(key)
            if st is None:
                st = self._state[key] = _AttrState()
            stat = self._ann_stats.get((ann.cls, ann.attr))
            if stat is None:
                stat = self._ann_stats[(ann.cls, ann.attr)] = \
                    _AnnStat(ann.lock)
            stat.accesses += 1
            if held:
                stat.held_accesses += 1
            tid = _held.token  # ident-reuse-proof thread identity
            if st.owner_tid is None:
                st.owner_tid = tid
            elif tid != st.owner_tid:
                st.shared = True
                # Provably beyond the creation scope: another thread.
                # (Owner-thread touches are NOT counted — __init__ may
                # legitimately touch its own state repeatedly unlocked,
                # and that must not read as a stale annotation.)
                stat.post_accesses += 1
            if st.shared:
                stat.shared_seen = True
            if st.shared and held is False \
                    and not self._site_suppressed(site):
                prev = st.last
                report = RaceReport(
                    cls=ann.cls, attr=ann.attr, lock=ann.lock,
                    access=access, site=site, thread=thread.name,
                    stack=stack, lockset=_current_lockset(),
                    other_thread=prev[0] if prev else None,
                    other_site=prev[1] if prev else None,
                    other_stack=prev[2] if prev else None)
            st.last = (thread.name, site, stack)
        if report is not None:
            self._emit(report)

    def _lock_held(self, obj, lock_name: str) -> Optional[bool]:
        """True/False when determinable; None (treated as held) when
        the lock object exposes no ownership probe."""
        try:
            lk = object.__getattribute__(obj, lock_name)
        except AttributeError:
            return False
        if isinstance(lk, TrackedLock):
            return lk.held_by_current_thread()
        probe = getattr(lk, "_is_owned", None)
        if probe is not None:  # raw RLock acquired before wrapping
            try:
                return bool(probe())
            except Exception:
                return None
        if isinstance(lk, _LOCK_TYPES):
            return None  # raw Lock: ownership unknowable — never report
        return False if lk is None else None

    def _site_suppressed(self, site: str) -> bool:
        """Honor `hvdlint: disable=HVD101/HVDRACE -- why` on the
        touching source line, so lexically-audited benign races (the
        metrics fast path) stay silent at runtime too."""
        cached = self._suppressed_sites.get(site)
        if cached is not None:
            return cached
        ok = False
        path, _, lineno = site.rpartition(":")
        try:
            from horovod_tpu_torch.analysis.driver import (parse_suppression,
                                                     suppression_covers)
            entry = parse_suppression(linecache.getline(path, int(lineno)))
            ok = (suppression_covers(entry, "HVD101")
                  or suppression_covers(entry, "HVDRACE"))
        except Exception:
            ok = False
        self._suppressed_sites[site] = ok
        return ok

    # ------------------------------------------------------ lock wrapping
    def wrap_lock_in_place(self, obj, cls: type, lock_name: str) -> None:
        """Swap a raw lock stored at `lock_name` (instance dict or class
        attribute) for a TrackedLock wrapping the SAME inner lock, so
        instances created before enable() still get tracked."""
        try:
            lk = object.__getattribute__(obj, lock_name)
        except AttributeError:
            return
        if not isinstance(lk, _LOCK_TYPES):
            return
        with self._mu:
            try:  # re-check under the mutex: another thread may have won
                lk = object.__getattribute__(obj, lock_name)
            except AttributeError:
                return
            if not isinstance(lk, _LOCK_TYPES):
                return
            wrapped = TrackedLock(lk, lock_name)
            try:
                inst = object.__getattribute__(obj, "__dict__")
            except AttributeError:
                inst = None
            if inst is not None and lock_name in inst:
                object.__setattr__(obj, lock_name, wrapped)
                return
            for klass in type(obj).__mro__:
                if lock_name in klass.__dict__:
                    setattr(klass, lock_name, wrapped)
                    return

    # ------------------------------------------------------------- stale
    def stale_annotations(self) -> List[str]:
        out = []
        with self._mu:
            for (cls, attr), s in sorted(self._ann_stats.items()):
                if s.post_accesses > 0 and s.held_accesses == 0:
                    out.append(
                        f"{cls}.{attr}: annotated guarded-by "
                        f"'{s.lock}' but the lock was never held "
                        f"across {s.accesses} observed access(es) — "
                        f"stale annotation or missing locking")
        return out


_detector = Detector()


def _caller_site() -> Tuple[str, List[str]]:
    """(file:line of the touching code, short caller stack) — the first
    frame outside this module going up."""
    frame = sys._getframe(1)
    here = __file__
    while frame is not None and frame.f_code.co_filename == here:
        frame = frame.f_back
    site = "<unknown>:0"
    stack: List[str] = []
    depth = 0
    while frame is not None and depth < _STACK_DEPTH:
        code = frame.f_code
        entry = f"{code.co_filename}:{frame.f_lineno} in {code.co_name}"
        if depth == 0:
            site = f"{code.co_filename}:{frame.f_lineno}"
        stack.append(entry)
        frame = frame.f_back
        depth += 1
    return site, stack


# -------------------------------------------------------- instrumentation

def annotations_from_source(text: str, path: str = "<string>"
                            ) -> Dict[str, List[_ClassAnnotation]]:
    """class name -> guarded-by annotations, using the HVD101 extractor."""
    from horovod_tpu_torch.analysis.concurrency_rules import _collect_annotations
    from horovod_tpu_torch.analysis.driver import SourceFile
    by_cls: Dict[str, List[_ClassAnnotation]] = {}
    for a in _collect_annotations(SourceFile(path, text)):
        if a.cls is None:
            continue  # module-level globals: no class to instrument
        by_cls.setdefault(a.cls, []).append(_ClassAnnotation(
            a.cls, a.attr, a.lock, a.class_level, a.line))
    return by_cls


def instrument_class(cls: type,
                     anns: Sequence[_ClassAnnotation]) -> None:
    """Install guarded-attribute hooks on `cls` (idempotent)."""
    d = _detector
    if cls in d._instrumented or not anns:
        return
    d._instrumented.add(cls)
    guarded: Dict[str, _ClassAnnotation] = {a.attr: a for a in anns}
    locknames: Set[str] = {a.lock for a in anns}
    watched = set(guarded) | locknames
    orig_get = cls.__getattribute__
    orig_set = cls.__setattr__

    def __getattribute__(self, name):
        if name in watched:
            ann = guarded.get(name)
            if ann is not None:
                d.check_access(self, cls, ann, "read")
            elif d.enabled:
                d.wrap_lock_in_place(self, cls, name)
        return orig_get(self, name)

    def __setattr__(self, name, value):
        if name in locknames and isinstance(value, _LOCK_TYPES):
            value = TrackedLock(value, name)
        elif name in guarded:
            d.check_access(self, cls, guarded[name], "write")
        orig_set(self, name, value)

    cls.__getattribute__ = __getattribute__  # type: ignore[assignment]
    cls.__setattr__ = __setattr__            # type: ignore[assignment]
    # Class-level declared locks (e.g. the rendezvous KV handler) can be
    # wrapped right now — no instance required.
    for lock_name in locknames:
        raw = cls.__dict__.get(lock_name)
        if isinstance(raw, _LOCK_TYPES):
            setattr(cls, lock_name, TrackedLock(raw, lock_name))


def instrument_module(module) -> List[str]:
    """Instrument every annotated class defined in `module`; returns the
    instrumented class names."""
    path = getattr(module, "__file__", None)
    if not path or not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    done: List[str] = []
    for cls_name, anns in annotations_from_source(text, path).items():
        cls = getattr(module, cls_name, None)
        if isinstance(cls, type):
            instrument_class(cls, anns)
            done.append(cls_name)
    return done


def enable(modules: Sequence[str] = DEFAULT_MODULES) -> None:
    """Turn the detector on and instrument the runtime (idempotent).

    Called from ``horovod_tpu_torch/__init__`` when
    ``HOROVOD_RACE_CHECK=1``;
    callable directly from tests/tools. Instruments each module's
    annotated classes, so instances created afterwards get wrapped
    locks; pre-existing instances are handled lazily (raw locks are
    swapped in place on first guarded access, and raw RLocks are
    ownership-probed even unwrapped)."""
    import importlib
    d = _detector
    d.configure_from_env()
    for name in modules:
        try:
            instrument_module(importlib.import_module(name))
        except Exception as e:  # never let the debug tool break import
            print(f"hvdrace: could not instrument {name}: {e}",
                  file=sys.stderr)
    d.enabled = True


def disable() -> None:
    _detector.enabled = False


def active() -> bool:
    return _detector.enabled


def reports() -> List[RaceReport]:
    with _detector._mu:
        return list(_detector.reports)


def drain() -> List[RaceReport]:
    """Return-and-clear the accumulated reports (a run's gate)."""
    with _detector._mu:
        out = list(_detector.reports)
        _detector.reports.clear()
        _detector._site_counts.clear()
        return out


def stale_annotations() -> List[str]:
    return _detector.stale_annotations()


@contextmanager
def capture(fail: bool = False) -> Iterator[List[RaceReport]]:
    """Scoped detection for tests: enables the detector, routes reports
    into the yielded list (the global report log is untouched), and
    restores the previous mode on exit."""
    d = _detector
    sink: List[RaceReport] = []
    with d._mu:
        prev = (d.enabled, d.fail_fast, d._sink)
        d._sink = sink
    d.enabled = True
    d.fail_fast = fail
    try:
        yield sink
    finally:
        with d._mu:
            d.enabled, d.fail_fast, d._sink = prev


def env_enabled() -> bool:
    return os.environ.get(HOROVOD_RACE_CHECK, "").strip().lower() in (
        "1", "true", "yes", "on")


def maybe_enable_from_env() -> bool:
    """The import-time hook: enable iff HOROVOD_RACE_CHECK is set."""
    if env_enabled():
        enable()
        return True
    return False
