"""The port's hvdrace (horovod_tpu_torch/analysis/race.py) held to the
contract of tests/test_race.py.

Seeded races in toy classes must give RaceReports naming the attribute,
the declared lock and the threads; clean classes, the creation scope,
suppressed sites and a lock handed over through a helper stay silent;
stale annotations, fail-fast, the report cap and class-level state are
covered. The port's annotated runtime classes are instrumented, stay
clean under a small threaded hammer, and a race seeded into one of them
is caught. The toy classes' annotations are read by both packages'
extractors and must bind alike. Every threaded test joins its threads
against a time limit of its own.
"""

import textwrap
import threading
import time

import pytest

from horovod_tpu.analysis import race as jrace
from horovod_tpu_torch.analysis import race

JOIN_S = 30.0  # each threaded test's limit

# Every fixture class gets a unique name: the stale-annotation stats are
# kept per (class name, attribute) for the life of the process.

BOX_SRC = textwrap.dedent("""
    import threading

    class RaceBox:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = {}  # guarded-by: _lock
        def good(self, k, v):
            with self._lock:
                self._items[k] = v
        def bad(self, k, v):
            self._items[k] = v
        def benign(self):
            return self._items.get(1)  # hvdlint: disable=HVD101 -- test fixture: add-only dict, atomic get under the GIL
""")


def _make(src, name, path):
    ns = {}
    exec(compile(src, path, "exec"), ns)
    cls = ns[name]
    anns = race.annotations_from_source(src, path)
    race.instrument_class(cls, anns[name])
    return cls


def _run_threads(targets, limit=JOIN_S):
    """Start a daemon thread per target, join them against `limit`
    seconds in all, and fail if one is still running."""
    threads = [threading.Thread(target=t, daemon=True) for t in targets]
    for t in threads:
        t.start()
    end = time.monotonic() + limit
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "threads outlived " \
        f"the {limit} s limit"


def _hammer(fn, n_threads=4, n_iter=100):
    _run_threads([lambda: [fn(i) for i in range(n_iter)]] * n_threads)


@pytest.mark.parametrize("name", ["RaceBox", "StaleSrc", "ClassStore"])
def test_annotations_bind_as_in_the_jax_package(name):
    """The port's extractor binds each annotation to the class, lock,
    attribute and scope the JAX package's does."""
    src = {"RaceBox": BOX_SRC, "StaleSrc": BOX_SRC.replace("RaceBox",
                                                           "StaleSrc"),
           "ClassStore": CLASS_SRC}[name]

    def rows(mod):
        return {c: [(a.cls, a.attr, a.lock, a.class_level, a.line)
                    for a in anns]
                for c, anns in mod.annotations_from_source(src).items()}
    assert rows(race) == rows(jrace) and name in rows(race)


def test_seeded_race_names_attr_lock_and_threads(tmp_path):
    path = str(tmp_path / "racebox.py")
    (tmp_path / "racebox.py").write_text(BOX_SRC)
    Box = _make(BOX_SRC, "RaceBox", path)
    with race.capture() as reports:
        b = Box()
        _hammer(lambda i: b.bad("k", i), n_threads=2)
    assert reports, "seeded race not detected"
    r = reports[0]
    assert (r.cls, r.attr, r.lock) == ("RaceBox", "_items", "_lock")
    rendered = r.render()
    assert "_items" in rendered and "_lock" in rendered
    threads_seen = {rep.thread for rep in reports} | \
        {rep.other_thread for rep in reports if rep.other_thread}
    assert len(threads_seen) >= 2
    assert r.site.endswith("racebox.py:12")
    assert any("racebox.py" in f for f in r.stack)


def test_clean_class_is_silent(tmp_path):
    Box = _make(BOX_SRC.replace("RaceBox", "CleanBox"), "CleanBox",
                str(tmp_path / "cleanbox.py"))
    with race.capture() as reports:
        b = Box()
        _hammer(lambda i: b.good("k", i))
    assert reports == []


def test_creation_scope_is_exempt(tmp_path):
    Box = _make(BOX_SRC.replace("RaceBox", "InitBox"), "InitBox",
                str(tmp_path / "initbox.py"))
    with race.capture() as reports:
        b = Box()
        for i in range(50):
            b.bad("k", i)  # one thread throughout: exclusive state
    assert reports == []


def test_suppressed_site_stays_silent(tmp_path):
    path = str(tmp_path / "benignbox.py")
    src = BOX_SRC.replace("RaceBox", "BenignBox")
    (tmp_path / "benignbox.py").write_text(src)
    Box = _make(src, "BenignBox", path)
    with race.capture() as reports:
        b = Box()
        _hammer(lambda i: b.benign(), n_threads=2, n_iter=50)
    assert reports == []


def test_stale_annotation_flagged(tmp_path):
    src = textwrap.dedent("""
        import threading

        class StaleBox:
            def __init__(self):
                self._lock = threading.Lock()
                self._data = []  # guarded-by: _lock
            def touch(self):
                self._data.append(1)
    """)
    Box = _make(src, "StaleBox", str(tmp_path / "stalebox.py"))
    with race.capture():
        b = Box()
        b.touch()
        _run_threads([b.touch])
    stale = race.stale_annotations()
    assert any("StaleBox._data" in s and "_lock" in s for s in stale)
    assert not any("CleanBox" in s for s in stale)


def test_fail_fast_raises_race_error(tmp_path):
    Box = _make(BOX_SRC.replace("RaceBox", "FailBox"), "FailBox",
                str(tmp_path / "failbox.py"))
    err = []
    with race.capture(fail=True):
        b = Box()
        b.bad("k", 0)  # owner thread: exclusive, fine

        def other():
            try:
                b.bad("k", 1)
            except race.RaceError as e:
                err.append(e)
        _run_threads([other])
    assert err and "FailBox._items" in str(err[0])


def test_report_cap(tmp_path):
    Box = _make(BOX_SRC.replace("RaceBox", "CapBox"), "CapBox",
                str(tmp_path / "capbox.py"))
    old = race._detector.max_reports
    race._detector.max_reports = 5
    try:
        with race.capture() as reports:
            b = Box()
            _hammer(lambda i: b.bad("k", i), n_threads=2, n_iter=200)
    finally:
        race._detector.max_reports = old
    assert 0 < len(reports) <= 5


@pytest.mark.parametrize("value,fail,cap", [("1", True, 7), ("0", False, 100),
                                            ("", False, 100)])
def test_env_knobs(monkeypatch, value, fail, cap):
    monkeypatch.setenv("HOROVOD_RACE_CHECK_FAIL", value)
    monkeypatch.setenv("HOROVOD_RACE_CHECK_MAX_REPORTS",
                       str(cap) if fail else "")
    d = race.Detector()
    d.configure_from_env()
    assert (d.fail_fast, d.max_reports) == (fail, cap)
    monkeypatch.setenv("HOROVOD_RACE_CHECK", value)
    assert race.env_enabled() is (value == "1")


CLASS_SRC = textwrap.dedent("""
    import threading

    class ClassStore:
        store = {}  # guarded-by: lock
        lock = threading.Lock()
        def put_good(self, k, v):
            with self.lock:
                self.store[k] = v
        def put_bad(self, k, v):
            self.store[k] = v
""")


def test_class_level_state_tracked_across_instances(tmp_path):
    Cls = _make(CLASS_SRC, "ClassStore", str(tmp_path / "classstore.py"))
    with race.capture() as reports:
        _hammer(lambda i: Cls().put_bad("k", i), n_threads=2, n_iter=50)
    assert reports and (reports[0].attr, reports[0].lock) == ("store", "lock")
    with race.capture() as reports2:
        _hammer(lambda i: Cls().put_good("k", i), n_threads=2, n_iter=50)
    assert reports2 == []


def test_lock_handoff_through_helper_is_understood(tmp_path):
    src = textwrap.dedent("""
        import threading

        class HandoffBox:
            def __init__(self):
                self._lock = threading.Lock()
                self._d = {}  # guarded-by: _lock
            def _unlocked_write(self, k, v):
                self._d[k] = v  # hvdlint: disable=HVD101 -- callers hold _lock
            def write(self, k, v):
                with self._lock:
                    self._unlocked_write(k, v)
    """)
    Box = _make(src, "HandoffBox", str(tmp_path / "handoffbox.py"))
    with race.capture() as reports:
        b = Box()
        _hammer(lambda i: b.write("k", i))
    assert reports == []
    assert not any("HandoffBox" in s for s in race.stale_annotations())


@pytest.fixture
def enabled():
    """race.enable() over the port's runtime modules, restoring the
    previous mode after the test."""
    was_active = race.active()
    race.enable()
    yield
    if not was_active:
        race.disable()


def test_runtime_classes_instrumented_and_clean(enabled, tmp_path):
    """Every annotated runtime class of the port is instrumented, and a
    threaded hammer of the timeline, the metrics registry, perfscope and
    the flight recorder stays race-clean."""
    names = {c.__name__ for c in race._detector._instrumented}
    assert {"Timeline", "_Family", "MetricsRegistry", "ElasticDriver",
            "_KVHandler", "FingerprintVerifier", "ProcessSetTable",
            "PerfScope", "FlightRecorder", "Tracer", "Watcher",
            "ReplicaNode", "ContinuousBatcher", "ReplicaPool",
            "InferenceEngine", "AsyncCheckpointer"} <= names
    from horovod_tpu_torch.observability.flight import FlightRecorder
    from horovod_tpu_torch.observability.metrics import MetricsRegistry
    from horovod_tpu_torch.profiler.perfscope import PerfScope
    from horovod_tpu_torch.profiler.timeline import Timeline
    with race.capture() as reports:
        tl = Timeline(str(tmp_path / "tl.json"))
        reg = MetricsRegistry(enabled=True, label_max=8)
        fam = reg.counter("race_test_total", "x", labelnames=("k",))
        scope = PerfScope(window=16)
        fr = FlightRecorder(capacity=64)

        def work(tid):
            def run():
                for i in range(100):
                    tl.span_begin(f"t{tid}-{i}", "ALLREDUCE")
                    tl.span_end(f"t{tid}-{i}", "ALLREDUCE")
                    fam.labels(k=str(i % 4)).inc()
                    scope.attribute("comms", 1e-6)
                    scope.step_boundary() if i % 2 else scope.step_entry()
                    fr.record("test", f"{tid}:{i}")
                scope.summary()
            return run
        _run_threads([work(t) for t in range(4)])
    assert reports == [], "\n".join(r.render() for r in reports)
    stale = [s for s in race.stale_annotations()
             if s.split(".")[0] in ("Timeline", "_Family", "MetricsRegistry",
                                    "PerfScope", "FlightRecorder")]
    assert stale == []


def test_seeded_runtime_race_is_caught(enabled, tmp_path):
    """Writing the timeline's pending spans without its lock (a deleted
    acquisition in the runtime) is caught on the real class."""
    from horovod_tpu_torch.profiler.timeline import Timeline
    with race.capture() as reports:
        tl = Timeline(str(tmp_path / "tl2.json"))

        def racy(tid):
            def run():
                for i in range(100):
                    tl._pending_spans[(f"t{tid}-{i}", "A")] = (1.0, None)
            return run
        _run_threads([racy(t) for t in range(2)])
    assert reports
    assert (reports[0].cls, reports[0].attr, reports[0].lock) == \
        ("Timeline", "_pending_spans", "_lock")


def test_drain_and_metric():
    """drain() returns and clears the global log; capture() blocks never
    reach it. A report outside capture() counts in the metrics."""
    assert race.drain() == []
    from horovod_tpu_torch.observability import metrics as m
    d = race._detector
    rep = race.RaceReport(cls="X", attr="a", lock="_l", access="read",
                          site="x.py:1", thread="t", stack=[], lockset=[])
    was = d.fail_fast
    d.fail_fast = False
    try:
        d._emit(rep)
    finally:
        d.fail_fast = was
    assert race.drain() == [rep] and race.drain() == []
    if m.registry().enabled:
        fam = m.registry().counter("hvdrace_reports_total",
                                   "guarded-by violations observed by "
                                   "hvdrace", labelnames=("site",))
        assert fam.labels(site="x.py:1").value >= 1
