"""The port's Chrome-trace timeline (horovod_tpu_torch/profiler/
timeline.py) against the JAX package's Python writer.

Both writers are driven through the same calls; their event lists must
agree exactly in `ph`, `name`, `cat` and `args` (timestamps, durations,
pid, tid and the process name differ by nature). Both `recover_trace`s
must give the same events for the same truncated files. Then the port's
own cases, after tests/test_timeline.py: incremental flush survives a
SIGKILL of a child process, counter tracks, concurrent spans from many
threads, the recover CLI's exit codes, and a path that cannot be opened
raising at start().
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from horovod_tpu.profiler import timeline as jtl
from horovod_tpu_torch.profiler import timeline as ttl

KEYS = ("ph", "name", "cat", "args")


def _load(path):
    return json.load(open(path))["traceEvents"]


def _script(tl):
    """One fixed sequence of calls: nested and overlapping spans, an
    unmatched end, instants, counters and cycle marks."""
    tl.span_begin("grad/b0", "ALLREDUCE")
    tl.span_begin("w", "BROADCAST")
    tl.span_end("grad/b0", "ALLREDUCE")
    tl.record_instant("x", "MARK")
    tl.span_end("w", "BROADCAST")
    tl.span_end("never-begun", "ALLGATHER")     # dropped by both
    tl.counter("horovod_collective_bytes_total", {"allreduce": 128})
    tl.counter("two", {"a": 1.5, "b": 2})
    tl.mark_cycle()
    for i in range(40):                         # more than one flush
        tl.span_begin(f"t{i}", "ALLTOALL")
        tl.span_end(f"t{i}", "ALLTOALL")
    tl.mark_cycle()


def _write_both(tmp_path, mark_cycles=True):
    paths = {}
    for tag, tl in (("jax", jtl.Timeline(str(tmp_path / "jax.json"),
                                         mark_cycles=mark_cycles,
                                         use_native=False)),
                    ("torch", ttl.Timeline(str(tmp_path / "torch.json"),
                                           mark_cycles=mark_cycles))):
        tl.start()
        _script(tl)
        tl.stop()
        paths[tag] = str(tmp_path / f"{tag}.json")
    return paths


def _strip(events):
    out = []
    for e in events:
        e = {k: e[k] for k in KEYS if k in e}
        if e.get("name") == "process_name":
            e["args"] = None
        out.append(e)
    return out


@pytest.mark.parametrize("mark_cycles", [True, False])
def test_events_equal_jax_apart_from_times_and_ids(tmp_path, mark_cycles):
    paths = _write_both(tmp_path, mark_cycles)
    j, t = _load(paths["jax"]), _load(paths["torch"])
    assert _strip(t) == _strip(j)
    assert len(t) == 1 + 2 + 1 + 2 + 40 + (2 if mark_cycles else 0)
    spans = [e for e in t if e["ph"] == "X"]
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in spans)
    assert t[0]["args"] == {"name": "horovod_tpu_torch"}


@pytest.mark.parametrize("cut", ["footer", "mid_array", "mid_event",
                                 "mid_string"])
def test_recover_trace_equal_to_jax(tmp_path, cut):
    """Both packages' recover_trace give the same events for the same
    truncated file: cut after the last event (no footer), after a
    comma between events, inside the last event, inside a string that
    holds a brace."""
    tl = ttl.Timeline(str(tmp_path / "full.json"))
    tl.start()
    for i in range(6):
        tl.span_begin(f"tensor}}{i}", "ALLREDUCE")  # '}' inside a string
        tl.span_end(f"tensor}}{i}", "ALLREDUCE")
    tl.stop()
    full = open(tmp_path / "full.json").read()
    last = full.rindex('{"ph"')
    at = {"footer": full.rindex("}\n]}"),
          "mid_array": last - 1,
          "mid_event": last + 25,
          "mid_string": full.rindex("tensor}") + 7}[cut]
    path = tmp_path / "cut.json"
    path.write_text(full[:at + (1 if cut == "footer" else 0)])
    got = ttl.recover_trace(str(path))
    assert got == jtl.recover_trace(str(path))
    spans = [e for e in got if e["ph"] == "X"]
    assert len(spans) == (6 if cut == "footer" else 5)
    assert all("tensor}" in e["args"]["tensor"] for e in spans)


def test_incremental_flush_survives_kill(tmp_path):
    """A child process writes five spans, waits past the flush interval
    and is killed with SIGKILL before stop(): the file it leaves
    recovers to all five."""
    path = str(tmp_path / "tl.json")
    code = (
        "import sys, time\n"
        "from horovod_tpu_torch.profiler.timeline import Timeline, "
        "_FLUSH_SECONDS\n"
        f"tl = Timeline({path!r}); tl.start()\n"
        "for i in range(5):\n"
        "    tl.span_begin(f's{i}', 'ALLREDUCE')\n"
        "    tl.span_end(f's{i}', 'ALLREDUCE')\n"
        "time.sleep(4 * _FLUSH_SECONDS)\n"
        "print('flushed', flush=True)\n"
        "time.sleep(60)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root,
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "flushed"
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert proc.returncode == -9
    spans = [e for e in ttl.recover_trace(path) if e["ph"] == "X"]
    assert [e["args"]["tensor"] for e in spans] == [f"s{i}" for i in range(5)]
    with pytest.raises(ValueError):
        json.load(open(path))  # the writer never finished the file


def test_counter_events(tmp_path):
    path = str(tmp_path / "tl.json")
    tl = ttl.Timeline(path)
    tl.start()
    tl.counter("horovod_collective_bytes_total", {"allreduce": 128.0})
    tl.counter("horovod_collective_bytes_total", {"allreduce": 256.0})
    tl.stop()
    counters = [e for e in _load(path) if e.get("ph") == "C"]
    assert len(counters) == 2
    assert counters[-1]["args"]["allreduce"] == 256.0


def test_span_state_thread_safe(tmp_path):
    """Concurrent span_begin/span_end from many threads, with a short
    switch interval, lose and corrupt no span."""
    path = str(tmp_path / "tl.json")
    tl = ttl.Timeline(path)
    tl.start()
    n_threads, n_iter = 8, 100

    def work(tid):
        for i in range(n_iter):
            name = f"t{tid}-{i}"
            tl.span_begin(name, "ALLREDUCE")
            tl.span_end(name, "ALLREDUCE")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    with tl._lock:
        assert tl._pending_spans == {}
    tl.stop()
    spans = [e for e in _load(path) if e.get("ph") == "X"]
    assert len(spans) == n_threads * n_iter
    assert len({e["args"]["tensor"] for e in spans}) == n_threads * n_iter


def test_span_ends_on_another_thread(tmp_path):
    """A span begun on one thread and ended on another (a gradient hook
    on autograd's device thread) is one span."""
    path = str(tmp_path / "tl.json")
    tl = ttl.Timeline(path)
    tl.start()
    tl.span_begin("b3", "ALLREDUCE")
    t = threading.Thread(target=tl.span_end, args=("b3", "ALLREDUCE"))
    t.start()
    t.join(timeout=10)
    tl.stop()
    spans = [e for e in _load(path) if e.get("ph") == "X"]
    assert [e["args"]["tensor"] for e in spans] == ["b3"]


@pytest.mark.parametrize("content", [
    "", "garbage not json", "null", "123", '{"foo": 1}',
    '{"traceEvents": 7}'])
def test_recover_cli_exits_nonzero_like_jax(tmp_path, capsys, content):
    path = tmp_path / "bad.json"
    path.write_text(content)
    assert ttl._main(["recover", str(path)]) == 1
    err = capsys.readouterr().err
    assert "cannot repair" in err and str(path) in err
    assert jtl._main(["recover", str(path)]) == 1


def test_recover_cli_repairs_in_place(tmp_path):
    tl = ttl.Timeline(str(tmp_path / "tl.json"))
    tl.start()
    tl.span_begin("a", "ALLREDUCE")
    tl.span_end("a", "ALLREDUCE")
    tl.stop()
    path = tmp_path / "tl.json"
    path.write_text(path.read_text()[:-4])          # drop the footer
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.profiler.timeline",
         "recover", str(path), "-o", str(path)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    events = json.load(open(path))["traceEvents"]
    assert [e["args"]["tensor"] for e in events if e["ph"] == "X"] == ["a"]


def test_recover_trace_takes_a_bare_event_array(tmp_path):
    path = tmp_path / "a.json"
    path.write_text('[{"ph": "i", "ts": 1}]')
    assert ttl.recover_trace(str(path)) == [{"ph": "i", "ts": 1}]


def test_start_raises_when_the_file_cannot_be_opened(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    tl = ttl.Timeline(str(blocker / "sub" / "tl.json"))
    with pytest.raises(OSError):
        tl.start()
    tl.span_begin("a", "ALLREDUCE")   # an unstarted timeline records nothing
    tl.span_end("a", "ALLREDUCE")
    tl.stop()


def test_full_queue_drops_and_counts(tmp_path, monkeypatch):
    """The bounded queue never blocks the caller: past its size events
    are dropped and counted."""
    tl = ttl.Timeline(str(tmp_path / "tl.json"))
    monkeypatch.setattr(tl, "_queue", __import__("queue").Queue(2))
    tl._active = True                 # no writer thread: nothing drains
    t0 = time.perf_counter()
    for _ in range(5):
        tl.record_instant("x", "MARK")
    assert time.perf_counter() - t0 < 1.0
    assert tl.dropped == 3


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    """start_torch_trace/stop_torch_trace (the counterpart of the JAX
    package's jax.profiler bridge): host activity here, the card's too
    where there is one."""
    import torch
    ttl.start_torch_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        ttl.start_torch_trace(str(tmp_path))
    torch.ones(64).sum()
    path = ttl.stop_torch_trace()
    assert os.path.dirname(path) == str(tmp_path)
    events = json.load(open(path))["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    with pytest.raises(RuntimeError, match="no torch.profiler trace"):
        ttl.stop_torch_trace()
