"""Chrome-trace timeline (counterpart of horovod_tpu/profiler/timeline.py).

Rank 0 writes about:tracing JSON from a writer thread fed by a bounded
queue: one complete event ("ph":"X") per span, named by its activity
(ALLREDUCE, BROADCAST, ..., COMPILE) with the tensor's name in its
args, instants ("ph":"i") for cycle marks and counter samples
("ph":"C"). `hvd.init()` starts it on rank 0 from HOROVOD_TIMELINE
(HOROVOD_TIMELINE_MARK_CYCLES marks the tuner's sample boundaries);
`hvd.start_timeline`/`stop_timeline` work on any rank.

On a card each span also opens an NVTX range named "<activity>:<name>",
so a CUDA profiler shows the same names beside the kernels. The ranges
are opened with `torch.cuda.nvtx.range_start`, which returns an id, and
closed by that id: a span may begin and end on different threads (the
gradient hooks run on autograd's device thread), where the per-thread
stack of `range_push`/`range_pop` would pair them wrongly.

Durability: the writer streams events to disk and flushes at least every
`_FLUSH_EVENTS` events or `_FLUSH_SECONDS` seconds, so a run killed with
SIGKILL still leaves a trace that Perfetto and about:tracing load (both
accept an array missing its closing bracket), and `recover_trace()`
repairs it into strict JSON, also when the file ends inside an event.

The file is opened by `start()`, on the caller's thread, so a path that
cannot be written raises there. The queue is bounded: when the writer
falls behind by `QUEUE_EVENTS` events, further events are dropped and
counted in `dropped`, so tracing never blocks the training thread.
This Python writer is the port's timeline. The JAX package's native C++
writer is built and bound in the port too (native/ `NativeTimeline`,
the same Chrome-trace events from a C++ writer thread), but it opens no
NVTX range and streams no file that `recover_trace` can repair, so the
timeline keeps this writer.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Dict, Optional, Tuple

import torch

# Chrome trace phase constants
_PH_COMPLETE = "X"
_PH_INSTANT = "i"
_PH_METADATA = "M"
_PH_COUNTER = "C"

_FLUSH_EVENTS = 32     # flush after this many buffered events...
_FLUSH_SECONDS = 0.5   # ...or this much time, whichever first
QUEUE_EVENTS = 1 << 16

_HEADER = '{"displayTimeUnit":"ms","traceEvents":[\n'
_FOOTER = "\n]}\n"


class Timeline:
    """Asynchronous Chrome-trace writer (the reference's TimelineWriter,
    timeline.h:28)."""

    def __init__(self, path: str, mark_cycles: bool = False) -> None:
        self.path = path
        self.mark_cycles = mark_cycles
        self._queue: "queue.Queue[Optional[dict]]" = queue.Queue(QUEUE_EVENTS)
        self._thread: Optional[threading.Thread] = None
        self._active = False
        self._t0 = time.monotonic_ns()
        self._lock = threading.Lock()
        # span_begin/span_end come from several threads (the training
        # thread, autograd's device thread): (name, activity) -> (start
        # µs, NVTX range id or None).
        self._pending_spans: Dict[Tuple[str, str],
                                  Tuple[float, Optional[int]]] = {}  # guarded-by: _lock
        self._nvtx = False
        self.dropped = 0  # guarded-by: _lock

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Open the file and start the writer thread; raises OSError when
        the path cannot be written."""
        with self._lock:
            if self._active:
                return
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            f = open(self.path, "w")
            self._nvtx = torch.cuda.is_available()
            self._active = True
            self._thread = threading.Thread(
                target=self._writer_loop, args=(f,), name="hvd-timeline",
                daemon=True)
            self._thread.start()
        self._emit({"ph": _PH_METADATA, "pid": 0, "name": "process_name",
                    "args": {"name": "horovod_tpu_torch"}})

    def stop(self) -> None:
        with self._lock:
            if not self._active:
                return
            self._active = False
        # The sentinel goes in outside the lock: _active is already
        # False, so nothing enqueues behind it.
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- recording ---------------------------------------------------------
    def _now_us(self) -> float:
        return (time.monotonic_ns() - self._t0) / 1e3

    def _emit(self, event: dict) -> None:
        if not self._active:
            return
        try:
            self._queue.put_nowait(event)
        except queue.Full:
            with self._lock:
                self.dropped += 1

    def record_instant(self, name: str, activity: str) -> None:
        self._emit({"ph": _PH_INSTANT, "pid": 0, "tid": 0, "s": "t",
                    "ts": self._now_us(), "name": f"{activity}:{name}"})

    def span_begin(self, name: str, activity: str) -> None:
        t = self._now_us()
        rid = torch.cuda.nvtx.range_start(f"{activity}:{name}") \
            if self._nvtx else None
        with self._lock:
            self._pending_spans[(name, activity)] = (t, rid)

    def span_end(self, name: str, activity: str) -> None:
        t1 = self._now_us()
        with self._lock:
            begun = self._pending_spans.pop((name, activity), None)
        if begun is None:
            return
        t0, rid = begun
        if rid is not None:
            torch.cuda.nvtx.range_end(rid)
        self._emit({"ph": _PH_COMPLETE, "pid": 0, "tid": 0, "ts": t0,
                    "dur": t1 - t0, "name": activity,
                    "args": {"tensor": name}})

    def counter(self, name: str, values: Dict[str, float]) -> None:
        """Emit a `"ph":"C"` counter sample: one track named `name`, one
        series per key of `values`."""
        self._emit({"ph": _PH_COUNTER, "pid": 0, "ts": self._now_us(),
                    "name": name,
                    "args": {k: float(v) for k, v in values.items()}})

    def mark_cycle(self) -> None:
        if self.mark_cycles:
            self.record_instant("cycle", "CYCLE_START")

    # -- writer thread (reference TimelineWriter::WriterLoop) --------------
    def _writer_loop(self, f) -> None:
        """Stream events to disk with bounded buffering (see the module
        docstring: a killed run keeps everything up to the last flush)."""
        f.write(_HEADER)
        first = True
        pending = 0
        last_flush = time.monotonic()
        try:
            while True:
                try:
                    ev = self._queue.get(timeout=_FLUSH_SECONDS / 2)
                except queue.Empty:
                    ev = False  # timeout tick: flush check only
                if ev is None:
                    break
                if ev is not False:
                    if not first:
                        f.write(",\n")
                    first = False
                    f.write(json.dumps(ev))
                    pending += 1
                now = time.monotonic()
                if pending and (pending >= _FLUSH_EVENTS
                                or now - last_flush >= _FLUSH_SECONDS):
                    f.flush()
                    pending = 0
                    last_flush = now
            f.write(_FOOTER)
        finally:
            f.close()


def recover_trace(path: str) -> list:
    """Load `path`'s traceEvents even if the writer never finalized it
    (crash, SIGKILL). The stream may end mid-event, since stdio flushes
    its buffer at byte boundaries: back off to the last complete event
    before appending the footer. Returns the event list; raises
    ValueError for a file that is no trace."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except ValueError:
        try:  # finalizer missing but the last event is complete
            data = json.loads(text.rstrip().rstrip(",") + _FOOTER)
        except ValueError:
            # Truncated mid-event: back off to the previous '}' (a
            # candidate event end) until the prefix parses. Braces inside
            # string values just cost extra iterations.
            data = None
            end = len(text)
            while data is None:
                cut = text.rfind("}", 0, end)
                if cut <= 0:
                    raise
                try:
                    data = json.loads(
                        text[:cut + 1].rstrip().rstrip(",") + _FOOTER)
                except ValueError:
                    end = cut
    events = data.get("traceEvents") if isinstance(data, dict) else data
    if not isinstance(events, list):
        raise ValueError(
            f"not a Chrome trace: parsed to {type(events).__name__}, "
            f"expected a traceEvents list")
    return events


def _main(argv=None) -> int:
    """CLI: salvage a trace from a killed run.

        python -m horovod_tpu_torch.profiler.timeline recover /tmp/tl.json
        python -m horovod_tpu_torch.profiler.timeline recover tl.json -o out.json

    Repairs the (possibly mid-event-truncated) stream with
    `recover_trace` and writes strict Chrome-trace JSON, to stdout by
    default or atomically to `-o/--output` (which may be the input path
    itself). Exits 1 when the file cannot be repaired.
    """
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.profiler.timeline",
        description="Timeline maintenance commands.")
    sub = p.add_subparsers(dest="cmd", required=True)
    rec = sub.add_parser(
        "recover",
        help="repair a truncated trace (SIGKILL'd/crashed run) into "
             "strict JSON Perfetto/about:tracing accepts")
    rec.add_argument("file", help="trace file written by HOROVOD_TIMELINE")
    rec.add_argument("-o", "--output", default="",
                     help="write the repaired trace here (atomic; "
                          "default: stdout)")
    args = p.parse_args(argv)
    try:
        events = recover_trace(args.file)
    except (OSError, ValueError) as e:
        print(f"timeline recover: cannot repair {args.file}: {e}",
              file=sys.stderr)
        return 1
    doc = {"displayTimeUnit": "ms", "traceEvents": events}
    if args.output:
        tmp = f"{args.output}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, args.output)
        print(f"timeline recover: {len(events)} event(s) -> "
              f"{args.output}", file=sys.stderr)
    else:
        json.dump(doc, sys.stdout)
        print()
    return 0


_torch_trace = None  # (torch.profiler.profile, log_dir) while one runs
_torch_trace_lock = threading.Lock()


def start_torch_trace(log_dir: str) -> None:
    """Start a torch.profiler trace of the host and, where there is a
    card, the device (the counterpart of start_jax_trace, and of the
    reference's NVTX ranges): `stop_torch_trace` writes it to
    `log_dir/trace.<pid>.json` in Chrome format."""
    global _torch_trace
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with _torch_trace_lock:
        if _torch_trace is not None:
            raise RuntimeError("a torch.profiler trace is already running")
        prof = profile(activities=acts)
        prof.start()
        _torch_trace = (prof, log_dir)


def stop_torch_trace() -> str:
    """Stop the trace `start_torch_trace` began; returns the file."""
    global _torch_trace
    with _torch_trace_lock:
        if _torch_trace is None:
            raise RuntimeError("no torch.profiler trace is running")
        prof, log_dir = _torch_trace
        _torch_trace = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace.{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


if __name__ == "__main__":
    import sys
    sys.exit(_main())
