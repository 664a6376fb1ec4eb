"""Per-kernel device time of a training step (counterpart of
horovod_tpu/profiler/device_profile.py): where the device's
milliseconds go, read from a real trace of the card.

The JAX package parses the "XLA Ops" line of the XPlane the TPU runtime
writes; here torch.profiler's CUDA activity gives one event per kernel
(and per memcpy/memset) the device ran, and `aggregate` sums them into
per-kernel and per-category tables.

    from horovod_tpu_torch.profiler.device_profile import profile_step
    prof = profile_step(lambda: train_step(...))   # runs it reps times
    print(prof.as_markdown())

`classify` maps CUDA kernel names onto the JAX package's categories;
the port's own kernels (names with `hvd`, from csrc/) are the "hvd
kernel" category. Category totals are indicative (a name is a
heuristic); the per-kernel table is the ground truth. Without a card
there is no device event, and `profile_step` raises.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# (regex on the lower-cased kernel name, category); the first match
# wins. NCCL's kernels name their reduction ("AllReduce_Sum"), so they
# come before `reduce`; cuDNN's implicit-GEMM convolutions name a GEMM,
# so convolutions come before matmuls; PyTorch's copies run in its
# elementwise kernels (direct_copy_kernel), so copies come before them.
_DEFAULT_BUCKETS: List[Tuple[str, str]] = [
    (r"nccl", "collective"),
    (r"hvd", "hvd kernel"),
    (r"max_pool.*backward|max_pool_backward", "maxpool backward"),
    (r"max_pool|avg_pool", "pool forward"),
    (r"cudnn|conv(?!ert)|fprop|dgrad|wgrad|implicit", "convolution/custom-call"),
    (r"nvjet|cutlass|gemm|gemv", "matmul"),
    (r"reduce", "reduce fusion (stats/grads)"),
    (r"copy|memcpy|memset", "layout/copy"),
    (r"elementwise|vectorized|unrolled", "fused elementwise/compute"),
]


def classify(name: str,
             buckets: Optional[List[Tuple[str, str]]] = None) -> str:
    low = name.lower()
    for pat, cat in (buckets or _DEFAULT_BUCKETS):
        if re.search(pat, low):
            return cat
    return "other"


@dataclasses.dataclass
class DeviceProfile:
    per_op: Dict[str, float]        # kernel name -> ms per step
    per_category: Dict[str, float]  # category -> ms per step
    total_ms: float
    reps: int

    def top_ops(self, n: int = 15) -> List[Tuple[str, float]]:
        return sorted(self.per_op.items(), key=lambda kv: -kv[1])[:n]

    def as_markdown(self, top: int = 15) -> str:
        lines = [f"device ops total: {self.total_ms:.2f} ms/step "
                 f"(mean of {self.reps})", "",
                 "| category | ms/step | share |", "|---|---|---|"]
        for cat, d in sorted(self.per_category.items(),
                             key=lambda kv: -kv[1]):
            share = d / self.total_ms if self.total_ms else 0.0
            lines.append(f"| {cat} | {d:.2f} | {share:.1%} |")
        lines += ["", "| op | ms/step |", "|---|---|"]
        for name, d in self.top_ops(top):
            lines.append(f"| `{name[:70]}` | {d:.2f} |")
        return "\n".join(lines)


def kernel_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start µs, end µs) of every device event in a finished
    torch.profiler profile, without the device spans of user
    annotations (e.g. "Optimizer.step#SGD.step"), which cover kernels
    already listed."""
    import torch
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def aggregate(events: Iterable[Tuple[str, float, float]], reps: int = 1,
              buckets=None) -> DeviceProfile:
    """Sum (name, start µs, end µs) device events into ms per step."""
    per_op: Dict[str, float] = {}
    per_cat: Dict[str, float] = {}
    total = 0.0
    for name, start, end in events:
        d = (end - start) / 1e3 / reps  # µs -> ms per step
        per_op[name] = per_op.get(name, 0.0) + d
        cat = classify(name, buckets)
        per_cat[cat] = per_cat.get(cat, 0.0) + d
        total += d
    return DeviceProfile(per_op=per_op, per_category=per_cat,
                         total_ms=total, reps=reps)


def _activities():
    import torch
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CUDA] if torch.cuda.is_available() \
        else [ProfilerActivity.CPU]


def _sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


# ---------------------------------------------------------------- capture
#
# On-demand capture: one process-wide lock serializes every trace started
# here (torch.profiler refuses a second live trace). Try-acquire: a
# trigger that loses the race is skipped and reported False, never
# queued, since a queued capture would record a later window.

_capture_lock = threading.Lock()
# At interpreter exit a running capture is told to cut its window short
# and waited for (bounded), so its trace is written before the process
# goes.
_exit_drain = threading.Event()
_active_runner: Optional[threading.Thread] = None
_drain_installed = False


def capture_active() -> bool:
    """True while an on-demand device trace is running."""
    return _capture_lock.locked()


def _drain_capture_at_exit() -> None:
    t = _active_runner
    if t is not None and t.is_alive():
        _exit_drain.set()
        t.join(timeout=60.0)


def start_on_demand_capture(out_dir: str,
                            steps: int = 8,
                            step_count_fn: Optional[Callable[[], int]] = None,
                            timeout_s: float = 30.0,
                            poll_s: float = 0.05) -> bool:
    """Start a torch.profiler trace of the card that stops itself after
    `step_count_fn` advances by `steps` (or after `timeout_s`, whichever
    comes first) and writes `out_dir/devprof.<pid>.<n>.json` in Chrome
    format. Returns True when the capture was scheduled, False when
    another capture holds the lock. The whole capture runs on a daemon
    thread: the caller never waits for the profiler to start."""
    global _active_runner, _drain_installed
    if not _capture_lock.acquire(blocking=False):
        return False

    def _runner() -> None:
        from torch.profiler import profile
        try:
            os.makedirs(out_dir, exist_ok=True)
            prof = profile(activities=_activities())
            prof.start()
            # Once the trace is live it must be stopped whatever the
            # caller's step counter does.
            try:
                start = step_count_fn() if step_count_fn is not None else 0
                deadline = time.monotonic() + max(timeout_s, poll_s)
                while time.monotonic() < deadline \
                        and not _exit_drain.is_set():
                    if step_count_fn is not None \
                            and step_count_fn() - start >= steps:
                        break
                    time.sleep(poll_s)
            finally:
                prof.stop()
                n = len(os.listdir(out_dir))
                prof.export_chrome_trace(os.path.join(
                    out_dir, f"devprof.{os.getpid()}.{n}.json"))
        finally:
            _capture_lock.release()

    if not _drain_installed:
        _drain_installed = True
        atexit.register(_drain_capture_at_exit)
    t = threading.Thread(target=_runner, name="hvd-devprof-capture",
                         daemon=True)
    _active_runner = t  # single writer: the capture lock is held
    t.start()
    return True


def profile_step(run_once: Callable[[], object], reps: int = 3,
                 warmup: int = 1, buckets=None) -> DeviceProfile:
    """Trace `reps` calls of `run_once` on the card and aggregate the
    device's kernels into ms per step. Warm up (first-use builds,
    cuDNN's algorithm search) before calling: `warmup` calls here only
    drain post-build slowness. Raises RuntimeError when the trace holds
    no device event (no card)."""
    from torch.profiler import profile
    for _ in range(warmup):
        run_once()
    _sync()
    with profile(activities=_activities()) as prof:
        for _ in range(reps):
            run_once()
        _sync()
    out = aggregate(kernel_events(prof), reps=reps, buckets=buckets)
    if not out.per_op:
        raise RuntimeError(
            "trace contains no device events: without a CUDA card "
            "torch.profiler records none; run on the GPU")
    return out
