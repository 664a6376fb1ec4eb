"""Spawned test worlds with one deadline, for tests/test_torch_*.py.

`start_world(target, rank_args, tmp_path, deadline)` starts one `spawn`
process per entry of `rank_args`; rank r runs `target(*rank_args[r])`
through `enter`, which first sends its stderr to `tmp_path/rank<r>.err`
and arms `faulthandler.dump_traceback_later` a few seconds before the
world's deadline with `exit=True`. Outside elastic mode a gloo
collective waits 30 minutes for a peer that never comes, so a world
whose sends and receives do not pair up would otherwise hold its test,
and its xdist worker, until the suite's clock runs out; with the guard
the hung rank prints every thread's stack and exits non-zero.

`World.join()` waits for all ranks against the one shared deadline
(not a bound per process, which a hung world of 4 would pay 4 times),
returns as soon as a rank fails, kills whatever still runs, and raises
AssertionError with each rank's exit code and the end of its stderr.
Imports nothing but the standard library, so the spawned ranks import
only what their target does.
"""

import faulthandler
import multiprocessing as mp
import multiprocessing.connection
import os
import sys
import time

_DUMP_MARGIN_S = 5.0  # a hung rank dumps this long before the deadline


def enter(target, args, err_path: str, end: float) -> None:
    """Rank entry: stderr to `err_path`, the stack-dump guard armed for
    `end` (time.time()) − 5 s, then target(*args)."""
    err = open(err_path, "w", buffering=1)
    os.dup2(err.fileno(), 2)
    sys.stderr = err
    faulthandler.dump_traceback_later(
        max(1.0, end - _DUMP_MARGIN_S - time.time()), exit=True, file=err)
    target(*args)
    faulthandler.cancel_dump_traceback_later()


class World:
    def __init__(self, procs, errs, end):
        self.procs, self.errs, self.end = procs, errs, end

    def join(self) -> None:
        pending = list(self.procs)
        while pending and time.time() < self.end:
            mp.connection.wait([p.sentinel for p in pending],
                               timeout=max(0.0, self.end - time.time()))
            pending = [p for p in pending if p.exitcode is None]
            if any(p.exitcode not in (None, 0) for p in self.procs):
                break
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        codes = [p.exitcode for p in self.procs]
        if codes != [0] * len(codes):
            lines = []
            for r, (code, path) in enumerate(zip(codes, self.errs)):
                text = open(path).read() if os.path.exists(path) else ""
                lines.append(f"--- rank {r}: exit code {code}\n"
                             f"{text[-3000:]}")
            raise AssertionError("spawned world failed (exit codes "
                                 f"{codes}):\n" + "\n".join(lines))


def start_world(target, rank_args, tmp_path, deadline: float = 90.0
                ) -> World:
    """Start the ranks; see the module docstring."""
    ctx = mp.get_context("spawn")
    end = time.time() + deadline
    errs = [str(tmp_path / f"rank{r}.err") for r in range(len(rank_args))]
    procs = [ctx.Process(target=enter, args=(target, tuple(a), errs[r], end))
             for r, a in enumerate(rank_args)]
    for p in procs:
        p.start()
    return World(procs, errs, end)


def spawn_world(target, rank_args, tmp_path, deadline: float = 90.0) -> None:
    """start_world, then join."""
    start_world(target, rank_args, tmp_path, deadline).join()
