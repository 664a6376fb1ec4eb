"""Deadline guard for the processes a test launches (the one-deadline
rule of tests/torch_world_worker.py, for processes started as commands).

    python torch_guard.py END -m module [args...]
    python torch_guard.py END script.py [args...]

END is a time.time() value shared by every process of one test's
process group. The guard arms `faulthandler.dump_traceback_later` to
fire 5 s before END with `exit=True`, so a process still running then
prints every thread's stack to its stderr and exits non-zero, and then
runs the module or script as `__main__`. Imports nothing but the
standard library."""

import faulthandler
import runpy
import sys
import time

_DUMP_MARGIN_S = 5.0


def main() -> None:
    end = float(sys.argv[1])
    faulthandler.dump_traceback_later(
        max(1.0, end - _DUMP_MARGIN_S - time.time()), exit=True)
    if sys.argv[2] == "-m":
        sys.argv = [sys.argv[3]] + sys.argv[4:]
        runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
    else:
        sys.argv = sys.argv[2:]
        runpy.run_path(sys.argv[0], run_name="__main__")


if __name__ == "__main__":
    main()
