"""Worker process execution with streamed, rank-prefixed output
(counterpart of horovod_tpu/runner/safe_exec.py, after horovod's
safe_shell_exec): each worker runs in its own session, so a terminate
reaches its whole process group, and its output lines are prefixed
`[<rank>]<stdout>: `.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional


class WorkerProcess:
    def __init__(self, index: int, cmd: List[str], env: Dict[str, str],
                 prefix_output: bool = True,
                 stdout=None,
                 logfile: Optional[str] = None,
                 timestamp: bool = False):
        self.index = index
        self.cmd = cmd
        self._stdout = stdout or sys.stdout
        self._prefix = prefix_output
        self._timestamp = timestamp
        self._logfile = open(logfile, "w") if logfile else None
        self.proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1,
            start_new_session=True)  # own process group for tree-kill
        self._pump = threading.Thread(target=self._pump_output, daemon=True)
        self._pump.start()

    def _pump_output(self):
        assert self.proc.stdout is not None
        for line in self.proc.stdout:
            if self._logfile is not None:
                self._logfile.write(line)  # raw per-rank log
                self._logfile.flush()
            if self._prefix:
                stamp = ""
                if self._timestamp:
                    stamp = time.strftime("%a %b %d %H:%M:%S %Y") + " "
                self._stdout.write(f"{stamp}[{self.index}]<stdout>: {line}")
            else:
                self._stdout.write(line)
            self._stdout.flush()
        if self._logfile is not None:
            self._logfile.close()

    def wait(self, timeout: Optional[float] = None) -> int:
        rc = self.proc.wait(timeout=timeout)
        self._pump.join(timeout=5)
        return rc

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def terminate(self, grace: float = 5.0) -> None:
        """SIGTERM the process group, SIGKILL after grace (reference:
        safe_shell_exec terminate tree)."""
        if self.proc.poll() is not None:
            return
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                return
            time.sleep(0.1)
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def wait_all(workers: List[WorkerProcess],
             timeout: Optional[float] = None) -> List[int]:
    """Wait for all workers; on any non-zero exit, terminate the rest
    (one failure ends the job). With `timeout`, terminate every worker
    still running after that many seconds and raise TimeoutError."""
    codes: List[Optional[int]] = [None] * len(workers)
    deadline = None if timeout is None else time.monotonic() + timeout
    while any(c is None for c in codes):
        for i, w in enumerate(workers):
            if codes[i] is None:
                rc = w.poll()
                if rc is not None:
                    codes[i] = rc
                    if rc != 0:
                        for j, other in enumerate(workers):
                            if j != i and codes[j] is None:
                                other.terminate()
        if deadline is not None and time.monotonic() > deadline:
            running = [w.index for w, c in zip(workers, codes) if c is None]
            for w in workers:
                w.terminate()
            raise TimeoutError(f"worker(s) {running} still running after "
                               f"{timeout} s; terminated")
        time.sleep(0.1)
    return [c for c in codes if c is not None]
