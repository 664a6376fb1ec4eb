"""Leftover-thread check for tests/test_torch_*.py: `leftover(before)`
lists the live threads not in `before` that the port started. The JAX
package's own stall watcher, which a reference run in a test starts,
ends on its own within its period and is not counted."""

import threading
import time


def snapshot() -> set:
    return {t.ident for t in threading.enumerate()}


def leftover(before: set, settle: float = 0.6) -> list:
    deadline = time.monotonic() + settle
    while True:
        left = [t for t in threading.enumerate()
                if t.ident not in before and t.is_alive()
                and not getattr(getattr(t, "_target", None), "__module__",
                                "").startswith("horovod_tpu.")]
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.05)
