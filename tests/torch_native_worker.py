"""Spawned processes of tests/test_torch_native.py. Each loads one
package's native/__init__.py on its own (it imports only the standard
library), so that a child starts in a fraction of a second instead of
importing torch or JAX."""

import importlib.util
import os
import pathlib
import signal
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(package: str):
    """`package`/native/__init__.py as a module of its own."""
    path = ROOT / package / "native" / "__init__.py"
    spec = importlib.util.spec_from_file_location(f"_{package}_native",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_server(out) -> None:
    """The JAX package's native KV server; sends its port, then waits to
    be killed (its stop() is never called: it can deadlock)."""
    srv = load("horovod_tpu").NativeKVServer()
    out.send(srv.port)
    signal.pause()


def stop_rounds(rounds: int, out) -> None:
    """`rounds` port servers, each stopped with two idle clients
    connected and a third closing at that moment; sends the slowest
    stop() in seconds, or None if one never returned within 5 s."""
    n = load("horovod_tpu_torch")
    worst = 0.0
    for _ in range(rounds):
        srv = n.NativeKVServer()
        idle = [n.NativeKVClient("127.0.0.1", srv.port) for _ in range(2)]
        for c in idle:
            assert c.ping()
        closing = n.NativeKVClient("127.0.0.1", srv.port)
        closing.put("k", b"v")
        done = threading.Event()
        t0 = time.monotonic()
        closer = threading.Thread(target=closing.close)
        closer.start()
        stopper = threading.Thread(target=lambda: (srv.stop(), done.set()))
        stopper.start()
        if not done.wait(5.0):
            out.send(None)
            os._exit(3)
        worst = max(worst, time.monotonic() - t0)
        closer.join()
        for c in idle:
            c.close()
    out.send(worst)
