"""ctypes bindings for the native control-plane library (counterpart of
horovod_tpu/native/__init__.py): the TCP KV/coordination server and its
client, the Chrome-trace writer thread and the stall inspector, from the
port's own copies of the C++ sources in `native/src/`.

The library is built with `g++` at first use into
`horovod_tpu_torch/_build/`, named by a hash of its sources and flags (as
kernels/__init__.py names the CUDA libraries), so an edited source is
never served by a stale binary. Where no toolchain is present the build
fails, a warning is logged once, `available()` is False, and the callers
fall back to their pure-Python paths (the HTTP KV, the Python timeline
writer, common/resilience.py PyStallInspector). `active_path()` says
which is live.

The port's `KVServer::Stop` joins its connection threads only after it
has released `conn_mu_`, which a connection thread takes on its way out:
the JAX package's copy joins them under that lock and can deadlock with a
client still connected (ROADMAP §C).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "src")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
SOURCES = ("kv_store.cc", "timeline.cc", "stall.cc")
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_build_failed = False
build_error = ""

# KV protocol ops (must match kv_store.cc).
OP_PUT, OP_GET, OP_ADD, OP_AND, OP_OR, OP_GETC, OP_DEL, OP_PING = range(1, 9)


def _target() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for fn in SOURCES:
        with open(os.path.join(SRC_DIR, fn), "rb") as f:
            h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libhvd_native-{h.hexdigest()[:12]}.so")


def _build(out: str) -> bool:
    global build_error
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", tmp,
                        *(os.path.join(SRC_DIR, fn) for fn in SOURCES)],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        return True
    except (OSError, subprocess.SubprocessError) as e:
        build_error = getattr(e, "stderr", None) or str(e)
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load the native library, building it if needed; None on failure
    (logged once)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        out = _target()
        try:
            if not os.path.exists(out) and not _build(out):
                raise OSError(build_error)
            lib = ctypes.CDLL(out)
        except OSError as e:
            _build_failed = True
            from horovod_tpu_torch.common.hvd_logging import get_logger
            get_logger().warning(
                "native control-plane library unavailable (%s); using the "
                "pure-Python fallbacks", str(e).strip()[:500])
            return None
        lib.hvdn_kv_server_start.restype = ctypes.c_void_p
        lib.hvdn_kv_server_start.argtypes = [ctypes.c_int]
        lib.hvdn_kv_server_port.restype = ctypes.c_int
        lib.hvdn_kv_server_port.argtypes = [ctypes.c_void_p]
        lib.hvdn_kv_server_stop.argtypes = [ctypes.c_void_p]
        lib.hvdn_kv_client_new.restype = ctypes.c_void_p
        lib.hvdn_kv_client_new.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.hvdn_kv_client_free.argtypes = [ctypes.c_void_p]
        lib.hvdn_kv_request.restype = ctypes.c_longlong
        lib.hvdn_kv_request.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_ulonglong,
            ctypes.c_char_p, ctypes.c_ulonglong]
        lib.hvdn_timeline_open.restype = ctypes.c_void_p
        lib.hvdn_timeline_open.argtypes = [ctypes.c_char_p]
        lib.hvdn_timeline_emit.restype = ctypes.c_int
        lib.hvdn_timeline_emit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int]
        lib.hvdn_timeline_close.argtypes = [ctypes.c_void_p]
        lib.hvdn_timeline_emit_counter.restype = ctypes.c_int
        lib.hvdn_timeline_emit_counter.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_double, ctypes.c_longlong]
        lib.hvdn_stall_new.restype = ctypes.c_void_p
        lib.hvdn_stall_new.argtypes = [ctypes.c_double, ctypes.c_double]
        lib.hvdn_stall_free.argtypes = [ctypes.c_void_p]
        lib.hvdn_stall_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.hvdn_stall_done.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.hvdn_stall_check.restype = ctypes.c_longlong
        lib.hvdn_stall_check.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def active_path() -> str:
    """"native" when the C++ library is loaded, else "python"."""
    return "native" if available() else "python"


class NativeKVServer:
    """TCP KV/coordination server (reference analog: the launcher's HTTP KV
    store served natively — gloo/http_store.cc counterpart)."""

    def __init__(self, port: int = 0):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.hvdn_kv_server_start(port)
        if not self._h:
            raise RuntimeError(f"failed to start native KV server on {port}")
        self.port = lib.hvdn_kv_server_port(self._h)

    def stop(self) -> None:
        if self._h:
            self._lib.hvdn_kv_server_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class NativeKVClient:
    def __init__(self, host: str, port: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.hvdn_kv_client_new(host.encode(), port)
        if not self._h:
            raise RuntimeError(f"failed to connect to {host}:{port}")

    def _req(self, op: int, key: str, val: bytes = b"",
             outcap: int = 0) -> tuple:
        out = ctypes.create_string_buffer(outcap) if outcap else None
        st = self._lib.hvdn_kv_request(
            self._h, op, key.encode(), val, len(val), out, outcap)
        return st, (out.raw[:st] if (out is not None and st > 0) else b"")

    def put(self, key: str, val: bytes) -> None:
        self._req(OP_PUT, key, val)

    def get(self, key: str, maxlen: int = 1 << 20) -> Optional[bytes]:
        st, data = self._req(OP_GET, key, b"", maxlen)
        if st > maxlen:  # value larger than our buffer: re-fetch full size
            st, data = self._req(OP_GET, key, b"", int(st))
        return data if st >= 0 else None

    def delete(self, key: str) -> None:
        self._req(OP_DEL, key)

    def add(self, key: str, delta: int) -> int:
        st, _ = self._req(OP_ADD, key,
                          int(delta).to_bytes(8, "little", signed=True))
        return int(st)

    def bitwise(self, key: str, bits: bytes, op: str = "and") -> int:
        """Contribute to a cross-rank AND/OR (reference:
        controller.cc CrossRankBitwiseAnd/Or). Returns contributor count."""
        st, _ = self._req(OP_AND if op == "and" else OP_OR, key, bits)
        return int(st)

    def get_when(self, key: str, expected: int, timeout: float = 60.0,
                 maxlen: int = 1 << 20) -> Optional[bytes]:
        """Fetch a combined value once `expected` ranks contributed."""
        import time
        deadline = time.monotonic() + timeout
        payload = int(expected).to_bytes(8, "little", signed=True)
        # Escalating backoff: the common case (consistency agreement on
        # every eager collective) completes within a few hundred µs of
        # the last rank's contribution — a flat 5 ms sleep would tax
        # EVERY collective by one interval. Spin fine first, then yield.
        delay = 0.0002
        while time.monotonic() < deadline:
            out = ctypes.create_string_buffer(maxlen)
            st = self._lib.hvdn_kv_request(
                self._h, OP_GETC, key.encode(), payload, 8, out, maxlen)
            if st > maxlen:  # buffer too small: re-fetch at full size
                out = ctypes.create_string_buffer(int(st))
                st = self._lib.hvdn_kv_request(
                    self._h, OP_GETC, key.encode(), payload, 8, out, int(st))
            if st >= 0:
                return out.raw[:st]
            time.sleep(delay)
            delay = min(delay * 2, 0.005)
        return None

    def barrier(self, name: str, size: int, timeout: float = 60.0) -> bool:
        """KV-counter barrier (reference: EnqueueBarrier's negotiation role
        for host-side phases)."""
        self.add(f"__barrier__/{name}", 1)
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st, data = self._req(OP_GET, f"__barrier__/{name}", b"", 8)
            if st == 8 and int.from_bytes(data, "little",
                                          signed=True) >= size:
                return True
            time.sleep(0.002)
        return False

    def ping(self) -> bool:
        st, _ = self._req(OP_PING, "")
        return st == 42

    def close(self) -> None:
        if self._h:
            self._lib.hvdn_kv_client_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeTimeline:
    """Writer-thread Chrome-trace sink (reference: TimelineWriter,
    common/timeline.cc)."""

    def __init__(self, path: str):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.hvdn_timeline_open(path.encode())
        if not self._h:
            raise RuntimeError(f"cannot open timeline at {path}")

    def emit(self, name: str, cat: str, phase: str, ts_us: int,
             dur_us: int = 0, pid: int = 0, tid: int = 0) -> None:
        self._lib.hvdn_timeline_emit(
            self._h, name.encode(), cat.encode(), phase.encode(),
            ts_us, dur_us, pid, tid)

    def emit_counter(self, name: str, series: str, value: float,
                     ts_us: int) -> None:
        """Chrome `"ph":"C"` counter sample (timeline counter tracks)."""
        self._lib.hvdn_timeline_emit_counter(
            self._h, name.encode(), series.encode(), float(value), ts_us)

    def close(self) -> None:
        if self._h:
            self._lib.hvdn_timeline_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeStallInspector:
    """Reference: StallInspector (common/stall_inspector.cc)."""

    def __init__(self, warn_sec: float = 60.0, shutdown_sec: float = 0.0):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.hvdn_stall_new(warn_sec, shutdown_sec)

    def submit(self, name: str) -> None:
        self._lib.hvdn_stall_submit(self._h, name.encode())

    def done(self, name: str) -> None:
        self._lib.hvdn_stall_done(self._h, name.encode())

    def check(self) -> tuple:
        """Returns (stalled_names: list[str], shutdown: bool)."""
        buf = ctypes.create_string_buffer(1 << 16)
        flag = ctypes.c_int(0)
        n = self._lib.hvdn_stall_check(self._h, buf, len(buf),
                                       ctypes.byref(flag))
        names = buf.value.decode().split("\n") if n > 0 else []
        return [x for x in names if x], bool(flag.value)

    def free(self) -> None:
        if self._h:
            self._lib.hvdn_stall_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass
