"""Build and load the hand-written CUDA kernels.

Each source `horovod_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface and loaded with
ctypes. The build runs at first use, into `horovod_tpu_torch/_build/`
(listed in .gitignore), named by a hash of the source, the headers and
that source's own flags, so a checkout builds what it holds and nothing
stale is loaded. `build_all()`
starts one `nvcc` per source, all at once. A build is the port's
counterpart of the JAX package's trace and compile on a cache miss: its
window is perfscope's `compile` phase, and each source is a COMPILE
span on the timeline.

Every C entry point returns `cudaGetLastError()` after its launches;
`check()` raises KernelError when that is not cudaSuccess. `launch()`
calls an entry point with its tensors' device current: a ctypes call
runs in the current device's context, so tensors on a card that is not
current would otherwise be read through the wrong one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence

from horovod_tpu_torch.common.exceptions import KernelError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
CONV_SOURCES = ("conv1x1_fwd", "conv1x1_bn_act_bwd", "conv1x1_bn_bwd")
FLASH_SOURCES = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
SOURCES = CONV_SOURCES + FLASH_SOURCES

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# The conv sources build with -fmad=false: no a*b+c is contracted into an
# FMA, so their dy and mask chains round where torch's separate
# elementwise ops round (the ReLU mask has to reproduce the forward's
# z > 0 exactly). The flash sources need no such match and keep FMAs.
FLAGS = {name: NVCC_FLAGS + (["-fmad=false"] if name in CONV_SOURCES
                             else []) for name in SOURCES}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
ptxas_log: Dict[str, str] = {}
# nvcc runs this process started: an elastic reset must not move it.
build_count = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels are built on a "
                      "machine with the CUDA toolkit")


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS[name]).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *FLAGS[name], "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    global build_count
    build_count += 1
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    ptxas_log[name] = log
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none


def _build(names: Sequence[str]) -> None:
    """Build the sources of `names` not yet built, one nvcc each, in
    parallel (the caller holds _lock)."""
    todo = [n for n in names if not os.path.exists(_target(n))]
    if not todo:
        return
    from horovod_tpu_torch.core import topology
    from horovod_tpu_torch.profiler import perfscope
    tl = topology.timeline()
    t0 = time.perf_counter()
    try:
        if tl is not None:
            for n in todo:
                tl.span_begin(n, "COMPILE")
        started = [(n, _start(n)) for n in todo]
        for n, s in started:
            try:
                _finish(n, s)
            finally:
                if tl is not None:
                    tl.span_end(n, "COMPILE")
    finally:
        perfscope.attribute("compile", time.perf_counter() - t0)


def build_all(names: Sequence[str] = SOURCES) -> List[str]:
    """Build every source not yet built, one nvcc each, in parallel.
    Returns the library paths."""
    with _lock:
        _build(names)
    return [_target(n) for n in names]


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built at first use."""
    with _lock:
        if name not in _libs:
            _build([name])
            _libs[name] = ctypes.CDLL(_target(name))
        return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err} at launch")


def launch(fn, what: str, device, *args) -> None:
    """Call the C entry point `fn` with `device` (its tensors' card)
    current, then `check()` what it returned."""
    import torch
    with torch.cuda.device(device):
        err = fn(*args)
    check(err, what)


#: Set while a step is being recorded (analysis/graph.py): a call of a
#: `kernel_op` wrapper goes to ``op_hook(name, fn, args, kwargs)``.
#: None otherwise, and then testing it is all a wrapper pays.
op_hook = None


def kernel_op(name: str):
    """Decorator of a kernel wrapper: with `op_hook` set, the call goes
    through it, so a recording sees one op named `name` for the launch
    (a ctypes call is invisible to torch's dispatcher)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            hook = op_hook
            if hook is None:
                return fn(*args, **kwargs)
            return hook(name, fn, args, kwargs)
        return call
    return wrap


P = ctypes.c_void_p
I = ctypes.c_int
