"""Process world over torch.distributed (counterpart of
horovod_tpu/core/topology.py init/shutdown/rank/size).

One process drives one device. `init()` reads the rendezvous env that
the launcher injects (HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE and
HOROVOD_COORDINATOR_ADDR "host:port"); without it the world is this one
process. The device is `cuda:<local_rank>` with the NCCL backend unless
the caller asks for `device="cpu"`, which runs gloo on the host. With no
CUDA and no `device="cpu"`, init raises: the package never carries on
quietly on the CPU.

Only the global process set exists in this package so far.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import config as C
from horovod_tpu_torch.common.exceptions import HorovodError


@dataclasses.dataclass
class _State:
    initialized: bool = False
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    device: Optional[torch.device] = None
    config: Optional[C.Config] = None
    store_file: str = ""  # FileStore we created for a one-process world


_state = _State()
_lock = threading.Lock()


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "").strip()
    return int(v) if v else default


def init(device: Optional[str] = None,
         init_method: Optional[str] = None) -> None:
    """Join the process world (hvd.init()).

    device: None (the card, `cuda:<local_rank>`) or "cpu" (gloo).
    init_method: a torch.distributed init URL (`file://...` or
      `tcp://host:port`). Default: `tcp://` HOROVOD_COORDINATOR_ADDR when
      the launcher set it, else a FileStore in a fresh temporary file for
      a one-process world.
    """
    with _lock:
        if _state.initialized:
            return
        cfg = C.Config.from_env()
        rank = _env_int(C.HOROVOD_RANK, 0)
        size = _env_int(C.HOROVOD_SIZE, 1)
        local_rank = _env_int(C.HOROVOD_LOCAL_RANK, rank)
        local_size = _env_int(C.HOROVOD_LOCAL_SIZE, size)
        if device is None:
            if not torch.cuda.is_available():
                raise HorovodError(
                    "hvd.init(): no CUDA device is visible; pass "
                    "device='cpu' to run on the host with gloo")
            torch.cuda.set_device(local_rank)
            dev = torch.device("cuda", local_rank)
            backend = "nccl"
        elif device == "cpu":
            dev = torch.device("cpu")
            backend = "gloo"
        else:
            raise ValueError(f"hvd.init(): device must be None or 'cpu', "
                             f"got {device!r}")
        store_file = ""
        if init_method is None:
            addr = os.environ.get(C.HOROVOD_COORDINATOR_ADDR, "").strip()
            if addr:
                init_method = f"tcp://{addr}"
            elif size == 1:
                fd, store_file = tempfile.mkstemp(prefix="hvd_store_")
                os.close(fd)
                os.unlink(store_file)  # FileStore creates it
                init_method = f"file://{store_file}"
            else:
                raise HorovodError(
                    f"hvd.init(): HOROVOD_SIZE={size} but no "
                    f"{C.HOROVOD_COORDINATOR_ADDR} and no init_method")
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=size)
        _state.rank, _state.size = rank, size
        _state.local_rank, _state.local_size = local_rank, local_size
        _state.device, _state.config = dev, cfg
        _state.store_file = store_file
        _state.initialized = True


def shutdown() -> None:
    """Leave the world and release the process group."""
    with _lock:
        if not _state.initialized:
            return
        dist.destroy_process_group()
        if _state.store_file and os.path.exists(_state.store_file):
            os.unlink(_state.store_file)
        _state.__init__()


def is_initialized() -> bool:
    return _state.initialized


def _require() -> _State:
    if not _state.initialized:
        raise HorovodError("horovod_tpu_torch has not been initialized; "
                           "call hvd.init() first")
    return _state


def rank() -> int:
    return _require().rank


def size() -> int:
    return _require().size


def local_rank() -> int:
    return _require().local_rank


def local_size() -> int:
    return _require().local_size


def device() -> torch.device:
    """The device this process trains on."""
    return _require().device


def config() -> C.Config:
    return _require().config
