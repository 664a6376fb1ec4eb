"""Process world over torch.distributed (counterpart of
horovod_tpu/core/topology.py init/shutdown/rank/size).

One process drives one device. `init()` reads the env the launcher
injects (runner/launch.py): HOROVOD_RANK (or, under mpirun/jsrun, the
rank variable HOROVOD_MPI_RANK_ENV names), SIZE, LOCAL_RANK, LOCAL_SIZE,
and where the world meets:
- HOROVOD_COORDINATOR_ADDR "host:port" (the launcher picks it when every
  worker is on its host): a `tcp://` store that rank 0 binds;
- else, with the launcher's rendezvous KV in the env
  (HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT), rank 0 binds a store on
  `<its ip>:<free port>` and publishes the address under the scope
  `torch_coordinator`, key `r<elastic round>`; the others read it,
  waiting at most KV_WAIT_SECONDS;
- else, for a world of one, a FileStore in a fresh temporary file.
The device is `cuda:<local_rank>` with the NCCL backend unless the
caller asks for `device="cpu"`, which runs gloo on the host. With no
CUDA and no `device="cpu"`, or a local rank with no card of its own,
init raises: the package never carries on quietly on the CPU.

Only the global process set exists in this package so far.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import threading
from typing import Optional, Tuple

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
    rendezvous: str = ""  # where the world met, e.g. "tcp://10.0.0.1:2345"


_state = _State()
_lock = threading.Lock()

KV_SCOPE = "torch_coordinator"
KV_WAIT_SECONDS = 300.0


def _bind_store(size: int) -> Tuple[str, "dist.TCPStore"]:
    """Rank 0's store on `<local ip>:<free port>`. The port is free when
    picked and may be taken before the bind: one retry on a new port."""
    from horovod_tpu_torch.runner.launch import _free_port, _local_ip
    host = _local_ip()

    def bind():
        port = _free_port()
        return f"{host}:{port}", dist.TCPStore(
            host, port, size, is_master=True, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=KV_WAIT_SECONDS))

    try:
        return bind()
    except (RuntimeError, OSError):
        return bind()


def _kv_store(cfg: C.Config, rank: int, size: int
              ) -> Tuple[str, "dist.TCPStore"]:
    """The world's store through the launcher's rendezvous KV: rank 0
    binds it and publishes its address, the others read it."""
    from horovod_tpu_torch.runner.rendezvous import KVClient
    kv = KVClient(cfg.rendezvous_addr, cfg.rendezvous_port)
    key = f"r{os.environ.get(C.HOROVOD_ELASTIC_ROUND, '0')}"
    timeout = datetime.timedelta(seconds=KV_WAIT_SECONDS)
    if rank == 0:
        addr, store = _bind_store(size)
        kv.put(KV_SCOPE, key, addr.encode())
        return addr, store
    data = kv.get(KV_SCOPE, key, timeout=KV_WAIT_SECONDS)
    if data is None:
        raise HorovodError(
            f"hvd.init(): rank {rank} waited {KV_WAIT_SECONDS:.0f} s for "
            f"rank 0 to publish the coordinator address")
    addr = data.decode()
    host, _, port = addr.rpartition(":")
    return addr, dist.TCPStore(host, int(port), size, is_master=False,
                               timeout=timeout)


def _note_no_effect(cfg: C.Config) -> None:
    """Knobs the JAX package reads that have nothing to act on here."""
    from horovod_tpu_torch.common.hvd_logging import get_logger
    if cfg.cycle_time_ms > 0.0:
        get_logger().info(
            "HOROVOD_CYCLE_TIME=%.1fms has no effect: collectives are "
            "issued eagerly, with no background cycle", cfg.cycle_time_ms)
    if cfg.cache_capacity != C.DEFAULT_CACHE_CAPACITY:
        get_logger().info(
            "HOROVOD_CACHE_CAPACITY=%d has no effect: eager "
            "torch.distributed calls build nothing to cache",
            cfg.cache_capacity)


def init(device: Optional[str] = None,
         init_method: Optional[str] = None) -> None:
    """Join the process world (hvd.init()).

    device: None (the card, `cuda:<local_rank>`) or "cpu" (gloo).
    init_method: a torch.distributed init URL (`file://...` or
      `tcp://host:port`) in place of the launcher's coordinator.
    """
    with _lock:
        if _state.initialized:
            return
        cfg = C.Config.from_env()
        rank = cfg.rank if cfg.rank is not None else 0
        size = cfg.size if cfg.size is not None else 1
        local_rank = cfg.local_rank if cfg.local_rank is not None else rank
        local_size = cfg.local_size if cfg.local_size is not None else size
        if device is None:
            if not torch.cuda.is_available():
                raise HorovodError(
                    "hvd.init(): no CUDA device is visible; pass "
                    "device='cpu' to run on the host with gloo")
            n = torch.cuda.device_count()
            if local_rank >= n:
                raise HorovodError(
                    f"hvd.init(): local rank {local_rank} has no GPU of its "
                    f"own: {n} visible; start at most {n} process(es) on "
                    f"this host")
            torch.cuda.set_device(local_rank)
            dev = torch.device("cuda", local_rank)
            backend = "nccl"
        elif device == "cpu":
            dev = torch.device("cpu")
            backend = "gloo"
        else:
            raise ValueError(f"hvd.init(): device must be None or 'cpu', "
                             f"got {device!r}")
        _note_no_effect(cfg)
        store_file = ""
        store = None
        if init_method is None:
            if cfg.coordinator_addr:
                init_method = f"tcp://{cfg.coordinator_addr}"
            elif cfg.rendezvous_addr and size > 1:
                addr, store = _kv_store(cfg, rank, size)
                where = f"tcp://{addr} (published through the rendezvous KV)"
            elif size == 1:
                fd, store_file = tempfile.mkstemp(prefix="hvd_store_")
                os.close(fd)
                os.unlink(store_file)  # FileStore creates it
                init_method = f"file://{store_file}"
            else:
                raise HorovodError(
                    f"hvd.init(): HOROVOD_SIZE={size} but no "
                    f"{C.HOROVOD_COORDINATOR_ADDR}, no rendezvous and no "
                    f"init_method")
        if store is None:
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=size)
            where = init_method
        else:
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=size)
        _state.rank, _state.size = rank, size
        _state.local_rank, _state.local_size = local_rank, local_size
        _state.device, _state.config = dev, cfg
        _state.store_file = store_file
        _state.rendezvous = where
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


def rank_or_none() -> Optional[int]:
    """This process's rank, or None before init (for log prefixes)."""
    return _state.rank if _state.initialized else None


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


def rendezvous() -> str:
    """Where this world met: the init URL, or the `tcp://` address rank 0
    published through the launcher's rendezvous KV."""
    return _require().rendezvous
