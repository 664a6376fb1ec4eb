"""Process world over torch.distributed (counterpart of
horovod_tpu/core/topology.py init/shutdown/rank/size/local/cross).

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

The two-level (cross, local) split of the world is the launcher's:
HOROVOD_CROSS_RANK/SIZE and HOROVOD_LOCAL_RANK/SIZE, ranks contiguous
per host. init() gathers each rank's (local size, cross rank, local
rank) once, so every rank reaches the same verdict on `is_homogeneous()`
and on whether the split holds. HOROVOD_TPU_MESH_SHAPE ("dcn:A,ici:B"
or "AxB") overrides the split as the JAX package reshapes its mesh to
("dcn", "ici"): dcn is the cross level, ici the local one, rank r at
(r // B, r % B). Under HOROVOD_HIERARCHICAL_ALLREDUCE or _ALLGATHER,
init builds one local group per cross index and one cross group per
local index, in rank order (ops/collectives.py uses them for the global
set). `init(process_sets=[...])` registers sets beyond the global one
(core/process_sets.py). Under HOROVOD_AUTOTUNE init builds the
ParameterManager, else under HOROVOD_BUCKET_AUTOTUNE the
OnlineBucketTuner (core/autotune.py): both move the fusion threshold,
so at most one runs; shutdown drops it.

With HOROVOD_TIMELINE set, init starts the Chrome-trace timeline
(profiler/timeline.py) on rank 0, as the JAX package does: co-hosted
ranks sharing the path would overwrite each other's file, and
`hvd.start_timeline` works on any rank with a path of its own. A path
that cannot be written logs a warning and the world runs on without a
timeline. shutdown pushes the perfscope summary to the launcher's KV
(profiler/perfscope.py) and closes the timeline.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import threading
from typing import List, Optional, Sequence, Tuple

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
    cross_rank: int = 0
    cross_size: int = 1
    homogeneous: bool = True
    device: Optional[torch.device] = None
    config: Optional[C.Config] = None
    store_file: str = ""  # FileStore we created for a one-process world
    rendezvous: str = ""  # where the world met, e.g. "tcp://10.0.0.1:2345"
    hier: Optional["Hier"] = None  # hierarchical mode's groups
    process_set_table: object = None  # core/process_sets.ProcessSetTable
    parameter_manager: object = None  # core/autotune.ParameterManager
    bucket_tuner: object = None  # core/autotune.OnlineBucketTuner
    joined: bool = False  # inside hvd.join(); guarded by _lock
    timeline: object = None  # profiler/timeline.Timeline while one runs


@dataclasses.dataclass(frozen=True)
class Hier:
    """The two-level split: n_cross x n_local ranks, rank r at cross
    index r // n_local and local index r % n_local; this rank's local
    group (its row) and cross group (its column)."""

    n_cross: int
    n_local: int
    local_group: object
    cross_group: object


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


def parse_mesh_shape(spec: str, size: int) -> Tuple[int, int]:
    """(dcn, ici) from HOROVOD_TPU_MESH_SHAPE ("dcn:2,ici:4" or "2x4"),
    with the JAX package's errors (horovod_tpu/core/topology.py
    _build_hier_mesh)."""
    axes = {"dcn": 1, "ici": 1}
    s = spec.strip().lower()
    try:
        if "x" in s and ":" not in s:
            a, b = s.split("x", 1)
            axes["dcn"], axes["ici"] = int(a), int(b)
        else:
            for part in s.split(","):
                name, n = part.split(":")
                if name.strip() not in axes:
                    raise ValueError(name)
                axes[name.strip()] = int(n)
    except (ValueError, TypeError):
        raise HorovodError(
            f"bad HOROVOD_TPU_MESH_SHAPE '{spec}': expected 'dcn:A,ici:B' "
            f"or 'AxB'")
    if axes["dcn"] * axes["ici"] != size:
        raise HorovodError(
            f"HOROVOD_TPU_MESH_SHAPE '{spec}' = {axes['dcn']}x{axes['ici']} "
            f"does not cover {size} devices")
    return axes["dcn"], axes["ici"]


def _layout(size: int, row: Sequence[int], dev: torch.device
            ) -> List[List[int]]:
    """Every rank's (local size, cross rank, local rank), in rank order:
    one all_gather at init."""
    if size == 1:
        return [list(row)]
    mine = torch.tensor(row, dtype=torch.int64, device=dev)
    rows = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(rows, mine)
    return [r.tolist() for r in rows]


def _split(cfg: C.Config, size: int, layout: List[List[int]]
           ) -> Optional[Tuple[int, int]]:
    """(n_cross, n_local): HOROVOD_TPU_MESH_SHAPE's, else the launcher's
    where every host has the same local size and the ranks run host by
    host; None where the launcher's layout is not such a grid."""
    if cfg.mesh_shape:
        return parse_mesh_shape(cfg.mesh_shape, size)
    n_local = layout[0][0]
    if size % n_local or any(
            (ls, cr, lr) != (n_local, r // n_local, r % n_local)
            for r, (ls, cr, lr) in enumerate(layout)):
        return None
    return size // n_local, n_local


def _hier_groups(n_cross: int, n_local: int, rank: int) -> Hier:
    """Every rank creates every group, in the same order (new_group is
    collective over the world): the local groups (rows), then the cross
    groups (columns)."""
    rows = [dist.new_group(list(range(c * n_local, (c + 1) * n_local)))
            for c in range(n_cross)]
    cols = [dist.new_group(list(range(j, n_cross * n_local, n_local)))
            for j in range(n_local)]
    return Hier(n_cross, n_local, rows[rank // n_local],
                cols[rank % n_local])


def init(device: Optional[str] = None,
         init_method: Optional[str] = None,
         process_sets: Optional[Sequence] = None) -> None:
    """Join the process world (hvd.init()).

    device: None (the card, `cuda:<local_rank>`) or "cpu" (gloo).
    init_method: a torch.distributed init URL (`file://...` or
      `tcp://host:port`) in place of the launcher's coordinator.
    process_sets: ProcessSet objects to register beyond the global one;
      every rank passes the same list.
    """
    with _lock:
        if _state.initialized:
            return
        cfg = C.Config.from_env()
        rank = cfg.rank if cfg.rank is not None else 0
        size = cfg.size if cfg.size is not None else 1
        local_rank = cfg.local_rank if cfg.local_rank is not None else rank
        local_size = cfg.local_size if cfg.local_size is not None else size
        cross_rank = cfg.cross_rank if cfg.cross_rank is not None \
            else rank // local_size
        cross_size = cfg.cross_size if cfg.cross_size is not None \
            else -(-size // local_size)
        if cfg.mesh_shape:  # refuse a bad shape before joining the world
            parse_mesh_shape(cfg.mesh_shape, size)
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
        layout = _layout(size, (local_size, cross_rank, local_rank), dev)
        split = _split(cfg, size, layout)
        hier = None
        # The autotuner's hierarchical knob (a mesh shape given) needs
        # the groups as well.
        if split is not None and (cfg.hierarchical_allreduce
                                  or cfg.hierarchical_allgather
                                  or (cfg.autotune and cfg.mesh_shape)):
            hier = _hier_groups(*split, rank)
        _state.rank, _state.size = rank, size
        _state.local_rank, _state.local_size = local_rank, local_size
        _state.cross_rank, _state.cross_size = cross_rank, cross_size
        _state.homogeneous = len({row[0] for row in layout}) == 1
        _state.hier = hier
        _state.device, _state.config = dev, cfg
        _state.store_file = store_file
        _state.rendezvous = where
        from horovod_tpu_torch.core import process_sets as ps_mod
        _state.process_set_table = ps_mod.ProcessSetTable(size)
        from horovod_tpu_torch.core import autotune
        if cfg.autotune:
            _state.parameter_manager = autotune.ParameterManager(cfg)
        elif cfg.bucket_autotune:
            _state.bucket_tuner = autotune.OnlineBucketTuner(cfg)
        _state.initialized = True
        for ps in process_sets or ():
            _state.process_set_table.register(ps)
        if cfg.timeline_path and rank == 0 and _state.timeline is None:
            from horovod_tpu_torch.profiler.timeline import Timeline
            tl = Timeline(cfg.timeline_path,
                          mark_cycles=cfg.timeline_mark_cycles)
            try:
                tl.start()
                _state.timeline = tl
            except OSError as e:
                from horovod_tpu_torch.common.hvd_logging import get_logger
                get_logger().warning("could not start timeline at %s: %s",
                                     cfg.timeline_path, e)


def shutdown() -> None:
    """Leave the world and release the process group."""
    with _lock:
        if not _state.initialized:
            return
        from horovod_tpu_torch.profiler import perfscope
        perfscope.push_summary()  # while the rank still keys it
        if _state.timeline is not None:
            _state.timeline.stop()
        _state.process_set_table.clear()
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


def cross_rank() -> int:
    return _require().cross_rank


def cross_size() -> int:
    return _require().cross_size


def is_homogeneous() -> bool:
    """Every host runs the same number of ranks (the local sizes that
    init gathered agree)."""
    return _require().homogeneous


def hier() -> Optional[Hier]:
    """The hierarchical split's groups, where HOROVOD_HIERARCHICAL_*
    asked for them and the world splits into a grid; else None."""
    return _require().hier


def device() -> torch.device:
    """The device this process trains on."""
    return _require().device


def config() -> C.Config:
    return _require().config


def parameter_manager():
    """The HOROVOD_AUTOTUNE tuner, or None."""
    return _require().parameter_manager


def bucket_tuner():
    """The HOROVOD_BUCKET_AUTOTUNE tuner, or None."""
    return _require().bucket_tuner


def set_joined(flag: bool) -> None:
    with _lock:
        _require().joined = flag


def joined() -> bool:
    """True while this rank is inside hvd.join()."""
    with _lock:
        return _state.joined


def timeline():
    """The running Chrome-trace timeline, or None (no init needed)."""
    return _state.timeline


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Start a timeline into `file_path` on this rank (raises OSError
    when the file cannot be written); a running one goes on."""
    with _lock:
        if _state.timeline is None:
            from horovod_tpu_torch.profiler.timeline import Timeline
            tl = Timeline(file_path, mark_cycles=mark_cycles)
            tl.start()
            _state.timeline = tl


def stop_timeline() -> None:
    """Stop the running timeline and write its file's end."""
    with _lock:
        tl, _state.timeline = _state.timeline, None
    if tl is not None:
        tl.stop()


def rendezvous() -> str:
    """Where this world met: the init URL, or the `tcp://` address rank 0
    published through the launcher's rendezvous KV."""
    return _require().rendezvous
