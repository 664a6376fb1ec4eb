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
(core/process_sets.py). Under HOROVOD_MESH ("dp=2,sp=2", the JAX
package's grammar; parallel/mesh.py) init parses the MeshSpec before
joining the world and, once joined, builds the named-axis mesh: every
rank registers every axis group as a process set, in the same order
(`new_group` is collective over the world), before the sets passed to
init; `mesh_spec()` and `hybrid_mesh()` return them (None without
HOROVOD_MESH). Under HOROVOD_AUTOTUNE init builds the
ParameterManager, else under HOROVOD_BUCKET_AUTOTUNE the
OnlineBucketTuner (core/autotune.py): both move the fusion threshold,
so at most one runs; shutdown drops it.

Elastic mode (HOROVOD_ELASTIC=1, set by the elastic launcher for its
workers; elastic/): the launcher hosts one TCPStore per round and
publishes its address as HOROVOD_COORDINATOR_ADDR, which every rank
joins as a client, so the death of any worker leaves the store up. A
dead peer under NCCL does not fail a collective, it hangs it, and by
default torch's NCCL watchdog then tears the whole process down, which
loses the in-memory state elastic exists to keep. So in elastic mode
init gives the process group a finite timeout
(HOROVOD_STALL_SHUTDOWN_TIME_SECONDS where set, else
DEFAULT_ELASTIC_COLLECTIVE_TIMEOUT_SECONDS, 60 s), and sets, where the
caller has not, TORCH_NCCL_BLOCKING_WAIT=1 (`Work.wait()` blocks the
host until the collective completes or times out, aborts the
communicator and raises in the waiting thread; every collective of the
port waits on its Work) and TORCH_NCCL_ASYNC_ERROR_HANDLING=0
(the watchdog does not kill the process). ops/collectives.py turns
that error, and gloo's "Connection closed by peer", into
HorovodInternalError. `shutdown(abort=True)`, the elastic reset's,
aborts the NCCL communicators (`_abort_process_group`) rather than
destroying them, which can hang on a broken one, and `reinit()` joins
again with the arguments of the last init. The global process set is
rebuilt at every init; sets registered at init or after are not.

The runtime control plane starts at init, as in the JAX package: the
stall inspector (native/ StallInspector, or PyStallInspector without a
toolchain; off under HOROVOD_STALL_CHECK_DISABLE) with its watcher
thread, which warns about collectives pending past
HOROVOD_STALL_CHECK_TIME_SECONDS (ops/collectives.py bounds the waits
themselves); the consistency checker (core/consistency.py) where
HOROVOD_CONSISTENCY_CHECK is on, by default in a launched job, which
injects the native KV server; the fingerprint verifier
(analysis/verifier.py) under HOROVOD_CHECK_COLLECTIVES; and the metrics
exporter thread (observability/export.py). Outside elastic mode, with
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS > 0, the process group's timeout is
set past that window (twice it, plus 5 s), so that a gloo operation the
watchdog gave up on ends on its own. shutdown stops each of them;
`mark_aborted` records a world the watchdog aborted, whose collectives
then raise until the next init.

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
    mesh_spec: object = None  # parallel/mesh.MeshSpec under HOROVOD_MESH
    hybrid_mesh: object = None  # parallel/mesh.Mesh under HOROVOD_MESH
    stall_inspector: object = None  # native or Python StallInspector
    stall_stop: object = None  # threading.Event ending the watcher
    stall_thread: object = None  # the watcher thread
    aborted: str = ""  # why the watchdog aborted the world, if it did


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
# (device, init_method) of the last successful init, for reinit().
_last_init: Optional[Tuple[Optional[str], Optional[str]]] = None

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


def _elastic_timeout(cfg: C.Config) -> datetime.timedelta:
    """The process group's timeout in elastic mode (module docstring),
    after setting torch's NCCL error handling for it."""
    os.environ.setdefault("TORCH_NCCL_BLOCKING_WAIT", "1")
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    return datetime.timedelta(seconds=(
        cfg.stall_shutdown_seconds if cfg.stall_shutdown_seconds > 0
        else C.DEFAULT_ELASTIC_COLLECTIVE_TIMEOUT_SECONDS))


def _round_store(addr: str, size: int, timeout: datetime.timedelta
                 ) -> "dist.TCPStore":
    """A client of the elastic launcher's store for this round."""
    host, _, port = addr.rpartition(":")
    return dist.TCPStore(host, int(port), size, is_master=False,
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
    dist.all_gather(rows, mine, async_op=True).wait()
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
    global _last_init
    with _lock:
        if _state.initialized:
            return
        args = (device, init_method)
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
        from horovod_tpu_torch.parallel import mesh as mesh_mod
        spec = mesh_mod.MeshSpec.parse(cfg.mesh_spec, size) \
            if cfg.mesh_spec else None
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
        pg_kw = {}
        if cfg.elastic:
            pg_kw["timeout"] = _elastic_timeout(cfg)
        elif cfg.stall_shutdown_seconds > 0 and not cfg.stall_check_disable:
            pg_kw["timeout"] = datetime.timedelta(
                seconds=2 * cfg.stall_shutdown_seconds + 5)
        if init_method is None:
            if cfg.elastic and cfg.coordinator_addr:
                store = _round_store(cfg.coordinator_addr, size,
                                     pg_kw["timeout"])
                where = f"tcp://{cfg.coordinator_addr}"
            elif cfg.coordinator_addr:
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
                                    rank=rank, world_size=size, **pg_kw)
            where = init_method
        else:
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=size, **pg_kw)
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
        _last_init = args
        if spec is not None:
            _state.mesh_spec = spec
            _state.hybrid_mesh = mesh_mod.build_mesh(spec)
        for ps in process_sets or ():
            _state.process_set_table.register(ps)
        _start_control_plane(cfg, rank, size)
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


def shutdown(abort: bool = False) -> None:
    """Leave the world and release the process group; with `abort`, an
    NCCL world's communicators are aborted, not destroyed (the elastic
    reset: a broken communicator can hang a destroy)."""
    with _lock:
        if not _state.initialized:
            return
        from horovod_tpu_torch.profiler import perfscope
        perfscope.push_summary()  # while the rank still keys it
        _stop_control_plane()
        if _state.timeline is not None:
            _state.timeline.stop()
        _state.process_set_table.clear()
        c10d = dist.distributed_c10d
        if not dist.is_initialized():
            pass  # the watchdog aborted an NCCL world already
        elif abort and dist.get_backend() == "nccl" and \
                hasattr(c10d, "_abort_process_group"):
            c10d._abort_process_group()
        else:
            dist.destroy_process_group()
        if _state.store_file and os.path.exists(_state.store_file):
            os.unlink(_state.store_file)
        _state.__init__()


def _start_control_plane(cfg: C.Config, rank: int, size: int) -> None:
    """The consistency checker, the verifier, the stall inspector and its
    watcher, and the metrics exporter (module docstring); telemetry never
    fails init, the checker's version handshake does."""
    from horovod_tpu_torch.common.hvd_logging import get_logger
    if cfg.consistency_check:
        from horovod_tpu_torch.core import consistency
        consistency.maybe_init(cfg, rank, size)
    if cfg.check_collectives:
        from horovod_tpu_torch.analysis import verifier
        verifier.maybe_init(cfg, rank, size)
    if not cfg.stall_check_disable:
        from horovod_tpu_torch import native
        si = None
        if native.available():
            try:
                si = native.NativeStallInspector(
                    cfg.stall_warning_seconds, cfg.stall_shutdown_seconds)
            except Exception:
                si = None
        if si is None:
            from horovod_tpu_torch.common.resilience import PyStallInspector
            si = PyStallInspector(cfg.stall_warning_seconds,
                                  cfg.stall_shutdown_seconds)
        _state.stall_inspector = si
        _state.stall_stop = threading.Event()
        _state.stall_thread = threading.Thread(
            target=_stall_watch, args=(si, cfg, _state.stall_stop),
            name="hvd-stall-watch", daemon=True)
        _state.stall_thread.start()
    try:
        from horovod_tpu_torch.observability import export
        export.start_exporter(cfg)
    except Exception as e:
        get_logger().warning("metrics exporter not started: %s", e)


def _stall_watch(si, cfg: C.Config, stop: threading.Event) -> None:
    """Warn about collectives pending past the warning window, naming the
    ranks the consistency checker has not seen and the verifier's last
    agreed call (the JAX package's watcher; the waits themselves are
    bounded by ops/collectives.py StallWatchdog)."""
    from horovod_tpu_torch.common.hvd_logging import get_logger
    while not stop.wait(max(cfg.stall_warning_seconds / 2.0, 1.0)):
        stalled, _ = si.check()
        if not stalled:
            continue
        who = ""
        try:
            from horovod_tpu_torch.core import consistency
            checker = consistency.get()
            lag = checker.lagging_ranks() if checker is not None else []
            if lag:
                who = f"; rank(s) {lag} have not arrived"
            from horovod_tpu_torch.analysis import verifier
            who += verifier.stall_context()
            from horovod_tpu_torch.observability import flight, metrics
            metrics.registry().counter(
                "horovod_stall_warnings_total", "Stall warnings",
                labelnames=("source",)).labels(source="watcher").inc()
            flight.record("stall", f"watcher: collective(s) "
                          f"{', '.join(stalled)} stalled over "
                          f"{cfg.stall_warning_seconds:.0f}s{who}")
        except Exception:
            pass
        get_logger().warning(
            "One or more collectives stalled for over %.0fs: %s; some "
            "ranks may not have reached them%s "
            "(HOROVOD_STALL_CHECK_TIME_SECONDS)",
            cfg.stall_warning_seconds, ", ".join(stalled), who)


def _stop_control_plane() -> None:
    try:  # the final metrics flush, while the rank still keys it
        from horovod_tpu_torch.observability import export
        export.stop_exporter()
    except Exception:
        pass
    if _state.stall_stop is not None:
        _state.stall_stop.set()
        _state.stall_thread.join(timeout=5.0)
    from horovod_tpu_torch.analysis import verifier
    from horovod_tpu_torch.core import consistency
    consistency.reset()
    verifier.reset()


def control_plane() -> dict:
    """What of the runtime control plane is live in this world: the
    native KV server the consistency check agrees through, the checker,
    the verifier, the stall windows, and the metrics, flight and trace
    gates."""
    st = _require()
    cfg = st.config
    from horovod_tpu_torch import native
    from horovod_tpu_torch.analysis import verifier
    from horovod_tpu_torch.core import consistency
    from horovod_tpu_torch.observability import flight, metrics, tracing
    addr = os.environ.get(C.HOROVOD_NATIVE_KV_ADDR, "")
    port = os.environ.get(C.HOROVOD_NATIVE_KV_PORT, "")
    return {
        "native": native.active_path(),
        "native_kv": f"{addr}:{port}" if addr and port else None,
        "consistency_check": consistency.get() is not None,
        "check_collectives": verifier.get() is not None,
        "stall_check": None if st.stall_inspector is None else
        {"warning_s": cfg.stall_warning_seconds,
         "shutdown_s": cfg.stall_shutdown_seconds},
        "metrics": metrics.enabled(), "flight": flight.enabled(),
        "trace": tracing.get() is not tracing.NOOP}


def mark_aborted(reason: str) -> None:
    """Record that the stall watchdog aborted the world: collectives
    raise until shutdown and the next init."""
    _state.aborted = reason or "aborted"


def raw_state() -> _State:
    """The state as it is, initialized or not (observability reads it)."""
    return _state


def reinit() -> None:
    """init() again with the device and init_method of the last init
    (the elastic reset); the launcher's env says where the new world
    meets."""
    if _last_init is None:
        raise HorovodError("reinit() before any successful hvd.init()")
    init(*_last_init)


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


def local_slot_ranks() -> List[int]:
    """The ranks whose devices this process owns: `[rank()]`. The JAX
    package answers with every rank of its process's local devices (one
    process drives all of a host's TPU chips); here one process drives
    one GPU, so the list holds this process's own rank."""
    return [_require().rank]


def is_homogeneous() -> bool:
    """Every host runs the same number of ranks (the local sizes that
    init gathered agree)."""
    return _require().homogeneous


def hier() -> Optional[Hier]:
    """The hierarchical split's groups, where HOROVOD_HIERARCHICAL_*
    asked for them and the world splits into a grid; else None."""
    return _require().hier


def mesh_spec():
    """The parsed HOROVOD_MESH MeshSpec (parallel/mesh.py), or None."""
    return _require().mesh_spec


def hybrid_mesh():
    """The HOROVOD_MESH named-axis mesh (parallel/mesh.Mesh: rank r at
    coordinate unravel(r, mesh_spec().sizes()), a process set per axis
    group), or None when the world is purely data-parallel."""
    return _require().hybrid_mesh


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


# Build and query calls (the JAX package's topology.py:753-784 answers
# them for its TPU build; the port answers from torch's own build).

def nccl_built() -> bool:
    return dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def mpi_built() -> bool:
    return dist.is_mpi_available()


def cuda_built() -> bool:
    return torch.version.cuda is not None


def rocm_built() -> bool:
    return getattr(torch.version, "hip", None) is not None


def tpu_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False


def _backend() -> Optional[str]:
    return dist.get_backend() if _state.initialized else None


def gloo_enabled() -> bool:
    """The world joined over gloo (init(device="cpu"))."""
    return _backend() == "gloo"


def mpi_enabled() -> bool:
    """The world joined over MPI (never: init joins NCCL or gloo)."""
    return _backend() == "mpi"
