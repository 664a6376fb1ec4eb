"""Elastic state objects: in-memory commits, rank-0 sync and the disk
checkpoint (counterpart of horovod_tpu/elastic/state.py and of the torch
state of horovod_tpu/frontends/torch_elastic.py).

The contract (reference: horovod/common/elastic.py State):

  commit()  — snapshot now (user-called at a consistent point), then
              surface a pending host update as HostsUpdatedInterrupt
  restore() — roll back to the last commit (after HorovodInternalError)
  sync()    — broadcast rank 0's state to everyone (after a reset, so
              joining workers pick up the survivors' state)
  on_reset()/register_reset_callbacks — user hooks after a topology change

`TorchState` holds models, optimizers (plain torch ones or a
`DistributedOptimizer`) and samplers through per-type handlers (the
reference's torch/elastic/state.py), everything else as plain values.
A model's or optimizer's commit is a copy on its own device: a CUDA
tensor survives a process-group reset in the CUDA context, and the
copy costs a device-to-device pass, not a host round trip. The reset
(`to_host`) moves the committed snapshots to host memory; the live
modules stay on their device.

`TrainLoopState` is the exactly-once resume unit: a TorchState with the
step counter, the epoch, the data-stream cursor (records consumed this
epoch) and an RNG slot, tied to a `ckpt.AsyncCheckpointer`. The resume
decision lives in `sync()`: before rank 0 broadcasts its state, it
compares its in-memory step with the newest committed generation on
disk. A surviving worker's memory is always at least as fresh, so it
keeps its state; a freshly started rank 0 (whole-job preemption) finds
disk ahead and restores before broadcasting, so every rank converges on
the same generation.

On disk a state's commit is the JAX package's format: every tensor of
the handlers' snapshots is a leaf of the tree ``{"trees": {<handler>:
{<key>: tensor}}}`` (`.npy` shards, bf16 as in ckpt/sharded.py), with
keys the snapshot's own path joined by ".", so a model's leaves keep
their state_dict names and ``ckpt.load_params(root, key="model")`` gives
a state_dict back; the rest (each snapshot's structure, the plain
values) rides the pickled objects.

Knobs: HOROVOD_CKPT_DIR attaches a checkpointer, HOROVOD_CKPT_EVERY
(steps) drives `maybe_checkpoint`, HOROVOD_CKPT_RESUME=0 turns the
restore probe off.
"""

from __future__ import annotations

import copy
import os
import random
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from horovod_tpu_torch.common.config import _env_on

HOROVOD_CKPT_DIR = "HOROVOD_CKPT_DIR"
HOROVOD_CKPT_EVERY = "HOROVOD_CKPT_EVERY"
HOROVOD_CKPT_RESUME = "HOROVOD_CKPT_RESUME"


def _map_tensors(x: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """`x` with every tensor in its dicts, lists and tuples replaced by
    fn(tensor)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return type(x)((k, _map_tensors(v, fn)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        out = [_map_tensors(v, fn) for v in x]
        return out if isinstance(x, list) else type(x)(out)
    return x


def _to_cpu(x: Any) -> Any:
    return _map_tensors(x, lambda t: t.cpu())


class State:
    """Base elastic state (reference: common/elastic.py:99)."""

    def __init__(self, **kwargs):
        self._reset_callbacks: List[Callable[[], None]] = []
        self._known_attrs = set()
        for k, v in kwargs.items():
            setattr(self, k, v)
            self._known_attrs.add(k)
        self.commit()

    def register_reset_callbacks(self, callbacks) -> None:
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        for cb in self._reset_callbacks:
            cb()

    # -- to be specialized --------------------------------------------------
    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def to_host(self) -> None:
        """Move the committed snapshot to host memory (the elastic reset
        calls it before it leaves the process group)."""

    def check_host_updates(self) -> None:
        """Raise HostsUpdatedInterrupt if the driver announced a new
        round (reference: State._handle_host_updates)."""
        from horovod_tpu_torch.elastic import worker as worker_mod
        n = worker_mod.get_notifier()
        if n is not None:
            n.check()

    def commit(self) -> None:
        """Snapshot the current values, then surface any pending host
        update (reference: State.commit = save + check_host_updates)."""
        self.save()
        self.check_host_updates()


class ObjectState(State):
    """State of picklable attributes (reference: common/elastic.py
    ObjectState). save() deep-copies; sync() broadcasts rank 0's values
    with broadcast_object."""

    def __init__(self, **kwargs):
        self._saved: Dict[str, Any] = {}
        super().__init__(**kwargs)

    def _values(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._known_attrs}

    def save(self) -> None:
        self._saved = copy.deepcopy(self._values())

    def restore(self) -> None:
        for k, v in copy.deepcopy(self._saved).items():
            setattr(self, k, v)

    def sync(self) -> None:
        from horovod_tpu_torch.optim.functions import broadcast_object
        synced = broadcast_object(self._values(), root_rank=0)
        for k, v in synced.items():
            setattr(self, k, v)
            self._known_attrs.add(k)
        self.save()

    def to_host(self) -> None:
        self._saved = _to_cpu(self._saved)

    # -- the last COMMITTED snapshot as a checkpoint payload ----------------
    def _ckpt_payload(self):
        """(tree, objects) of the last commit: never live values (a
        mid-step save must not capture uncommitted state)."""
        return {"trees": {}}, dict(self._saved)

    def _ckpt_adopt(self, tree: Any, objects: Dict[str, Any]) -> None:
        """Install a restored payload as the commit and the live
        values."""
        for k, v in (objects or {}).items():
            self._saved[k] = v
            self._known_attrs.add(k)
        self.restore()


class CheckpointableState:
    """Mixin tying an elastic state to a ``ckpt.AsyncCheckpointer``: the
    checkpoint cadence (HOROVOD_CKPT_EVERY), rank 0's disk-vs-memory
    resume probe, and the attach plumbing. The subclass supplies
    ``_ckpt_payload() -> (tree, objects)`` and ``_ckpt_adopt(tree,
    objects)``, both over the last COMMITTED snapshot."""

    _ckpt = None
    every_n = 0
    last_resume_source: Optional[str] = None

    def _init_checkpointer(self, checkpointer: Any = None,
                           root: Optional[str] = None) -> None:
        self._ckpt = checkpointer
        if self._ckpt is None:
            root = root or os.environ.get(HOROVOD_CKPT_DIR, "")
            if root:
                from horovod_tpu_torch.ckpt import AsyncCheckpointer
                self._ckpt = AsyncCheckpointer(root)
        try:
            self.every_n = max(
                0, int(os.environ.get(HOROVOD_CKPT_EVERY, "") or 0))
        except ValueError:
            self.every_n = 0

    @property
    def checkpointer(self):
        return self._ckpt

    def attach_checkpointer(self, ckpt) -> None:
        self._ckpt = ckpt

    def checkpoint(self, block: bool = False) -> bool:
        """Async-save the last commit()'s snapshot at this step
        boundary. Returns the checkpointer's accepted/skipped verdict
        (False also when no checkpointer is attached)."""
        if self._ckpt is None:
            return False
        tree, objects = self._ckpt_payload()
        step = int(objects.get("step", getattr(self, "step", 0)) or 0)
        return self._ckpt.save(step, tree, objects=objects, block=block)

    def maybe_checkpoint(self) -> bool:
        """checkpoint() every HOROVOD_CKPT_EVERY steps of the state's
        ``step`` (a no-op when the knob is unset)."""
        if self._ckpt is None or self.every_n <= 0:
            return False
        if int(getattr(self, "step", 0) or 0) % self.every_n != 0:
            return False
        return self.checkpoint()

    def maybe_resume(self) -> bool:
        """Rank 0's restore probe: True when it restored from disk.
        ``last_resume_source`` records the decision ("checkpoint",
        "memory" or None)."""
        self.last_resume_source = None
        if self._ckpt is None or not _env_on(HOROVOD_CKPT_RESUME, True):
            return False
        from horovod_tpu_torch.core import topology
        if topology.rank_or_none() not in (None, 0):
            return False  # followers adopt rank 0's state via sync()
        from horovod_tpu_torch.ckpt import manifest as _mf
        latest = _mf.latest_committed(self._ckpt.root)
        if latest is None:
            return False
        gen, disk_step = latest
        mem_step = int(getattr(self, "step", 0) or 0)
        if disk_step <= mem_step:
            # a survivor: memory is at least as fresh as disk
            from horovod_tpu_torch.ckpt.async_ckpt import flight_event
            flight_event(f"restore step={mem_step} gen={gen} "
                         f"source=memory")
            self.last_resume_source = "memory"
            return False
        # No `like`: a fresh process may hold no optimizer state yet, and
        # every leaf of the port's payload is dict-addressed.
        got = self._ckpt.restore_latest()
        if got is None:
            return False
        self._ckpt_adopt(got.tree, got.objects)
        self.last_resume_source = "checkpoint"
        return True


# ---------------------------------------------------------------- torch

class StateHandler:
    """Save/restore/sync strategy for one stateful object (reference:
    torch/elastic/state.py:71). Register new types with
    set_handler_registry."""

    _saved = None

    def __init__(self, value):
        self.value = value

    def set_value(self, value):
        """Rebind the handler to a new object and snapshot it (reference:
        torch/elastic/state.py:66-69), so `state.sampler = new_sampler`
        keeps commit/restore/sync on the live object."""
        self.value = value
        self.save()

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError


class ModelStateHandler(StateHandler):
    def save(self):
        self._saved = {k: v.detach().clone() if isinstance(v, torch.Tensor)
                       else copy.deepcopy(v)
                       for k, v in self.value.state_dict().items()}

    def restore(self):
        if self._saved is not None:
            # load_state_dict copies into the live tensors
            self.value.load_state_dict(self._saved)

    def sync(self):
        from horovod_tpu_torch.optim.functions import broadcast_parameters
        broadcast_parameters(self.value.state_dict(), root_rank=0)


class OptimizerStateHandler(StateHandler):
    def save(self):
        self._saved = copy.deepcopy(self.value.state_dict())

    def restore(self):
        if self._saved is not None:
            # a copy: load_state_dict keeps a tensor already on the
            # parameter's device and dtype, and the next step would
            # write into the commit
            self.value.load_state_dict(copy.deepcopy(self._saved))
        abandon = getattr(self.value, "abandon_step", None)
        if abandon is not None:  # a DistributedOptimizer mid-step
            abandon()

    def sync(self):
        from horovod_tpu_torch.optim.functions import \
            broadcast_optimizer_state
        broadcast_optimizer_state(self.value, root_rank=0)


class SamplerStateHandler(StateHandler):
    def save(self):
        self._saved = copy.deepcopy(self.value.state_dict())

    def restore(self):
        if self._saved is not None:
            self.value.load_state_dict(copy.deepcopy(self._saved))

    def sync(self):
        # the sampler's own sync merges processed indices across the
        # (possibly changed) world and re-shards the remainder
        self.value.sync()


def _default_registry():
    from horovod_tpu_torch.optim.optimizer import DistributedOptimizer
    return [
        (torch.nn.Module, ModelStateHandler),
        (torch.optim.Optimizer, OptimizerStateHandler),
        (DistributedOptimizer, OptimizerStateHandler),
        (ElasticSampler, SamplerStateHandler),
    ]


_handler_registry: Optional[List] = None


def get_handler_registry():
    global _handler_registry
    if _handler_registry is None:
        _handler_registry = _default_registry()
    return _handler_registry


def set_handler_registry(registry) -> None:
    global _handler_registry
    _handler_registry = list(registry)


def _get_handler(value) -> Optional[StateHandler]:
    for typ, cls in get_handler_registry():
        if isinstance(value, typ):
            return cls(value)
    return None


class _TensorRef:
    """Where a tensor of a handler's snapshot went in the checkpoint
    tree."""

    __slots__ = ("key",)

    def __init__(self, key: str):
        self.key = key


def _split(x: Any, tensors: Dict[str, torch.Tensor], path=()) -> Any:
    """`x` with each tensor moved into `tensors` under its path joined
    by "." and replaced by a _TensorRef."""
    if isinstance(x, torch.Tensor):
        key = ".".join(str(p) for p in path)
        if key in tensors:
            raise ValueError(f"two tensors of one elastic state snapshot "
                             f"share the checkpoint key {key!r}")
        tensors[key] = x
        return _TensorRef(key)
    if isinstance(x, dict):
        return type(x)((k, _split(v, tensors, path + (k,)))
                       for k, v in x.items())
    if isinstance(x, (list, tuple)):
        out = [_split(v, tensors, path + (i,)) for i, v in enumerate(x)]
        return out if isinstance(x, list) else type(x)(out)
    return copy.deepcopy(x)


def _join(x: Any, tensors: Dict[str, Any]) -> Any:
    """The inverse of _split."""
    if isinstance(x, _TensorRef):
        return tensors[x.key]
    if isinstance(x, dict):
        return type(x)((k, _join(v, tensors)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        out = [_join(v, tensors) for v in x]
        return out if isinstance(x, list) else type(x)(out)
    return x


class TorchState(CheckpointableState, ObjectState):
    """In-memory commits of torch models, optimizers and samplers
    (reference: torch/elastic/state.py:27-110): commit() snapshots state
    dicts; restore() rolls back; sync() broadcasts rank 0's weights and
    optimizer state so joining workers pick up the survivors' progress.

    An extra kwarg whose value matches the handler registry (samplers,
    more modules or optimizers, user-registered types) is managed by its
    handler; plain values fall through to ObjectState. With a
    checkpointer attached (``checkpointer=``/``root=`` or
    HOROVOD_CKPT_DIR), checkpoint()/maybe_checkpoint() persist the last
    commit, and sync() runs rank 0's resume probe before the
    broadcast."""

    def __init__(self, model=None, optimizer=None, checkpointer=None,
                 root=None, **kwargs):
        # model/optimizer go through the same handler mechanism as extra
        # kwargs (reference: torch/elastic/state.py:27-44), so
        # __setattr__ rebinds them too when the user swaps the object.
        self._handlers: Dict[str, StateHandler] = {}
        self._init_checkpointer(checkpointer=checkpointer, root=root)
        self.model = model
        self.optimizer = optimizer
        if model is not None:
            self._handlers["model"] = ModelStateHandler(model)
        if optimizer is not None:
            self._handlers["optimizer"] = OptimizerStateHandler(optimizer)
        plain = {}
        for k, v in kwargs.items():
            h = _get_handler(v)
            if h is not None:
                # set the attribute BEFORE registering the handler so the
                # first assignment does not save twice
                setattr(self, k, v)
                self._handlers[k] = h
            else:
                plain[k] = v
        super().__init__(**plain)
        self._known_attrs -= {"model", "optimizer"}
        self._known_attrs -= set(self._handlers)

    def __setattr__(self, name, value):
        # Reassigning a handler-managed attribute rebinds the handler and
        # saves (reference torch/elastic/state.py:66-69). `.get` via
        # __dict__ keeps __init__'s pre-_handlers assignments plain.
        handlers = self.__dict__.get("_handlers")
        if handlers is not None:
            if name in handlers:
                if value is None:
                    del handlers[name]  # as at init: None -> unmanaged
                else:
                    handlers[name].set_value(value)
            elif name in ("model", "optimizer") and value is not None:
                # assigned after construction: becomes managed
                cls = (ModelStateHandler if name == "model"
                       else OptimizerStateHandler)
                h = cls(value)
                h.save()
                handlers[name] = h
        object.__setattr__(self, name, value)

    def save(self) -> None:
        for h in self._handlers.values():
            h.save()
        super().save()

    def restore(self) -> None:
        for h in self._handlers.values():
            h.restore()
        super().restore()

    def sync(self) -> None:
        # Resume probe BEFORE the broadcast: a restored rank 0
        # broadcasts the checkpoint's weights, survivors their memory.
        self.maybe_resume()
        for h in self._handlers.values():
            h.sync()
        super().sync()

    def to_host(self) -> None:
        for h in self._handlers.values():
            h._saved = _to_cpu(h._saved)
        super().to_host()

    # ---- CheckpointableState hooks (last COMMITTED snapshot only) ----
    def _ckpt_payload(self):
        trees: Dict[str, Dict[str, torch.Tensor]] = {}
        skeletons = {}
        for name, h in self._handlers.items():
            if h._saved is None:
                continue
            tensors: Dict[str, torch.Tensor] = {}
            skeletons[name] = _split(h._saved, tensors)
            trees[name] = tensors
        objects: Dict[str, Any] = dict(self._saved)
        objects["__handlers__"] = skeletons
        return {"trees": trees}, objects

    def _ckpt_adopt(self, tree: Any, objects: Dict[str, Any]) -> None:
        objects = dict(objects or {})
        trees = (tree or {}).get("trees", {})
        for name, skeleton in objects.pop("__handlers__", {}).items():
            h = self._handlers.get(name)
            if h is not None:
                h._saved = _join(skeleton, trees.get(name, {}))
        super()._ckpt_adopt(tree, objects)


class TrainLoopState(TorchState):
    """The exactly-once elastic resume unit: model, optimizer, the step
    counter, the epoch, the data-stream cursor (records consumed this
    epoch) and an RNG slot, tied to a ``ckpt.AsyncCheckpointer`` so that
    elastic rounds resume from the newest COMMITTED checkpoint instead
    of restarting the epoch (see the module docstring)."""

    def __init__(self, model=None, optimizer=None, step: int = 0,
                 epoch: int = 0, cursor: int = 0, rng: Any = None,
                 checkpointer: Any = None, root: Optional[str] = None,
                 **kwargs):
        super().__init__(model=model, optimizer=optimizer,
                         checkpointer=checkpointer, root=root, step=step,
                         epoch=epoch, cursor=cursor, rng=rng, **kwargs)

    def record_batch(self, records: int) -> None:
        """Advance the data-stream cursor by `records` consumed RECORDS
        (the batch's length, not 1: the cursor is the record offset that
        ``apply_to_loader`` hands to ``ShardedDataset.skip_to``)."""
        self.cursor = int(self.cursor) + int(records)

    def apply_to_loader(self, loader) -> None:
        """Point a data/ loader at this state's position: epoch first
        (reshuffle), then skip the consumed records; a mid-epoch resume
        never replays a batch."""
        loader.set_epoch(int(self.epoch))
        skip = getattr(loader, "skip_to", None)
        if skip is not None:
            skip(int(self.cursor))

    def next_epoch(self) -> None:
        self.epoch = int(self.epoch) + 1
        self.cursor = 0


class ElasticSampler:
    """Rank-sharded sampler with mid-epoch resume (reference:
    torch/elastic/sampler.py). It tracks processed indices; after a
    topology change, `sync` re-shards only the REMAINING indices over
    the new world, so no sample is dropped or repeated within the epoch.
    Duck-types torch.utils.data.Sampler (iter/len/set_epoch)."""

    def __init__(self, dataset, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: List[int] = []
        self._reshard()

    @staticmethod
    def _rank_size():
        from horovod_tpu_torch.core import topology
        return topology.rank(), topology.size()

    def _reshard(self) -> None:
        n = len(self.dataset)
        remaining = sorted(set(range(n)) - set(self.processed_indices))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(remaining)
        r, k = self._rank_size()
        # Drop the tail so every rank sees the same number of batches
        # (reference: num_samples = len(remaining) // num_replicas).
        per_rank = len(remaining) // k
        self.indices = remaining[r * per_rank:(r + 1) * per_rank]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.processed_indices = []
        self._reshard()

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        """Mark this rank's slice of the batch as processed."""
        start = batch_idx * batch_size
        self.processed_indices.extend(
            self.indices[start:start + batch_size])

    def sync(self) -> None:
        """Union the processed indices across ranks and re-shard the
        remainder over the (possibly new) world."""
        from horovod_tpu_torch.optim.functions import allgather_object
        union: set = set()
        for p in allgather_object(self.processed_indices):
            union.update(p)
        self.processed_indices = sorted(union)
        self._reshard()

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.epoch = sd["epoch"]
        self.processed_indices = list(sd["processed_indices"])
        self._reshard()

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch,
                "processed_indices": list(self.processed_indices)}

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices)

    def __len__(self) -> int:
        return len(self.indices)
