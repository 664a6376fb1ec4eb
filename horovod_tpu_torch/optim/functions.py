"""State broadcast and gather helpers (counterpart of
horovod_tpu/optim/functions.py broadcast_parameters, broadcast_object,
allgather_object, and of horovod_tpu/frontends/torch.py
broadcast_optimizer_state).

Objects travel as the reference's wire format: the pickled bytes' length
as one int64, then the bytes as uint8, both on `hvd.device()` (NCCL
moves CUDA tensors only). A tensor inside the object is pickled from
host memory and lands on the receiver's own device: a CUDA tensor on
`hvd.device()`, a CPU tensor on the CPU, so no rank touches another
rank's card.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Iterable, List, Mapping, Optional, Tuple, Union

import torch

from horovod_tpu_torch.core import topology
from horovod_tpu_torch.core.process_sets import ProcessSet
from horovod_tpu_torch.ops import collectives

Params = Union[Mapping[str, torch.Tensor], Iterable[Tuple[str, torch.Tensor]]]


@torch.no_grad()
def broadcast_parameters(params: Params, root_rank: int = 0,
                         process_set: Optional[ProcessSet] = None) -> None:
    """Overwrite every tensor of `params` (a state_dict or
    named_parameters()) with the root rank's, in place; each broadcast
    is named after its tensor, as in the reference."""
    items = params.items() if isinstance(params, Mapping) else params
    for name, t in sorted(items, key=lambda kv: kv[0]):
        if t.is_contiguous():
            collectives.broadcast_(t.data, root_rank, name=name,
                                   process_set=process_set)
        else:
            t.copy_(collectives.broadcast_(t.contiguous(), root_rank,
                                           name=name,
                                           process_set=process_set))


# TF-parity name (hvd.broadcast_variables), as in the JAX package.
broadcast_variables = broadcast_parameters


def _on_device(t: torch.Tensor) -> torch.Tensor:
    """A received CUDA tensor, placed on this rank's device."""
    return t.to(topology.device())


class _Pickler(pickle.Pickler):
    """Pickles a device tensor from its host copy, to be rebuilt on the
    receiver's device (`_on_device`)."""

    def reducer_override(self, obj):
        if torch.is_tensor(obj) and obj.device.type != "cpu":
            return _on_device, (obj.detach().cpu(),)
        return NotImplemented


def _dumps(obj: Any) -> torch.Tensor:
    """`obj` pickled, as a uint8 tensor on the collective's device."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return torch.frombuffer(bytearray(buf.getvalue()),
                            dtype=torch.uint8).to(topology.device())


def _loads(data: torch.Tensor) -> Any:
    return pickle.loads(data.cpu().numpy().tobytes())


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> Any:
    """The root rank's picklable `obj`, on every member of the set
    (root_rank is a global rank). Only members call it."""
    del name
    dev = topology.device()
    if topology.rank() == root_rank:
        buf = _dumps(obj)
    else:
        buf = torch.zeros(0, dtype=torch.uint8, device=dev)
    length = collectives.broadcast(
        torch.tensor([buf.numel()], dtype=torch.int64, device=dev),
        root_rank, process_set=process_set)
    n = int(length.item())
    if buf.numel() != n:
        buf = torch.zeros(n, dtype=torch.uint8, device=dev)
    return _loads(collectives.broadcast(buf, root_rank,
                                        process_set=process_set))


def allgather_object(obj: Any,
                     process_set: Optional[ProcessSet] = None) -> List[Any]:
    """Every member's picklable `obj`, in set order, through the uneven
    allgather of the payloads."""
    payload = _dumps(obj)
    gathered = collectives.allgather(payload, process_set=process_set)
    sizes = collectives.allgather(
        torch.tensor([payload.numel()], dtype=torch.int64,
                     device=payload.device), process_set=process_set)
    out, off = [], 0
    for s in sizes.tolist():
        out.append(_loads(gathered[off:off + s]))
        off += s
    return out


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              process_set: Optional[ProcessSet] = None
                              ) -> None:
    """Give every rank the root rank's optimizer state: its whole
    `state_dict()` (every state tensor and each param group's
    hyperparameters) broadcast as one object and loaded, so a rank that
    holds no state yet (it has not stepped) gets the root's. The
    optimizer's `load_state_dict` casts each state tensor to its
    parameter's device and dtype."""
    synced = broadcast_object(optimizer.state_dict(), root_rank=root_rank,
                              process_set=process_set)
    optimizer.load_state_dict(synced)
