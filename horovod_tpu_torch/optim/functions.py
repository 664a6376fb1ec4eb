"""State broadcast helpers (counterpart of horovod_tpu/optim/functions.py
broadcast_parameters and broadcast_optimizer_state)."""

from __future__ import annotations

from typing import Iterable, Mapping, Tuple, Union

import torch

from horovod_tpu_torch.ops import collectives

Params = Union[Mapping[str, torch.Tensor], Iterable[Tuple[str, torch.Tensor]]]


@torch.no_grad()
def broadcast_parameters(params: Params, root_rank: int = 0) -> None:
    """Overwrite every tensor of `params` (a state_dict or
    named_parameters()) with the root rank's, in place."""
    items = params.items() if isinstance(params, Mapping) else params
    for _name, t in sorted(items, key=lambda kv: kv[0]):
        if t.is_contiguous():
            collectives.broadcast_(t.data, root_rank)
        else:
            t.copy_(collectives.broadcast_(t.contiguous(), root_rank))


@torch.no_grad()
def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Give every rank the root rank's optimizer state: each state tensor
    in place, and the numeric hyperparameters of each param group."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            for v in optimizer.state.get(p, {}).values():
                if torch.is_tensor(v):
                    collectives.broadcast_(v, root_rank)
        keys = sorted(k for k, v in group.items()
                      if isinstance(v, (int, float))
                      and not isinstance(v, bool))
        if keys:
            dev = group["params"][0].device
            vals = torch.tensor([float(group[k]) for k in keys],
                                dtype=torch.float64, device=dev)
            collectives.broadcast_(vals, root_rank)
            for k, v in zip(keys, vals.tolist()):
                group[k] = type(group[k])(v)
