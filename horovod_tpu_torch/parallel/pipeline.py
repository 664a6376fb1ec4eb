"""Pipeline parallelism: the GPipe microbatch schedule over the `pp`
axis (counterpart of horovod_tpu/parallel/pipeline.py).

The schedule is the JAX one, tick for tick: `n_micro + P − 1` ticks;
at tick t stage 0 takes microbatch min(t, n_micro − 1), every other
stage what the stage before it sent at tick t − 1, and every stage runs
`stage_fn` on what it holds, bubble ticks included; the last stage emits
microbatch t − (P − 1), the others zeros. Activations hop stage to stage
by `ring_shift` over `pp` (parallel/comm.py), whose backward shifts the
cotangent back, so autograd runs the reverse schedule.

Every rank builds the same graph, as the JAX scan does: the injection
and the emission are `torch.where`s on the stage, not Python branches.
That keeps every shift's backward reachable from the loss on every rank
(a stage that dropped its input from the graph would skip its half of a
backward exchange, and its neighbour would wait forever). The hop after
the last tick, whose result JAX's scan discards, is not made at all.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from horovod_tpu_torch.parallel.comm import ring_shift
from horovod_tpu_torch.parallel.mesh import axis_index, axis_sizes


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor,
                   axis_name: str = "pp") -> torch.Tensor:
    """Run microbatches through the pipeline; returns the last stage's
    outputs.

    stage_fn(stage_params, act) -> act (same shape), applied by every
    stage to the activation it holds; stage_params is this stage's
    share of the parameters. x_micro: (n_micro, *act_shape), stage 0's
    input microbatches (other stages pass a tensor of the same shape,
    whose values they ignore).

    Returns (n_micro, *act_shape): on the last stage the pipeline's
    outputs in microbatch order, on the others zeros. Reduce or select
    over `pp` afterwards (the LM masks its loss to the last stage)."""
    P = axis_sizes()[axis_name]
    stage = axis_index(axis_name)
    n_micro = x_micro.shape[0]
    first = torch.tensor(stage == 0, device=x_micro.device)
    last = torch.tensor(stage == P - 1, device=x_micro.device)
    held = torch.zeros_like(x_micro[0])
    emitted = []
    for t in range(n_micro + P - 1):
        cur = torch.where(first, x_micro[min(t, n_micro - 1)], held)
        out = stage_fn(stage_params, cur)
        if t >= P - 1:
            emitted.append(torch.where(last, out, torch.zeros_like(out)))
        if t < n_micro + P - 2:
            held = ring_shift(out, axis_name)
    return torch.stack(emitted)
