"""Training-loop callbacks (counterpart of horovod_tpu/optim/callbacks.py,
Horovod's Keras callbacks for a plain loop).

A loop calls the hooks (on_train_begin, on_epoch_begin, on_batch_end,
on_epoch_end) with one `state` dict, under the JAX package's keys:
- "params": a model's `state_dict()` or `named_parameters()`;
- "opt_state": a `torch.optim.Optimizer` (or a DistributedOptimizer);
- "metrics": a dict of scalars; "lr": the learning rate the schedule
  set; "steps_per_epoch": batches an epoch, for schedules that move
  within an epoch.
The learning-rate callbacks set state["lr"] and, where "opt_state" is
an optimizer, the "lr" of each of its param groups.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from horovod_tpu_torch.common import types as T
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.core.process_sets import ProcessSet
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.optim.functions import (broadcast_optimizer_state,
                                               broadcast_parameters)


class Callback:
    def on_train_begin(self, state: Dict[str, Any]) -> None: ...
    def on_epoch_begin(self, epoch: int, state: Dict[str, Any]) -> None: ...
    def on_batch_end(self, batch: int, state: Dict[str, Any]) -> None: ...
    def on_epoch_end(self, epoch: int, state: Dict[str, Any]) -> None: ...


class BroadcastGlobalVariablesCallback(Callback):
    """At the start of training, give every rank the root's parameters
    (in place) and optimizer state."""

    def __init__(self, root_rank: int = 0,
                 process_set: Optional[ProcessSet] = None):
        self.root_rank = root_rank
        self.process_set = process_set

    def on_train_begin(self, state: Dict[str, Any]) -> None:
        if state.get("params") is not None:
            broadcast_parameters(state["params"], root_rank=self.root_rank,
                                 process_set=self.process_set)
        if state.get("opt_state") is not None:
            broadcast_optimizer_state(state["opt_state"],
                                      root_rank=self.root_rank,
                                      process_set=self.process_set)


class MetricAverageCallback(Callback):
    """At the end of each epoch, replace every metric in
    state["metrics"] by its average over the ranks (float64)."""

    def __init__(self, process_set: Optional[ProcessSet] = None):
        self.process_set = process_set

    def on_epoch_end(self, epoch: int, state: Dict[str, Any]) -> None:
        metrics = state.get("metrics")
        if not metrics:
            return
        keys = sorted(metrics)
        vec = torch.tensor([float(metrics[k]) for k in keys],
                           dtype=torch.float64, device=topology.device())
        avg = collectives.allreduce(vec, op=T.ReduceOp.AVERAGE,
                                    process_set=self.process_set)
        for k, v in zip(keys, avg.tolist()):
            metrics[k] = float(v)


def _set_lr(opt, lr: float, momentum_correction: bool) -> None:
    """Every param group's lr to `lr`. Torch's SGD applies lr to the
    whole momentum buffer (p -= lr·buf), which is what Keras's momentum
    correction achieves for its v = m·v - lr·g form; without the
    correction, the buffers are rescaled by old/new so that the step
    follows the uncorrected form."""
    for group in opt.param_groups:
        old = group["lr"]
        if not momentum_correction and old != lr and lr != 0:
            for p in group["params"]:
                buf = opt.state.get(p, {}).get("momentum_buffer")
                if buf is not None:
                    buf.mul_(old / lr)
        group["lr"] = lr


class LearningRateScheduleCallback(Callback):
    """lr = initial_lr · multiplier(epoch) for epochs in [start_epoch,
    end_epoch): at each epoch's start with `staircase`, else after each
    batch at the fractional epoch."""

    def __init__(self, initial_lr: float, multiplier,
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True,
                 momentum_correction: bool = True):
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        if not callable(multiplier):
            self._mult = lambda epoch: multiplier
        else:
            self._mult = multiplier
        self._current_epoch = 0

    def on_epoch_begin(self, epoch: int, state: Dict[str, Any]) -> None:
        self._current_epoch = epoch
        if self.staircase:
            self._apply(epoch, state)

    def on_batch_end(self, batch: int, state: Dict[str, Any]) -> None:
        if not self.staircase:
            steps = state.get("steps_per_epoch", 1)
            self._apply(self._current_epoch + batch / float(steps), state)

    def _apply(self, epoch: float, state: Dict[str, Any]) -> None:
        if epoch < self.start_epoch:
            return
        if self.end_epoch is not None and epoch >= self.end_epoch:
            return
        state["lr"] = self.initial_lr * self._mult(epoch)
        opt = state.get("opt_state")
        if opt is not None and hasattr(opt, "param_groups"):
            _set_lr(opt, state["lr"], self.momentum_correction)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual warm-up from initial_lr to initial_lr · size over
    `warmup_epochs` ("Accurate, Large Minibatch SGD")."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 momentum_correction: bool = True, steps_per_epoch=None,
                 verbose: bool = False):
        size = topology.size() if topology.is_initialized() else 1
        self.warmup_epochs = warmup_epochs

        def multiplier(epoch):
            frac = min(1.0, (epoch + 1) / float(warmup_epochs))
            return 1.0 / size * (frac * (size - 1) + 1)

        super().__init__(initial_lr=initial_lr * size, multiplier=multiplier,
                         start_epoch=0, end_epoch=warmup_epochs,
                         staircase=False,
                         momentum_correction=momentum_correction)


class CommitStateCallback(Callback):
    """state_obj.commit() every `batches_per_commit` batches (any object
    with commit(), such as an elastic state)."""

    def __init__(self, state_obj, batches_per_commit: int = 1):
        self.state_obj = state_obj
        self.batches_per_commit = batches_per_commit

    def on_batch_end(self, batch: int, state: Dict[str, Any]) -> None:
        if (batch + 1) % self.batches_per_commit == 0:
            self.state_obj.commit()


class UpdateBatchStateCallback(Callback):
    """Keep state_obj.batch and .epoch current, so that a worker that
    rejoins resumes mid-epoch."""

    def __init__(self, state_obj):
        self.state_obj = state_obj

    def on_batch_end(self, batch: int, state: Dict[str, Any]) -> None:
        self.state_obj.batch = batch

    def on_epoch_end(self, epoch: int, state: Dict[str, Any]) -> None:
        self.state_obj.epoch = epoch
        self.state_obj.batch = 0


class CallbackList:
    """Calls each hook on every callback, in order."""

    def __init__(self, callbacks: List[Callback]):
        self.callbacks = list(callbacks)

    def __getattr__(self, hook):
        if not hook.startswith("on_"):
            raise AttributeError(hook)

        def dispatch(*args, **kwargs):
            for cb in self.callbacks:
                getattr(cb, hook)(*args, **kwargs)

        return dispatch
