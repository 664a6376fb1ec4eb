"""MXNet frontend of the port (counterpart of
horovod_tpu/frontends/mxnet.py): an import-gated NDArray shim over the
port's collectives.

Reference: horovod/mxnet/__init__.py + mxnet/mpi_ops.cc — collectives
over mx.nd.NDArray, `DistributedOptimizer` wrapping an
mx.optimizer.Optimizer (allreduce inside update/update_multi_precision,
mxnet/__init__.py:44), `DistributedTrainer` wrapping gluon.Trainer
(_allreduce_grads override, :124), and broadcast_parameters (:245).

An NDArray crosses the boundary as numpy and becomes a torch tensor on
`hvd.device()`; the collective's result comes back as an NDArray of the
input's context, dtype and shape. MXNet itself never talks to the card
the port owns.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from horovod_tpu_torch.common import types as T
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.core.process_sets import ProcessSet
from horovod_tpu_torch.ops import collectives as C

# Re-exported basics (reference: mxnet/__init__.py pulls these from
# common.basics).
from horovod_tpu_torch.core.topology import (  # noqa: F401
    cross_rank, cross_size, init, is_initialized, local_rank, local_size,
    rank, shutdown, size)
from horovod_tpu_torch.core.join import join  # noqa: F401

Average = T.ReduceOp.AVERAGE
Sum = T.ReduceOp.SUM
Adasum = T.ReduceOp.ADASUM
Min = T.ReduceOp.MIN
Max = T.ReduceOp.MAX
Product = T.ReduceOp.PRODUCT


def _mx():
    try:
        import mxnet
        return mxnet
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.frontends.mxnet requires mxnet (reference "
            "extra: horovod[mxnet])") from e


def _is_nd(t) -> bool:
    return hasattr(t, "asnumpy") and hasattr(t, "context")


def _to_torch(t) -> torch.Tensor:
    a = t.asnumpy() if _is_nd(t) else np.asarray(t)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(
        topology.device())


def _like(x: torch.Tensor, ref, keep_shape: bool = False):
    """The collective's output as an NDArray on `ref`'s context in its
    dtype (numpy when `ref` is not an NDArray)."""
    arr = np.ascontiguousarray(x.detach().cpu().numpy())
    if not _is_nd(ref):
        return arr
    if keep_shape and tuple(arr.shape) != tuple(ref.shape):
        arr = arr.reshape(ref.shape)
    return _mx().nd.array(arr, ctx=ref.context, dtype=ref.dtype)


# ----------------------------------------------------------------------
# collectives (reference: mxnet/mpi_ops.py surface)
# ----------------------------------------------------------------------

def allreduce(tensor, average: Optional[bool] = None, name=None, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None):
    out = C.allreduce(_to_torch(tensor), average=average, name=name, op=op,
                      prescale_factor=prescale_factor,
                      postscale_factor=postscale_factor,
                      process_set=process_set)
    return _like(out, tensor, keep_shape=True)


def allreduce_(tensor, **kw):
    tensor[:] = allreduce(tensor, **kw)
    return tensor


def grouped_allreduce(tensors: List[Any], **kw):
    outs = C.grouped_allreduce([_to_torch(t) for t in tensors], **kw)
    return [_like(o, t, keep_shape=True) for o, t in zip(outs, tensors)]


def broadcast(tensor, root_rank: int, name=None,
              process_set: Optional[ProcessSet] = None):
    out = C.broadcast(_to_torch(tensor), root_rank=root_rank, name=name,
                      process_set=process_set)
    return _like(out, tensor, keep_shape=True)


def broadcast_(tensor, root_rank: int, **kw):
    tensor[:] = broadcast(tensor, root_rank, **kw)
    return tensor


def allgather(tensor, name=None,
              process_set: Optional[ProcessSet] = None):
    return _like(C.allgather(_to_torch(tensor), name=name,
                             process_set=process_set), tensor)


def alltoall(tensor, splits=None, name=None,
             process_set: Optional[ProcessSet] = None):
    """(output, received splits as int64 numpy)."""
    sp = None if splits is None else [
        int(s) for s in (splits.asnumpy() if _is_nd(splits)
                         else np.asarray(splits))]
    out, recv = C.alltoall(_to_torch(tensor), splits=sp, name=name,
                           process_set=process_set)
    return _like(out, tensor), recv.cpu().numpy()


def barrier(process_set: Optional[ProcessSet] = None):
    C.barrier(process_set=process_set)


def broadcast_object(obj, root_rank: int = 0, name=None):
    from horovod_tpu_torch.optim.functions import broadcast_object as _bo
    return _bo(obj, root_rank=root_rank, name=name)


# ----------------------------------------------------------------------
# parameters (reference: mxnet/__init__.py:245 broadcast_parameters)
# ----------------------------------------------------------------------

def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Broadcast a dict of NDArrays or a gluon ParameterDict in place."""
    if not hasattr(params, "items"):
        raise ValueError("params must be a dict or gluon ParameterDict")
    for name, p in sorted(params.items()):
        if hasattr(p, "list_data"):  # gluon Parameter: sync every context
            for i, d in enumerate(p.list_data()):
                broadcast_(d, root_rank, name=f"{name}.{i}")
        elif p is not None:
            broadcast_(p, root_rank, name=name)


# ----------------------------------------------------------------------
# optimizers (reference: mxnet/__init__.py:44 DistributedOptimizer,
# :124 DistributedTrainer)
# ----------------------------------------------------------------------

class DistributedOptimizer:
    """Wraps an mx.optimizer.Optimizer: gradients are allreduced before
    every update, with gradient_predivide_factor split into pre/post
    scaling exactly like the reference."""

    def __init__(self, optimizer, gradient_predivide_factor: float = 1.0,
                 op=Average, process_set: Optional[ProcessSet] = None,
                 num_groups: int = 0):
        if gradient_predivide_factor != 1.0 and op != Average:
            raise ValueError(
                "gradient_predivide_factor not supported with op != "
                "Average")
        self._optimizer = optimizer
        self._op = op
        self._predivide = float(gradient_predivide_factor)
        self._process_set = process_set
        self._num_groups = num_groups

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def _scales(self):
        k = (self._process_set.size() if self._process_set
             else topology.size()) or 1
        if self._op == Average and self._predivide != 1.0:
            return (1.0 / self._predivide, self._predivide / k, Sum)
        return 1.0, 1.0, self._op

    def _do_allreduce(self, index, grad):
        pre, post, op = self._scales()
        if isinstance(index, (tuple, list)):
            outs = grouped_allreduce(list(grad), op=op,
                                     prescale_factor=pre,
                                     postscale_factor=post,
                                     process_set=self._process_set)
            for g, o in zip(grad, outs):
                g[:] = o
        else:
            allreduce_(grad, op=op, prescale_factor=pre,
                       postscale_factor=post,
                       process_set=self._process_set)

    def update(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update(index, weight, grad, state)

    def update_multi_precision(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update_multi_precision(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self._optimizer.set_lr_mult(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self._optimizer.set_wd_mult(args_wd_mult)


class DistributedTrainer:
    """gluon Trainer wrapper (reference: mxnet/__init__.py:124): divides
    the apply scale by the world size and sums gradients across ranks in
    _allreduce_grads, so the update sees their average. No gluon import
    happens until instantiation."""

    def __new__(cls, params, optimizer, optimizer_params=None, **kwargs):
        mx = _mx()

        class _Trainer(mx.gluon.Trainer):
            def __init__(self):
                super().__init__(params, optimizer,
                                 optimizer_params, kvstore=None, **kwargs)
                self._scale /= (topology.size() or 1)

            def _allreduce_grads(self):
                for i, param in enumerate(self._params):
                    if param.grad_req != "null":
                        outs = [allreduce(g, average=False,
                                          name=f"gradient_{i}")
                                for g in param.list_grad()]
                        for g, o in zip(param.list_grad(), outs):
                            g[:] = o

        return _Trainer()
