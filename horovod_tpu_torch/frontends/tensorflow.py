"""TensorFlow frontend of the port: the `horovod.tensorflow` API over the
port's collectives (counterpart of horovod_tpu/frontends/tensorflow.py).

Reference: horovod/tensorflow/mpi_ops.py (collectives),
horovod/tensorflow/__init__.py `DistributedGradientTape` (:1125) /
`DistributedOptimizer` (:896) / `broadcast_variables`,
horovod/tensorflow/compression.py, horovod/_keras/callbacks.py.

A TF tensor crosses the boundary as numpy, becomes a torch tensor on
`hvd.device()` and goes through the port's collective (NCCL on the card,
gloo under `hvd.init(device="cpu")`); the result comes back as a TF
tensor of the input's dtype and, for the same-shape collectives, its
shape. bfloat16 travels as its bits (an int16 view): numpy holds TF's
bf16 as `ml_dtypes.bfloat16`, which `torch.from_numpy` does not take.
The reduction rules are the port's: an integer Average floors in its
dtype, and scale factors are cast to the tensor's dtype.

Graph mode (`tf.function`): each collective lowers to one
`tf.py_function` that re-enters the eager path at run time; it does not
compile under `jit_compile=True` (XLA cannot compile EagerPyFunc; keep
collective-bearing functions un-jitted). Within one traced graph every
collective is chained after the previous one by a control dependency,
so execution order equals trace order on every rank, whatever order
TF's scheduler would pick. py_function bodies run on TF's executor
threads, so each one makes the collective's card current
(`torch.cuda.device`) before it launches; the collectives wait on their
work through `guarded_wait`, as every wait of the port does.

    import horovod_tpu_torch.frontends.tensorflow as hvd
    hvd.init()
    tape = hvd.DistributedGradientTape(tape)
    hvd.broadcast_variables(model.variables, root_rank=0)
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Optional

import numpy as np
import torch

from horovod_tpu_torch.common import types as T
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.core.topology import (  # noqa: F401
    ccl_built, cross_rank, cross_size, cuda_built, ddl_built,
    gloo_built, gloo_enabled, init, is_homogeneous,
    is_initialized, local_rank, local_size, mpi_built, mpi_enabled,
    mpi_threads_supported, nccl_built, rank, rocm_built, shutdown,
    size, tpu_built,
)
from horovod_tpu_torch.core.join import join  # noqa: F401
from horovod_tpu_torch.core.process_sets import (  # noqa: F401
    ProcessSet, add_process_set, get_process_set, global_process_set,
    remove_process_set,
)
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.optim.functions import allgather_object  # noqa: F401

Average = T.ReduceOp.AVERAGE
Sum = T.ReduceOp.SUM
Adasum = T.ReduceOp.ADASUM
Min = T.ReduceOp.MIN
Max = T.ReduceOp.MAX
Product = T.ReduceOp.PRODUCT


def _tf():
    import tensorflow as tf
    return tf


class Compression:
    """Reference: tensorflow/compression.py — Compression.none/.fp16
    (fp16 casts floating tensors only)."""

    class none:
        @staticmethod
        def compress(tensor):
            return tensor, None

        @staticmethod
        def decompress(tensor, ctx):
            return tensor

    class fp16:
        @staticmethod
        def compress(tensor):
            tf = _tf()
            if tensor.dtype.is_floating:
                return tf.cast(tensor, tf.float16), tensor.dtype
            return tensor, None

        @staticmethod
        def decompress(tensor, ctx):
            return _tf().cast(tensor, ctx) if ctx is not None else tensor


# -- the boundary ----------------------------------------------------------

def _to_np(t) -> np.ndarray:
    tf = _tf()
    if isinstance(t, (tf.Tensor, tf.Variable)):
        return t.numpy()
    return np.asarray(t)


def _to_torch(t) -> torch.Tensor:
    """A TF tensor (or array-like) as a torch tensor on hvd.device()."""
    a = np.array(_to_np(t), copy=True, order="C")  # writable, owned
    if a.dtype.name == "bfloat16":
        x = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        x = torch.from_numpy(a)
    return x.to(topology.device())


def _from_torch(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_tf().bfloat16.as_numpy_dtype)
    return x.numpy()


def _like(x: torch.Tensor, ref, keep_shape: bool = False):
    """The collective's output as a TF tensor of `ref`'s dtype (and, with
    keep_shape, its shape)."""
    tf = _tf()
    out = tf.convert_to_tensor(_from_torch(x))
    ref_dtype = getattr(ref, "dtype", None)
    if ref_dtype is not None and out.dtype != ref_dtype:
        out = tf.cast(out, ref_dtype)
    if keep_shape:
        ref_shape = getattr(ref, "shape", None)
        if ref_shape is not None and tuple(out.shape) != tuple(ref_shape):
            out = tf.reshape(out, ref_shape)
    return out


def _on_card():
    """The collective's card made current on this thread (TF's executor
    threads run py_function bodies), or nothing on the host."""
    dev = topology.device()
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


# -- graph-mode (tf.function) bridge ---------------------------------------

def _in_graph() -> bool:
    return not _tf().executing_eagerly()


def _py_collective(eager_fn, inputs, out_dtypes):
    """One py_function op, control-dep-chained after the previous one in
    this graph. The chain anchor lives ON the graph object so its lifetime
    is the graph's own (a module-level map would pin every traced
    FuncGraph forever)."""
    tf = _tf()

    def body(*ts):
        with _on_card():
            return eager_fn(*ts)

    g = tf.compat.v1.get_default_graph()
    prev = getattr(g, "_hvd_torch_chain_anchor", None)
    dep = (tf.control_dependencies([prev]) if prev is not None
           else contextlib.nullcontext())
    with dep:
        out = tf.py_function(body, inputs, out_dtypes)
    g._hvd_torch_chain_anchor = out[0] if isinstance(out, (list, tuple)) \
        else out
    return out


def _same_shape(eager_fn, tensor):
    """A one-input collective whose output keeps the input's shape, in a
    graph."""
    out = _py_collective(eager_fn, [tensor], tensor.dtype)
    out.set_shape(tensor.shape)
    return out


def _grouped_in_graph(eager_fn, tensors, keep_shape: bool) -> List[Any]:
    outs = _py_collective(eager_fn, list(tensors),
                          [t.dtype for t in tensors])
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    if keep_shape:
        for o, t in zip(outs, tensors):
            o.set_shape(t.shape)
    return outs


# -- collectives -------------------------------------------------------------

def allreduce(tensor, average: Optional[bool] = None, name=None, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None):
    """Reference: hvd.allreduce (tensorflow/mpi_ops.py). Works eagerly and
    inside tf.function (py_function bridge)."""
    def _eager(t):
        out = C.allreduce(_to_torch(t), average=average, name=name, op=op,
                          prescale_factor=prescale_factor,
                          postscale_factor=postscale_factor,
                          process_set=process_set)
        return _like(out, t, keep_shape=True)

    return _same_shape(_eager, tensor) if _in_graph() else _eager(tensor)


def grouped_allreduce(tensors, average: Optional[bool] = None, name=None,
                      op=None, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: Optional[ProcessSet] = None) -> List[Any]:
    def _eager(*ts):
        outs = C.grouped_allreduce([_to_torch(t) for t in ts],
                                   average=average, op=op,
                                   prescale_factor=prescale_factor,
                                   postscale_factor=postscale_factor,
                                   process_set=process_set)
        return [_like(o, t, keep_shape=True) for o, t in zip(outs, ts)]

    if _in_graph() and tensors:
        return _grouped_in_graph(_eager, tensors, keep_shape=True)
    return _eager(*tensors)


def grouped_allgather(tensors, name=None,
                      process_set: Optional[ProcessSet] = None) -> List[Any]:
    """Reference: tensorflow/mpi_ops.py grouped_allgather. Works eagerly
    and inside tf.function (py_function bridge; output shapes are
    data-dependent on world size, so they stay unknown in-graph)."""
    def _eager(*ts):
        outs = C.grouped_allgather([_to_torch(t) for t in ts], name=name,
                                   process_set=process_set)
        return [_like(o, t) for o, t in zip(outs, ts)]

    if _in_graph() and tensors:
        return _grouped_in_graph(_eager, tensors, keep_shape=False)
    return _eager(*tensors)


def grouped_reducescatter(tensors, op=None,
                          process_set: Optional[ProcessSet] = None,
                          **kw) -> List[Any]:
    """Reference: tensorflow/mpi_ops.py grouped_reducescatter. Works
    eagerly and inside tf.function (py_function bridge)."""
    rop = op if op is not None else Average

    def _eager(*ts):
        outs = C.grouped_reducescatter([_to_torch(t) for t in ts], op=rop,
                                       process_set=process_set, **kw)
        return [_like(o, t) for o, t in zip(outs, ts)]

    if _in_graph() and tensors:
        return _grouped_in_graph(_eager, tensors, keep_shape=False)
    return _eager(*tensors)


# -- topology-as-tensor ops (reference: mpi_ops.py:576-659 — graph-time
# ops whose VALUE is evaluated at run time; topology is fixed per init,
# so constants carry the same contract) ------------------------------------

def size_op(process_set_id: int = 0, name=None):
    tf = _tf()
    k = get_process_set(process_set_id).size() if process_set_id \
        else size()
    return tf.constant(k, dtype=tf.int32, name=name)


def process_set_included_op(process_set_id: int = 0, name=None):
    tf = _tf()
    inc = get_process_set(process_set_id).included() if process_set_id \
        else True
    return tf.constant(int(inc), dtype=tf.int32, name=name)


def local_size_op(name=None):
    return _tf().constant(local_size(), dtype=_tf().int32, name=name)


def rank_op(name=None):
    return _tf().constant(rank(), dtype=_tf().int32, name=name)


def local_rank_op(name=None):
    return _tf().constant(local_rank(), dtype=_tf().int32, name=name)


def broadcast_(variables, root_rank: int, name=None,
               process_set: Optional[ProcessSet] = None):
    """In-place broadcast of tf.Variables (reference: mpi_ops.py:359)."""
    for v in variables:
        v.assign(broadcast(v, root_rank, name=name,
                           process_set=process_set))
    return variables


def broadcast_object_fn(root_rank: int = 0, session=None, name=None,
                        process_set: Optional[ProcessSet] = None):
    """Reference: functions.py:144 — returns a callable that broadcasts
    an arbitrary object (session is a TF1 relic, accepted and unused)."""
    def _fn(obj):
        return broadcast_object(obj, root_rank=root_rank, name=name,
                                process_set=process_set)
    return _fn


def broadcast(tensor, root_rank: int, name=None,
              process_set: Optional[ProcessSet] = None):
    def _eager(t):
        out = C.broadcast(_to_torch(t), root_rank=root_rank, name=name,
                          process_set=process_set)
        return _like(out, t, keep_shape=True)

    return _same_shape(_eager, tensor) if _in_graph() else _eager(tensor)


def allgather(tensor, name=None, process_set: Optional[ProcessSet] = None):
    def _eager(t):
        return _like(C.allgather(_to_torch(t), name=name,
                                 process_set=process_set), t)

    if _in_graph():
        out = _py_collective(_eager, [tensor], tensor.dtype)
        out.set_shape([None] + list(tensor.shape)[1:])  # dim0: sum of ranks
        return out
    return _eager(tensor)


def reducescatter(tensor, op=Average,
                  process_set: Optional[ProcessSet] = None, **kw):
    def _eager(t):
        return _like(C.reducescatter(_to_torch(t), op=op,
                                     process_set=process_set, **kw), t)

    if _in_graph():
        out = _py_collective(_eager, [tensor], tensor.dtype)
        out.set_shape([None] + list(tensor.shape)[1:])  # dim0: this rank's
        return out
    return _eager(tensor)


def alltoall(tensor, splits=None, name=None,
             process_set: Optional[ProcessSet] = None):
    """(output, received splits); the counts stay int64 end to end —
    routing them through the input dtype (e.g. fp16) would corrupt
    counts above its mantissa range."""
    tf = _tf()

    def _eager(t, sp=None):
        sp = None if sp is None else [int(s) for s in _to_np(sp)]
        out, recv = C.alltoall(_to_torch(t), splits=sp, name=name,
                               process_set=process_set)
        return _like(out, t), tf.convert_to_tensor(
            recv.cpu().numpy().astype(np.int64))

    if _in_graph():
        inputs = [tensor] if splits is None else [tensor, splits]
        out, recv = _py_collective(_eager, inputs, [tensor.dtype, tf.int64])
        out.set_shape([None] + list(tensor.shape)[1:])
        return out, recv
    return _eager(tensor, splits)


def barrier(process_set: Optional[ProcessSet] = None):
    if _in_graph():
        tf = _tf()

        def _eager():
            C.barrier(process_set=process_set)
            return tf.constant(0, tf.int32)

        return _py_collective(_eager, [], tf.int32)
    C.barrier(process_set=process_set)


def broadcast_variables(variables, root_rank: int = 0) -> None:
    """In-place sync of tf.Variables from root (reference:
    tensorflow/__init__.py broadcast_variables)."""
    for i, v in enumerate(variables):
        v.assign(broadcast(v, root_rank,
                           name=getattr(v, "name", None)
                           or f"broadcast_variables.{i}"))


def broadcast_global_variables(root_rank: int = 0) -> None:
    """Reference: keras/__init__.py:195 — TF1-style global-variables
    broadcast; in TF2/Keras-3 the graph-collection of globals is empty,
    so this syncs whatever tf.compat.v1 still tracks (use
    broadcast_variables(model.variables) in new code)."""
    broadcast_variables(_tf().compat.v1.global_variables(), root_rank)


def broadcast_object(obj, root_rank: int = 0, name=None,
                     process_set: Optional[ProcessSet] = None):
    from horovod_tpu_torch.optim.functions import broadcast_object as _bo
    return _bo(obj, root_rank=root_rank, name=name, process_set=process_set)


def _make_allreduce_grads_fn(op, gradient_predivide_factor: float,
                             compression, process_set):
    """Reference: tensorflow/__init__.py:631 _make_allreduce_grads_fn —
    compression + predivide-split averaging around one grouped allreduce."""
    if gradient_predivide_factor != 1.0 and op != Average:
        raise ValueError(
            "gradient_predivide_factor not supported with op != Average "
            "(reference: tensorflow/__init__.py)")
    pre = post = 1.0
    if gradient_predivide_factor != 1.0:
        pre = 1.0 / gradient_predivide_factor
        post = gradient_predivide_factor

    def allreduce_grads(grads):
        idxs = [i for i, g in enumerate(grads) if g is not None]
        comp = [compression.compress(grads[i]) for i in idxs]
        reduced = grouped_allreduce(
            [t for t, _ in comp], op=op, prescale_factor=pre,
            postscale_factor=post, process_set=process_set) if comp else []
        out: List[Any] = [None] * len(grads)
        for i, r, (_, ctx) in zip(idxs, reduced, comp):
            out[i] = compression.decompress(r, ctx)
        return out

    return allreduce_grads


class DistributedGradientTape:
    """Reference: tensorflow/__init__.py:1125 — wraps tf.GradientTape so
    gradient() returns cross-rank (grouped, fused) reduced gradients.

    Variables registered via `register_local_source` keep their LOCAL
    gradients (never allreduced); with `scale_local_gradients` they are
    divided by the set size so their effective step matches the averaged
    global ones (reference: register_local_source + pull/3695)."""

    def __init__(self, gradtape, compression=None, op=Average,
                 gradient_predivide_factor: float = 1.0,
                 process_set: Optional[ProcessSet] = None,
                 scale_local_gradients: bool = True):
        self.tape = gradtape
        self.scale_local_gradients = scale_local_gradients
        self._process_set = process_set
        self._local_sources = set()
        self._local_layers: List[Any] = []
        self._allreduce_grads = _make_allreduce_grads_fn(
            op, gradient_predivide_factor,
            compression or Compression.none, process_set)

    def register_local_source(self, var) -> None:
        """Mark `var`'s gradient as rank-local (reference:
        tensorflow/__init__.py register_local_source)."""
        self._local_sources.add(var.ref() if hasattr(var, "ref")
                                else id(var))

    def register_local_layer(self, layer) -> None:
        """Mark a whole layer's trainable weights rank-local, resolved
        LAZILY at gradient() time (the layer may build later)."""
        self._local_layers.append(layer)

    def _is_local(self, var) -> bool:
        key = var.ref() if hasattr(var, "ref") else id(var)
        if key in self._local_sources:
            return True
        return any(var is v for layer in self._local_layers
                   for v in layer.trainable_weights)

    def __enter__(self):
        return self.tape.__enter__()

    def __exit__(self, *args):
        return self.tape.__exit__(*args)

    def __getattr__(self, name):
        return getattr(self.tape, name)

    def gradient(self, target, sources, output_gradients=None):
        grads = self.tape.gradient(target, sources, output_gradients)
        single = not isinstance(grads, (list, tuple))
        glist = [grads] if single else list(grads)
        slist = [sources] if single else list(sources)
        if not self._local_sources and not self._local_layers:
            out = self._allreduce_grads(glist)
            return out[0] if single else out
        k = (self._process_set.size() if self._process_set is not None
             else size())
        out = _partial_reduce(glist, slist, self._is_local,
                              self._allreduce_grads,
                              self.scale_local_gradients, float(k))
        return out[0] if single else out


def _keras3_config(optimizer, backward_passes_per_step: int) -> dict:
    """The wrapped optimizer's config, with backward_passes_per_step
    mapped onto Keras 3's native gradient_accumulation_steps."""
    cfg = optimizer.get_config()
    if backward_passes_per_step > 1:
        if cfg.get("gradient_accumulation_steps"):
            raise ValueError(
                "pass either backward_passes_per_step or a "
                "gradient_accumulation_steps-configured optimizer, not both")
        cfg["gradient_accumulation_steps"] = backward_passes_per_step
    return cfg


def _make_keras3_distributed(optimizer, compression, op,
                             gradient_predivide_factor: float,
                             backward_passes_per_step: int, process_set):
    """Dynamic subclass of the wrapped Keras-3 optimizer's own class, so
    `model.compile(optimizer=...)` accepts it (reference:
    horovod/_keras/__init__.py builds the same dynamic subclass). Gradients
    are reduced across ranks inside `apply`, which runs both eagerly and
    inside the tf.function Keras compiles around train_step (via the
    py_function graph bridge). With `backward_passes_per_step` > 1 Keras
    accumulates locally and the allreduce still runs every backward pass
    (correct math; the reduce-every-N-passes saving applies only to the
    eager wrapper path)."""
    allreduce_grads = _make_allreduce_grads_fn(
        op, gradient_predivide_factor, compression or Compression.none,
        process_set)
    base_cls = optimizer.__class__

    class _DistKeras(base_cls):
        def apply(self, grads, trainable_variables=None):
            reduced = allreduce_grads(list(grads))
            return super().apply(reduced, trainable_variables)

    _DistKeras.__name__ = "Distributed" + base_cls.__name__
    _DistKeras.__qualname__ = _DistKeras.__name__
    return _DistKeras.from_config(
        _keras3_config(optimizer, backward_passes_per_step))


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=None, legacy_opts=False):
    """Load a saved Keras model whose optimizer was a
    DistributedOptimizer, re-wrapping it so retraining keeps reducing
    gradients (reference: tensorflow/keras/__init__.py:234 load_model).

    The dynamic subclass serializes under `Distributed<Base>`; this
    registers a factory for that name for every optimizer in
    `keras.optimizers` (plus any `custom_optimizers`), rebuilding the
    base optimizer from its config and wrapping it. A
    `PartialDistributed<Base>` save reloads as a plain distributed
    optimizer (its local layers are live objects that do not serialize;
    re-wrap with PartialDistributedOptimizer after load). `legacy_opts`
    is a TF-2 relic, accepted and ignored (Keras 3 has one optimizer
    namespace)."""
    import keras

    comp = compression or Compression.none

    def wrap_factory(base_cls):
        class _Loader:
            @staticmethod
            def from_config(config, custom_objects=None):
                config.pop("gradient_accumulation_steps_is_dist", None)
                base = base_cls.from_config(config)
                return DistributedOptimizer(base, compression=comp)
        _Loader.__name__ = "Distributed" + base_cls.__name__
        return _Loader

    objs = dict(custom_objects or {})
    bases = [c for c in vars(keras.optimizers).values()
             if isinstance(c, type)
             and issubclass(c, keras.optimizers.Optimizer)]
    for c in bases + list(custom_optimizers or []):
        objs.setdefault("Distributed" + c.__name__, wrap_factory(c))
        objs.setdefault("PartialDistributed" + c.__name__,
                        wrap_factory(c))
    return keras.models.load_model(filepath, custom_objects=objs)


def DistributedOptimizer(optimizer, compression=None, op=Average,
                         gradient_predivide_factor: float = 1.0,
                         backward_passes_per_step: int = 1,
                         process_set: Optional[ProcessSet] = None):
    """Reference: tensorflow/__init__.py:896 + keras/__init__.py. For a
    Keras-3 optimizer, returns a dynamic subclass instance usable in
    `model.compile` and inside compiled train steps; otherwise a generic
    eager wrapper exposing `apply_gradients`."""
    try:
        import keras
    except ImportError:
        keras = None
    if keras is not None and isinstance(optimizer,
                                        keras.optimizers.Optimizer):
        return _make_keras3_distributed(
            optimizer, compression, op, gradient_predivide_factor,
            backward_passes_per_step, process_set)
    return _EagerDistributedOptimizer(
        optimizer, compression, op, gradient_predivide_factor,
        backward_passes_per_step, process_set)


def _local_layer_list(local_layers):
    if local_layers is None:
        return []
    if not isinstance(local_layers, (list, tuple, set)):
        local_layers = [local_layers]
    return list(local_layers)


def _local_layer_vars(local_layers):
    return [v for layer in _local_layer_list(local_layers)
            for v in layer.trainable_weights]


def _partial_reduce(grads, sources, is_local, allreduce_grads,
                    scale_local: bool, k: float):
    """Shared partition/splice/scale for the Partial wrappers: allreduce
    only non-local gradients, splice back, scale local ones by 1/k."""
    reduce_idx = [i for i, s in enumerate(sources) if not is_local(s)]
    reduced = allreduce_grads([grads[i] for i in reduce_idx])
    out = list(grads)
    for i, g in zip(reduce_idx, reduced):
        out[i] = g
    if scale_local:
        for i, s in enumerate(sources):
            if is_local(s) and out[i] is not None:
                out[i] = _scale_grad(out[i], 1.0 / k)
    return out


def _scale_grad(g, factor: float):
    """Scale a (possibly IndexedSlices) gradient without densifying —
    `slices / k` round-trips through convert_to_tensor and materializes
    the full dense shape (the reference scales .values, pull/3695)."""
    tf = _tf()
    if isinstance(g, tf.IndexedSlices):
        return tf.IndexedSlices(g.values * factor, g.indices,
                                g.dense_shape)
    return g * factor


def PartialDistributedOptimizer(optimizer, compression=None, op=Average,
                                gradient_predivide_factor: float = 1.0,
                                backward_passes_per_step: int = 1,
                                process_set: Optional[ProcessSet] = None,
                                local_layers=None,
                                scale_local_gradients: bool = True,
                                **_legacy):
    """DistributedOptimizer that keeps the gradients of `local_layers`
    rank-local — never allreduced, optionally divided by the set size
    (reference: keras/__init__.py:116 PartialDistributedOptimizer +
    pull/3695 scaling semantics). Extra legacy kwargs (device_dense,
    sparse_as_dense, ...) are accepted and ignored like the other
    wrappers."""
    layers = _local_layer_list(local_layers)
    if not layers:
        return DistributedOptimizer(
            optimizer, compression=compression, op=op,
            gradient_predivide_factor=gradient_predivide_factor,
            backward_passes_per_step=backward_passes_per_step,
            process_set=process_set)
    import keras

    if not isinstance(optimizer, keras.optimizers.Optimizer):
        raise ValueError(
            "PartialDistributedOptimizer requires a keras optimizer")
    allreduce_grads = _make_allreduce_grads_fn(
        op, gradient_predivide_factor, compression or Compression.none,
        process_set)
    k_fn = (process_set.size if process_set is not None else size)
    base_cls = optimizer.__class__

    class _PartialDistKeras(base_cls):
        def apply(self, grads, trainable_variables=None):
            tvars = trainable_variables
            if tvars is None:
                # Keras 3's own apply() fallback list — self.variables
                # is the (longer, misordered) OPTIMIZER-state list
                tvars = getattr(self, "_trainable_variables", None)
                if not tvars:
                    raise ValueError(
                        "apply(grads) without trainable_variables "
                        "requires a built optimizer")
            # resolve local vars LAZILY: layers may build after the
            # optimizer is constructed, and holding the layer list (not
            # bare ids) keeps the variables alive so identity is stable
            local_vars = _local_layer_vars(layers)

            def is_local(v):
                return any(v is lv for lv in local_vars)

            out = _partial_reduce(list(grads), list(tvars), is_local,
                                  allreduce_grads,
                                  scale_local_gradients, float(k_fn()))
            return super().apply(out, trainable_variables)

    _PartialDistKeras.__name__ = "PartialDistributed" + base_cls.__name__
    _PartialDistKeras.__qualname__ = _PartialDistKeras.__name__
    return _PartialDistKeras.from_config(
        _keras3_config(optimizer, backward_passes_per_step))


def PartialDistributedGradientTape(gradtape, compression=None, op=Average,
                                   gradient_predivide_factor: float = 1.0,
                                   process_set: Optional[ProcessSet] = None,
                                   local_layers=None,
                                   scale_local_gradients: bool = True,
                                   **_legacy):
    """Reference: tensorflow/__init__.py:1205 — a DistributedGradientTape
    with every `local_layers` trainable weight registered as a local
    source (resolved lazily: unbuilt layers contribute their weights once
    built)."""
    tape = DistributedGradientTape(
        gradtape, compression=compression, op=op,
        gradient_predivide_factor=gradient_predivide_factor,
        process_set=process_set,
        scale_local_gradients=scale_local_gradients)
    for layer in _local_layer_list(local_layers):
        tape.register_local_layer(layer)
    return tape


class _EagerDistributedOptimizer:
    """Generic duck-typed wrapper: reduces gradients across ranks before
    delegating `apply_gradients`, with local aggregation every
    `backward_passes_per_step` steps (eager only)."""

    def __init__(self, optimizer, compression=None, op=Average,
                 gradient_predivide_factor: float = 1.0,
                 backward_passes_per_step: int = 1,
                 process_set: Optional[ProcessSet] = None):
        self.opt = optimizer
        self._allreduce_grads = _make_allreduce_grads_fn(
            op, gradient_predivide_factor,
            compression or Compression.none, process_set)
        self._bpps = backward_passes_per_step
        self._count = 0
        self._accum: Optional[List[Any]] = None

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def apply_gradients(self, grads_and_vars, **kwargs):
        tf = _tf()
        grads, tvars = zip(*list(grads_and_vars))
        if self._bpps > 1 and _in_graph():
            raise NotImplementedError(
                "backward_passes_per_step > 1 uses Python-side accumulation "
                "state and cannot be traced into a tf.function; call "
                "apply_gradients eagerly (run the train step without "
                "@tf.function / with jit_compile=False and "
                "run_eagerly=True), or aggregate with bpps=1.")
        self._count += 1
        if self._bpps > 1:
            # Local gradient aggregation (reference:
            # tensorflow/gradient_aggregation_eager.py).
            if self._accum is None:
                self._accum = [tf.zeros_like(g) if g is not None else None
                               for g in grads]
            self._accum = [a + g if g is not None else a
                           for a, g in zip(self._accum, grads)]
            if self._count % self._bpps != 0:
                return None
            grads = [a / self._bpps if a is not None else None
                     for a in self._accum]
            self._accum = None
        reduced = self._allreduce_grads(list(grads))
        return self.opt.apply_gradients(zip(reduced, tvars), **kwargs)


# -- Keras callbacks (reference: horovod/_keras/callbacks.py) --------------

def _keras_callback_base():
    import keras
    return keras.callbacks.Callback


class BroadcastGlobalVariablesCallback:
    """Broadcast initial variables from root at train start, and optimizer
    slot variables after they materialize on the first batch (reference:
    _keras/callbacks.py:23-60 — the deferred broadcast exists because
    optimizer slots are created lazily at the first apply; without it,
    Adam moments start diverged across ranks). A factory returning a
    Keras callback so the keras import stays lazy."""

    def __new__(cls, root_rank: int = 0):
        Base = _keras_callback_base()

        class _CB(Base):
            def __init__(self, root):
                super().__init__()
                self.root = root
                self._done = False
                self._opt_done = False

            def on_train_begin(self, logs=None):
                if not self._done:
                    broadcast_variables(self.model.variables, self.root)
                    self._done = True

            def on_train_batch_end(self, batch, logs=None):
                if self._opt_done:
                    return
                opt = getattr(self.model, "optimizer", None)
                opt_vars = list(getattr(opt, "variables", None) or [])
                if opt_vars:
                    broadcast_variables(opt_vars, self.root)
                self._opt_done = True

        return _CB(root_rank)


class MetricAverageCallback:
    """Average logged metrics across ranks at epoch end (reference:
    _keras/callbacks.py:62); each metric is one f32 allreduce."""

    def __new__(cls):
        Base = _keras_callback_base()

        class _CB(Base):
            def on_epoch_end(self, epoch, logs=None):
                if logs:
                    for k, v in list(logs.items()):
                        x = torch.tensor(float(v), dtype=torch.float32,
                                         device=topology.device())
                        logs[k] = float(C.allreduce(
                            x, op=Average, name=f"metric_avg.{k}").item())

        return _CB()


class LearningRateWarmupCallback:
    """Linear LR warmup from `initial_lr` to `initial_lr * size` over the
    first epochs (reference: _keras/callbacks.py:193 — gradually scale to
    the size-multiplied rate; a no-op at size 1)."""

    def __new__(cls, initial_lr: float, warmup_epochs: int = 5,
                verbose: int = 0):
        Base = _keras_callback_base()

        class _CB(Base):
            def __init__(self):
                super().__init__()
                self.initial_lr = initial_lr
                self.warmup_epochs = warmup_epochs
                self.verbose = verbose

            def on_epoch_begin(self, epoch, logs=None):
                k = size()
                if epoch >= self.warmup_epochs or k == 1:
                    return
                progress = (epoch + 1) / self.warmup_epochs
                lr = self.initial_lr * (1.0 + (k - 1) * progress)
                self.model.optimizer.learning_rate.assign(lr)
                if self.verbose:
                    print(f"Epoch {epoch}: LearningRateWarmupCallback "
                          f"sets learning rate to {lr:.6g}")

        return _CB()


class LearningRateScheduleCallback:
    """Multiply the learning rate by `multiplier` over an epoch range
    (reference: _keras/callbacks.py:108 LearningRateScheduleCallbackImpl —
    `multiplier` is a constant or a callable(epoch); active during
    [start_epoch, end_epoch)). With staircase=False the LR interpolates
    per batch at fractional epochs (needs steps_per_epoch);
    momentum_correction rescales SGD momentum proportionally to the LR
    change, as the reference does."""

    def __new__(cls, initial_lr: float, multiplier, start_epoch: int = 0,
                end_epoch=None, staircase: bool = True,
                momentum_correction: bool = True,
                steps_per_epoch=None, verbose: int = 0):
        Base = _keras_callback_base()
        mult_fn = multiplier if callable(multiplier) \
            else (lambda epoch: multiplier)

        class _CB(Base):
            def __init__(self):
                super().__init__()
                self._epoch = 0
                self._steps = steps_per_epoch

            def _in_range(self, epoch) -> bool:
                return epoch >= start_epoch and \
                    (end_epoch is None or epoch < end_epoch)

            def _apply(self, epoch):
                if not self._in_range(epoch):
                    return
                opt = self.model.optimizer
                lr = initial_lr * float(mult_fn(epoch))
                if momentum_correction and \
                        getattr(opt, "momentum", None) is not None:
                    # restore then rescale momentum with the LR ratio
                    # (reference: momentum correction for LR changes)
                    old_lr = float(opt.learning_rate)
                    if old_lr > 0 and lr != old_lr:
                        mom = opt.momentum
                        try:
                            mom.assign(float(mom) * lr / old_lr)
                        except AttributeError:
                            opt.momentum = float(mom) * lr / old_lr
                opt.learning_rate.assign(lr)
                if verbose:
                    print(f"Epoch {epoch}: LearningRateScheduleCallback "
                          f"sets learning rate to {lr:.6g}")

            def on_epoch_begin(self, epoch, logs=None):
                self._epoch = epoch
                if staircase:
                    self._apply(epoch)

            def on_train_batch_end(self, batch, logs=None):
                if staircase:
                    return
                if self._steps is None:
                    # derive steps/epoch from the first epoch's batches
                    self._steps = max(batch + 1, 1)
                    frac = 0.0
                else:
                    self._steps = max(self._steps, batch + 1)
                    frac = (batch + 1) / float(self._steps)
                self._apply(self._epoch + min(frac, 1.0))

        return _CB()


class _CallbacksNamespace:
    """`hvd.callbacks.*` — the reference keras namespace
    (horovod/tensorflow/keras/callbacks.py) so migrating scripts keep
    their spelling."""

    def __init__(self):
        self.BroadcastGlobalVariablesCallback = \
            BroadcastGlobalVariablesCallback
        self.MetricAverageCallback = MetricAverageCallback
        self.LearningRateWarmupCallback = LearningRateWarmupCallback
        self.LearningRateScheduleCallback = LearningRateScheduleCallback


callbacks = _CallbacksNamespace()


# Elastic substate (reference: horovod/tensorflow/elastic.py) —
# hvd.elastic.TfKerasState, @hvd.elastic.run.
from horovod_tpu_torch.frontends import tensorflow_elastic as elastic  # noqa: E402,F401
