"""Worker for tests/test_torch_tf_frontend.py and
tests/test_torch_mxnet_frontend.py: one rank of a gloo world of two that
drives the port's TensorFlow and MXNet frontends on per-rank inputs.

Imports TensorFlow, Keras, torch and horovod_tpu_torch, never JAX; the
MXNet frontend runs over the JAX tests' stub NDArray
(tests/test_mxnet_frontend.py `_ND`), installed as `mxnet` here. Inputs
arrive as numpy arrays, one row per rank; every result goes to
`out_path` as an .npz file (bf16 as its uint16 bit patterns).
"""

import os
import sys
import types

import numpy as np

OPS = ("Sum", "Average", "Min", "Max", "Product", "Adasum")
WARMUP_EPOCHS = 3
WARMUP_LR = 0.1


def _stub_mxnet():
    from test_mxnet_frontend import _ND
    mod = types.ModuleType("mxnet")
    nd = types.ModuleType("mxnet.nd")
    nd.array = lambda a, ctx=None, dtype=None: _ND(a, ctx or "cpu(0)",
                                                   dtype)
    mod.nd = nd

    class _Optimizer:
        lr = 0.1

        def update(self, index, weight, grad, state):
            weight[:] = _ND(weight.asnumpy() - self.lr * grad.asnumpy())

    mod.optimizer = types.SimpleNamespace(Optimizer=_Optimizer)
    sys.modules["mxnet"] = mod
    sys.modules["mxnet.nd"] = nd
    return mod, _ND


def _tf_part(rank, inputs, out):
    import keras
    import tensorflow as tf

    import horovod_tpu_torch.frontends.tensorflow as tfvd

    def bits(t):
        a = t.numpy()
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    x = tf.constant(inputs["x"][rank])

    @tf.function
    def graph_reduce(t, op):
        return tfvd.allreduce(t, op=op)

    for name in OPS:
        op = getattr(tfvd, name)
        out[f"tf_{name}"] = bits(tfvd.allreduce(x, op=op, name=f"e_{name}"))
        out[f"tf_graph_{name}"] = bits(graph_reduce(x, op))
    out["tf_int_average"] = bits(tfvd.allreduce(
        tf.constant(inputs["ints"][rank])))
    bf = tf.constant(inputs["bf16_bits"][rank].view(np.int16))
    bf = tf.bitcast(bf, tf.bfloat16)
    out["tf_bf16_prescale"] = bits(tfvd.allreduce(bf, prescale_factor=1 / 3))
    out["tf_grouped"] = bits(tfvd.grouped_allreduce([x, x], op=tfvd.Sum)[1])
    rows = tf.constant(inputs["x"][rank][:2 + rank])  # 2 rows, then 3
    out["tf_allgather"] = bits(tfvd.allgather(rows))
    out["tf_broadcast"] = bits(tfvd.broadcast(x, root_rank=1))
    a2a, recv = tfvd.alltoall(rows, splits=[1, 1 + rank])
    out["tf_alltoall"], out["tf_alltoall_recv"] = bits(a2a), recv.numpy()
    out["tf_reducescatter"] = bits(tfvd.reducescatter(
        tf.constant(inputs["x"][rank][:4]), op=tfvd.Sum))

    # The tape: loss = Σ w·c_r, so the local gradient is c_r.
    w = tf.Variable(np.zeros(inputs["x"].shape[1:], np.float32))
    c = tf.constant(inputs["x"][rank])
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(w * c)
    out["tf_tape"] = bits(tfvd.DistributedGradientTape(tape).gradient(
        loss, [w])[0])

    v = tf.Variable(np.ones(inputs["x"].shape[1:], np.float32))
    opt = tfvd.DistributedOptimizer(keras.optimizers.SGD(learning_rate=0.5))
    opt.apply_gradients([(c, v)])
    out["tf_optimizer"] = v.numpy()

    logs = {"loss": float(inputs["x"][rank].ravel()[0])}
    tfvd.MetricAverageCallback().on_epoch_end(0, logs)
    out["tf_metric"] = np.float64(logs["loss"])

    model = keras.Sequential([keras.layers.Input((2,)),
                              keras.layers.Dense(1)])
    model.compile(optimizer=keras.optimizers.SGD(learning_rate=WARMUP_LR),
                  loss="mse")
    cb = tfvd.LearningRateWarmupCallback(initial_lr=WARMUP_LR,
                                         warmup_epochs=WARMUP_EPOCHS)
    cb.set_model(model)
    lrs = []
    for epoch in range(WARMUP_EPOCHS + 1):
        cb.on_epoch_begin(epoch)
        lrs.append(float(model.optimizer.learning_rate))
    out["tf_warmup_lrs"] = np.asarray(lrs)


def _mx_part(rank, inputs, out):
    mx, ND = _stub_mxnet()
    import horovod_tpu_torch.frontends.mxnet as mhvd

    x = ND(inputs["x"][rank])
    for name in OPS:
        out[f"mx_{name}"] = mhvd.allreduce(x, op=getattr(mhvd, name),
                                           name=f"mx_{name}").asnumpy()
    b = ND(inputs["x"][rank].copy())
    mhvd.broadcast_(b, root_rank=1)
    out["mx_broadcast"] = b.asnumpy()
    out["mx_allgather"] = mhvd.allgather(
        ND(inputs["x"][rank][:2 + rank])).asnumpy()
    w = ND(np.ones(inputs["x"].shape[1:], np.float32))
    g = ND(inputs["x"][rank].copy())
    opt = mhvd.DistributedOptimizer(mx.optimizer.Optimizer(),
                                    gradient_predivide_factor=2.0)
    opt.update(0, w, g, None)
    out["mx_predivide_grad"], out["mx_predivide_weight"] = \
        g.asnumpy(), w.asnumpy()


def run(rank: int, size: int, store: str, inputs: dict, out_path: str,
        parts) -> None:
    os.environ.update({"HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(size),
                       "HOROVOD_LOCAL_RANK": str(rank),
                       "HOROVOD_LOCAL_SIZE": str(size)})
    import torch

    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    out = {}
    try:
        if "tf" in parts:
            _tf_part(rank, inputs, out)
        if "mx" in parts:
            _mx_part(rank, inputs, out)
        hvd.barrier()
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)
