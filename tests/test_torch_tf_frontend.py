"""The port's TensorFlow/Keras frontend (horovod_tpu_torch/frontends/
tensorflow.py, keras.py) held against the JAX package's
(horovod_tpu/frontends/tensorflow.py) on the same seeded inputs.

* A spawned gloo world of two (tests/torch_frontend_worker.py) with
  distinct inputs per rank: allreduce with Sum, Average, Min, Max,
  Product and Adasum, eagerly and inside tf.function, against the JAX
  package's reduce bodies (`_apply_reduce`, `adasum_reduce_block`) under
  shard_map on two CPU devices — bit for bit, Adasum within 1e-6 of the
  largest value (f32 dot products summed in another order); an int32
  Average floors in its dtype and a bf16 prescale is cast to bf16, bit
  for bit against the JAX rule (C3, C4); the other collectives, the
  tape, the Keras optimizer and the metric average against numpy; the
  warmup callback's learning rates epoch by epoch against the JAX
  callback's at size 2.
* In this process, the port in a gloo world of one and the JAX package
  in its 8-replica world (every replica the same, so an average is the
  local value): each JAX test case runs through both frontends on the
  same TF variables and inputs, and the results must agree (exactly, or
  within 1e-6 relative where the JAX side averages 8 f32 copies); Keras
  `compile`/`fit` with the DistributedOptimizer and `load_model` across
  the packages, the Partial variants, the callbacks' learning rates
  epoch by epoch, and the pinned `jit_compile=True` error.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
keras = pytest.importorskip("keras")

import jax.numpy as jnp  # noqa: E402

import horovod_tpu.frontends.tensorflow as jtf  # noqa: E402
import horovod_tpu_torch.frontends.tensorflow as ttf  # noqa: E402
import torch_frontend_worker as W  # noqa: E402
from test_torch_collective_semantics import (  # noqa: E402
    _bits, _reference, _reference_eager)
from torch_reduce_reference import op_reference as _op_ref  # noqa: E402
from torch_world_worker import start_world  # noqa: E402

K = 2
RTOL = 1e-6      # the JAX side's average of 8 identical f32 copies
TOL_ADASUM = 1e-6  # of the largest value


def _inputs():
    rng = np.random.default_rng(18)
    bf = rng.uniform(0.1, 50.0, (K, 257)).astype(jnp.bfloat16)
    return {"x": rng.uniform(-2.0, 2.0, (K, 4, 3)).astype(np.float32),
            "ints": np.stack([np.array([3, -4, -8], np.int32) + r
                              for r in range(K)]),
            "bf16_bits": bf.view(np.uint16)}


# ----------------------------------------------------------------------
# In this process: the port's world of one beside the JAX package's
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def port():
    ttf.init(device="cpu")
    yield ttf
    ttf.shutdown()


@pytest.fixture()
def both(port, hvd):
    """(JAX frontend, port frontend), both initialized."""
    return jtf, ttf


def _close(a, b, rtol=RTOL):
    a = a.numpy() if hasattr(a, "numpy") else np.asarray(a)
    b = b.numpy() if hasattr(b, "numpy") else np.asarray(b, a.dtype)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


def test_allreduce_roundtrip(both):
    x = tf.reshape(tf.range(6, dtype=tf.float32), (2, 3))
    for fv in both:
        y = fv.allreduce(x)
        assert isinstance(y, tf.Tensor)
        _close(y, x)
        s = fv.allreduce(x, op=fv.Sum)
        _close(s, x.numpy() * fv.size())


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float64",
                                   "int32", "int64", "uint8", "bool"])
def test_dtypes_cross_the_boundary(both, dtype):
    rng = np.random.default_rng(7)
    x = tf.cast(tf.constant(rng.integers(0, 2, (3, 5))), dtype)
    for fv in both:
        for graph in (False, True):
            f = tf.function(lambda t: fv.broadcast(t, 0)) if graph \
                else (lambda t: fv.broadcast(t, 0))
            y = f(x)
            assert y.dtype == x.dtype and y.shape == x.shape
            np.testing.assert_array_equal(
                tf.cast(y, tf.float64).numpy(),
                tf.cast(x, tf.float64).numpy())


def test_scalar_keeps_its_shape(both):
    for fv in both:
        y = fv.allreduce(tf.constant(7.0))
        assert y.shape == () and float(y) == 7.0


def test_broadcast_variables(both):
    for fv in both:
        v = tf.Variable(tf.ones((3,)) * (fv.rank() + 7))
        fv.broadcast_variables([v], root_rank=0)
        np.testing.assert_array_equal(v.numpy(), 7.0)


def test_allgather_alltoall(both):
    for fv in both:
        k = fv.size()
        assert fv.allgather(tf.ones((2, 3))).shape == (2 * k, 3)
        out, recv = fv.alltoall(tf.ones((2 * k, 3)))
        assert out.shape == (2 * k, 3) and recv.dtype == tf.int64
        np.testing.assert_array_equal(recv.numpy(), np.full(k, 2))


def _tape_grads(fv, w, **kw):
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(w * 3.0) + tf.reduce_sum(w * w)
    return fv.DistributedGradientTape(tape, **kw).gradient(loss, [w])[0]


def test_distributed_gradient_tape(both):
    w = tf.Variable(np.random.default_rng(1).normal(
        size=(3, 2)).astype(np.float32))
    _close(_tape_grads(ttf, w), _tape_grads(jtf, w))
    _close(_tape_grads(ttf, w), 3.0 + 2.0 * w.numpy())


def test_tape_compression_and_predivide(both):
    for fv in both:
        with pytest.raises(ValueError):
            fv.DistributedGradientTape(tf.GradientTape(), op=fv.Sum,
                                       gradient_predivide_factor=2.0)
    w = tf.Variable(tf.ones((4, 4)))
    got = [_tape_grads(fv, w, compression=fv.Compression.fp16,
                       gradient_predivide_factor=4.0) for fv in both]
    assert got[1].dtype == tf.float32  # decompressed back
    _close(got[1], got[0])
    np.testing.assert_allclose(got[1].numpy(), 5.0, rtol=1e-2)
    ints, ctx = ttf.Compression.fp16.compress(tf.constant([1, 2]))
    assert ints.dtype == tf.int32 and ctx is None  # floats only


@pytest.mark.parametrize("bpps", [1, 2])
def test_keras_optimizer_and_local_aggregation(both, bpps):
    got = []
    for fv in both:
        v = tf.Variable(0.0)
        opt = fv.DistributedOptimizer(
            keras.optimizers.SGD(learning_rate=1.0),
            backward_passes_per_step=bpps)
        assert isinstance(opt, keras.optimizers.Optimizer)
        trace = []
        for g in (1.0, 3.0):
            opt.apply_gradients([(tf.constant(g), v)])
            trace.append(float(v.numpy()))
        got.append(trace)
    assert got[0] == got[1]
    assert got[1] == ([-1.0, -4.0] if bpps == 1 else [0.0, -2.0])


def test_tf_function_allreduce_gather_broadcast(both):
    x = tf.reshape(tf.range(6, dtype=tf.float32), (2, 3))
    for fv in both:
        f = tf.function(lambda t, fv=fv: fv.allreduce(t, op=fv.Sum))
        y = f(x)
        assert y.shape == (2, 3)
        _close(y, x.numpy() * fv.size())

        @tf.function
        def g(t, fv=fv):
            return fv.allgather(t), fv.broadcast(t, root_rank=0)

        out, b = g(tf.ones((2, 3)))
        assert out.shape == (2 * fv.size(), 3)
        np.testing.assert_array_equal(b.numpy(), 1.0)


def test_tf_function_reducescatter_alltoall_barrier(both):
    for fv in both:
        k = fv.size()

        @tf.function
        def f(t, fv=fv):
            rs = fv.reducescatter(t, op=fv.Sum)
            out, recv = fv.alltoall(t)
            return rs, out, recv, fv.barrier()

        rs, out, recv, b = f(tf.ones((2 * k, 3)))
        np.testing.assert_array_equal(rs.numpy(), np.full((2, 3), float(k)))
        assert out.shape == (2 * k, 3) and int(b) == 0
        np.testing.assert_array_equal(recv.numpy(), np.full(k, 2))


def test_tf_function_gradient_tape_step(both):
    trace = []
    for fv in both:
        w = tf.Variable([[2.0]])

        @tf.function
        def step(x, fv=fv, w=w):
            with tf.GradientTape() as tape:
                loss = tf.reduce_sum(tf.square(w * x - 3.0))
            (grad,) = fv.DistributedGradientTape(tape).gradient(loss, [w])
            w.assign_sub(0.1 * grad)
            return loss

        trace.append([float(step(tf.constant([[1.0]]))) for _ in range(20)])
        np.testing.assert_allclose(w.numpy(), 3.0, rtol=1e-2)
    np.testing.assert_allclose(trace[1], trace[0], rtol=RTOL)
    assert trace[1][-1] < trace[1][0] * 1e-3


def test_tf_function_collectives_are_chained(port):
    @tf.function
    def f(a, b):
        return ttf.allreduce(a, op=ttf.Sum), ttf.allreduce(b, op=ttf.Sum)

    cf = f.get_concrete_function(tf.TensorSpec((2,), tf.float32),
                                 tf.TensorSpec((3,), tf.float32))
    ops = [op for op in cf.graph.get_operations()
           if op.type == "EagerPyFunc"]
    assert len(ops) == 2
    assert any(c is ops[0] for c in ops[1].control_inputs)


def test_tf_function_bpps(both):
    class _DummyOpt:
        def apply_gradients(self, gv, **kw):
            pass

    for fv in both:
        v = tf.Variable(0.0)
        opt = fv.DistributedOptimizer(
            keras.optimizers.SGD(learning_rate=1.0),
            backward_passes_per_step=2)

        @tf.function
        def step(g, opt=opt, v=v):
            opt.apply_gradients([(g, v)])

        step(tf.constant(1.0))
        assert float(v.numpy()) == 0.0  # accumulating
        step(tf.constant(3.0))
        assert float(v.numpy()) == -2.0  # the mean applied

        eager = fv.DistributedOptimizer(_DummyOpt(),
                                        backward_passes_per_step=2)

        @tf.function
        def bad(eager=eager, v=v):
            eager.apply_gradients([(tf.constant(2.0), v)])

        with pytest.raises(NotImplementedError,
                           match="backward_passes_per_step"):
            bad()


def test_eager_wrapper_aggregates_locally(both):
    class _Apply:
        def __init__(self):
            self.seen = []

        def apply_gradients(self, gv, **kw):
            self.seen.append([float(g) for g, _ in gv])

    got = []
    for fv in both:
        base = _Apply()
        opt = fv.DistributedOptimizer(base, backward_passes_per_step=2)
        v = tf.Variable(0.0)
        for g in (1.0, 3.0, 5.0, 7.0):
            opt.apply_gradients([(tf.constant(g), v)])
        got.append(base.seen)
    assert got[0] == got[1] == [[2.0], [6.0]]


def test_metric_average_callback(both):
    for fv in both:
        logs = {"loss": 4.0, "acc": 0.5}
        fv.MetricAverageCallback().on_epoch_end(0, logs)
        assert logs == {"loss": 4.0, "acc": 0.5}


def _lr_model(momentum=0.0):
    model = keras.Sequential([keras.layers.Input((2,)),
                              keras.layers.Dense(1)])
    model.compile(optimizer=keras.optimizers.SGD(learning_rate=1.0,
                                                 momentum=momentum),
                  loss="mse")
    return model


def _schedule_trace(fv, momentum, **kw):
    model = _lr_model(momentum)
    cb = fv.callbacks.LearningRateScheduleCallback(initial_lr=1.0, **kw)
    cb.set_model(model)
    out = []
    for epoch in range(4):
        cb.on_epoch_begin(epoch)
        for batch in range(2):
            cb.on_train_batch_end(batch)
            out.append((float(model.optimizer.learning_rate),
                        float(model.optimizer.momentum)))
    return out


@pytest.mark.parametrize("case", ["staircase", "smooth", "constant"])
def test_lr_schedule_epoch_by_epoch_matches_jax(both, case):
    kw = {"staircase": dict(multiplier=lambda e: 0.1 ** e, start_epoch=1,
                            end_epoch=3),
          "smooth": dict(multiplier=lambda e: 0.5 ** e, staircase=False,
                         steps_per_epoch=2),
          "constant": dict(multiplier=0.25, start_epoch=2)}[case]
    for name in ("BroadcastGlobalVariablesCallback", "MetricAverageCallback",
                 "LearningRateWarmupCallback",
                 "LearningRateScheduleCallback"):
        assert hasattr(ttf.callbacks, name)
    want = _schedule_trace(jtf, 0.9, **kw)
    got = _schedule_trace(ttf, 0.9, **kw)
    assert got == want
    if case == "staircase":
        assert [lr for lr, _ in got[::2]] == pytest.approx(
            [1.0, 0.1, 0.01, 0.01])


def test_warmup_is_a_no_op_at_size_one(port):
    model = _lr_model()
    cb = ttf.LearningRateWarmupCallback(initial_lr=1.0, warmup_epochs=3)
    cb.set_model(model)
    cb.on_epoch_begin(0)
    assert float(model.optimizer.learning_rate) == 1.0


def test_broadcast_global_variables_callback(both):
    data = (np.ones((8, 2), np.float32), np.ones((8, 1), np.float32))
    for fv in both:
        keras.utils.set_random_seed(4)
        model = keras.Sequential([keras.layers.Input((2,)),
                                  keras.layers.Dense(1)])
        model.compile(optimizer=fv.DistributedOptimizer(
            keras.optimizers.Adam(0.1)), loss="mse")
        before = [v.numpy().copy() for v in model.variables]
        cb = fv.callbacks.BroadcastGlobalVariablesCallback(0)
        cb.set_model(model)
        cb.on_train_begin()
        for v, b in zip(model.variables, before):
            np.testing.assert_array_equal(v.numpy(), b)
        model.fit(*data, epochs=1, verbose=0, callbacks=[cb])


def test_jit_compile_pinned_error(both):
    """`tf.function(jit_compile=True)` around a collective fails with
    TF's unsupported-op (EagerPyFunc) error, as in the JAX package; the
    same function without jit_compile works."""
    for fv in both:
        @tf.function(jit_compile=True)
        def step(x, fv=fv):
            return fv.allreduce(x, op=fv.Sum, name="xla_pin")

        with pytest.raises(Exception) as ei:
            step(tf.constant([1.0, 2.0]))
        msg = str(ei.value)
        assert "EagerPyFunc" in msg or "unsupported operations" in msg

        ok = tf.function(lambda x, fv=fv: fv.allreduce(
            x, op=fv.Sum, name="xla_pin_ok"))
        _close(ok(tf.constant([1.0, 2.0])),
               np.array([1.0, 2.0], np.float32) * fv.size())


def test_min_max_product_exports(both):
    t = tf.constant([2.0, 5.0])
    for fv in both:
        _close(fv.allreduce(t, op=fv.Product, name="tfpr"),
               np.array([2.0, 5.0], np.float32) ** fv.size())
        _close(fv.allreduce(t, op=fv.Max, name="tfmx"), t)
        _close(fv.allreduce(t, op=fv.Min, name="tfmn"), t)


def test_api_sweep(both):
    for fv in both:
        k = fv.size()
        outs = fv.grouped_allgather([tf.ones((2, 3)), tf.zeros((1, 5))])
        assert outs[0].shape == (2 * k, 3) and outs[1].shape == (k, 5)
        outs = fv.grouped_reducescatter([tf.ones((k * 2, 3))], op=fv.Sum)
        np.testing.assert_array_equal(outs[0].numpy(),
                                      np.full((2, 3), float(k)))
        assert int(fv.size_op()) == k
        assert int(fv.rank_op()) == fv.rank()
        assert int(fv.local_rank_op()) == fv.local_rank()
        assert int(fv.local_size_op()) == fv.local_size()
        assert int(fv.process_set_included_op()) == 1
        v = tf.Variable([1.0, 2.0])
        assert fv.broadcast_([v], root_rank=0)[0] is v
        np.testing.assert_array_equal(v.numpy(), [1.0, 2.0])
        assert fv.broadcast_object_fn(root_rank=0)({"a": 1}) == {"a": 1}
        assert fv.broadcast_object([1, "x"]) == [1, "x"]
        assert fv.allgather_object({"r": fv.rank()})[0] == {"r": 0}


def test_grouped_ops_inside_tf_function(both):
    for fv in both:
        k = fv.size()

        @tf.function
        def f(x, y, fv=fv):
            return (fv.grouped_allgather([x])[0],
                    fv.grouped_reducescatter([y], op=fv.Sum)[0],
                    fv.grouped_allreduce([x, y], op=fv.Sum)[1])

        ag, rs, gr = f(tf.ones((2, 3)), tf.ones((k * 2, 3)))
        assert ag.shape == (2 * k, 3) and gr.shape == (k * 2, 3)
        np.testing.assert_array_equal(rs.numpy(), np.full((2, 3), float(k)))


def _fit(fv, x, y, epochs=3):
    keras.utils.set_random_seed(5)
    model = keras.Sequential([keras.layers.Input((4,)),
                              keras.layers.Dense(3, activation="tanh"),
                              keras.layers.Dense(2)])
    model.compile(optimizer=fv.DistributedOptimizer(
        keras.optimizers.Adam(0.05)), loss="mse")
    hist = model.fit(x, y, epochs=epochs, batch_size=8, shuffle=False,
                     verbose=0)
    return model, hist.history["loss"]


def test_keras_compile_fit_matches_jax(both):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = rng.normal(size=(32, 2)).astype(np.float32)
    mj, lj = _fit(jtf, x, y)
    mt, lt = _fit(ttf, x, y)
    assert type(mt.optimizer).__name__ == "DistributedAdam"
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    for a, b in zip(mj.get_weights(), mt.get_weights()):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_load_model_rewraps_the_optimizer(both, tmp_path, saver):
    fv = ttf if saver == "port" else jtf
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    m, _ = _fit(fv, x, np.ones((8, 2), np.float32), epochs=1)
    path = str(tmp_path / "m.keras")
    m.save(path)
    m2 = ttf.load_model(path)
    assert type(m2.optimizer).__name__ == "DistributedAdam"
    assert float(m2.optimizer.learning_rate) == pytest.approx(0.05)
    for a, b in zip(m.get_weights(), m2.get_weights()):
        np.testing.assert_array_equal(a, b)
    m2.fit(x, np.ones((8, 2)), epochs=1, verbose=0)


def test_partial_distributed_tape_and_optimizer(both):
    for fv in both:
        k = fv.size()
        g_var, l_var = tf.Variable([2.0]), tf.Variable([3.0])
        with tf.GradientTape() as tape:
            loss = 4.0 * g_var[0] + 8.0 * l_var[0]
        dtape = fv.DistributedGradientTape(tape)
        dtape.register_local_source(l_var)
        gg, lg = dtape.gradient(loss, [g_var, l_var])
        _close(gg, [4.0])
        _close(lg, np.array([8.0 / k], np.float32))

        local = keras.layers.Dense(1, use_bias=False,
                                   kernel_initializer="ones")
        local.build((None, 1))
        opt = fv.PartialDistributedOptimizer(keras.optimizers.SGD(1.0),
                                             local_layers=[local])
        assert type(opt).__name__ == "PartialDistributedSGD"
        w = local.trainable_weights[0]
        opt.apply([tf.ones_like(w)], [w])
        _close(w, np.array([[1.0 - 1.0 / k]], np.float32))
        assert type(fv.PartialDistributedOptimizer(
            keras.optimizers.SGD(0.1))).__name__ == "DistributedSGD"


def test_partial_local_scaling_keeps_indexed_slices(both):
    for fv in both:
        v = tf.Variable(tf.ones((10, 4)))
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum(tf.gather(v, [1, 3]))
        dtape = fv.DistributedGradientTape(tape)
        dtape.register_local_source(v)
        g = dtape.gradient(loss, v)
        assert isinstance(g, tf.IndexedSlices)
        _close(g.values, np.ones((2, 4), np.float32) / fv.size())


def test_partial_optimizer_unbuilt_layer_resolves_lazily(both):
    for fv in both:
        k = fv.size()
        layer = keras.layers.Dense(1, use_bias=False,
                                   kernel_initializer="ones")
        opt = fv.PartialDistributedOptimizer(keras.optimizers.SGD(1.0),
                                             local_layers=[layer])
        layer.build((None, 1))
        w = layer.trainable_weights[0]
        opt.apply([tf.ones_like(w)], [w])
        _close(w, np.array([[1.0 - 1.0 / k]], np.float32))

        layer2 = keras.layers.Dense(1, use_bias=False)
        with tf.GradientTape() as t:
            pass
        dtape = fv.PartialDistributedGradientTape(t, local_layers=[layer2])
        layer2.build((None, 1))
        assert dtape._is_local(layer2.trainable_weights[0])


def test_keras_alias_module(both):
    import horovod_tpu_torch.frontends.keras as khvd
    assert khvd.size() == ttf.size()
    out = khvd.allreduce(np.ones(3, np.float32), op=khvd.Sum)
    np.testing.assert_array_equal(np.asarray(out), float(ttf.size()))
    assert callable(khvd.callbacks.BroadcastGlobalVariablesCallback)
    assert khvd.DistributedOptimizer is ttf.DistributedOptimizer


# ----------------------------------------------------------------------
# The world of two (started with the module's first test)
# ----------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _world_started(tmp_path_factory):
    """The world of two starts with the module's first test and runs
    beside the in-process tests (its ranks spend most of their time
    importing TensorFlow); the `world` tests at the end join it."""
    tmp = tmp_path_factory.mktemp("tf_world")
    inputs = _inputs()
    outs = [str(tmp / f"rank{r}.npz") for r in range(K)]
    handle = start_world(W.run, [(r, K, str(tmp / "store"), inputs, outs[r],
                                  ("tf",)) for r in range(K)], tmp,
                         deadline=150)
    yield handle, inputs, outs
    handle.join()  # idempotent; reaps the ranks if no world test ran


@pytest.fixture(scope="module")
def world(_world_started):
    handle, inputs, outs = _world_started
    handle.join()
    return inputs, [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("where", ["eager", "graph"])
@pytest.mark.parametrize("name", W.OPS)
def test_world_reductions_follow_the_jax_rule(world, name, where):
    inputs, got = world
    want = _op_ref(inputs["x"], name)
    key = f"tf_{name}" if where == "eager" else f"tf_graph_{name}"
    for r in range(K):
        assert got[r][key].dtype == np.float32
        if name == "Adasum":
            scale = float(np.max(np.abs(want)))
            assert float(np.max(np.abs(got[r][key] - want))) <= \
                TOL_ADASUM * scale
        else:
            np.testing.assert_array_equal(got[r][key], want)
    np.testing.assert_array_equal(got[0][f"tf_{name}"],
                                  got[0][f"tf_graph_{name}"])


def test_world_int_average_floors_and_bf16_prescale_rounds(world):
    inputs, got = world
    ints = _reference(inputs["ints"], jnp.int32)
    bf = _bits(_reference_eager(inputs["bf16_bits"].view(jnp.bfloat16),
                                jnp.bfloat16, prescale=1 / 3))
    for r in range(K):
        assert got[r]["tf_int_average"].dtype == np.int32
        np.testing.assert_array_equal(got[r]["tf_int_average"], ints)
        np.testing.assert_array_equal(got[r]["tf_bf16_prescale"], bf)


def test_world_gather_scatter_broadcast_alltoall(world):
    inputs, got = world
    x = inputs["x"]
    gathered = np.concatenate([x[0][:2], x[1][:3]])
    rs = (x[0][:4] + x[1][:4])
    for r in range(K):
        np.testing.assert_array_equal(got[r]["tf_grouped"], x[0] + x[1])
        np.testing.assert_array_equal(got[r]["tf_allgather"], gathered)
        np.testing.assert_array_equal(got[r]["tf_broadcast"], x[1])
        np.testing.assert_array_equal(got[r]["tf_reducescatter"],
                                      rs[2 * r:2 * r + 2])
    # rank 0 sent [1, 1] rows and rank 1 [1, 2]
    np.testing.assert_array_equal(got[0]["tf_alltoall"],
                                  np.stack([x[0][0], x[1][0]]))
    np.testing.assert_array_equal(got[1]["tf_alltoall"],
                                  np.stack([x[0][1], x[1][1], x[1][2]]))
    np.testing.assert_array_equal(got[0]["tf_alltoall_recv"], [1, 1])
    np.testing.assert_array_equal(got[1]["tf_alltoall_recv"], [1, 2])
    assert got[0]["tf_alltoall_recv"].dtype == np.int64


def test_world_tape_optimizer_and_metric_average(world):
    inputs, got = world
    x = inputs["x"]
    mean = _op_ref(x, "Average")
    for r in range(K):
        np.testing.assert_array_equal(got[r]["tf_tape"], mean)
        np.testing.assert_array_equal(got[r]["tf_optimizer"],
                                      np.float32(1.0) - np.float32(0.5)
                                      * mean)
        assert float(got[r]["tf_metric"]) == pytest.approx(
            float(np.mean([x[0].ravel()[0], x[1].ravel()[0]])), rel=1e-7)


def test_world_warmup_lrs_follow_the_jax_callback(world, monkeypatch):
    _, got = world
    monkeypatch.setattr(jtf, "size", lambda: K)  # the JAX rule at k = 2
    model = keras.Sequential([keras.layers.Input((2,)),
                              keras.layers.Dense(1)])
    model.compile(optimizer=keras.optimizers.SGD(learning_rate=W.WARMUP_LR),
                  loss="mse")
    cb = jtf.LearningRateWarmupCallback(initial_lr=W.WARMUP_LR,
                                        warmup_epochs=W.WARMUP_EPOCHS)
    cb.set_model(model)
    want = []
    for epoch in range(W.WARMUP_EPOCHS + 1):
        cb.on_epoch_begin(epoch)
        want.append(float(model.optimizer.learning_rate))
    for r in range(K):
        np.testing.assert_array_equal(got[r]["tf_warmup_lrs"], want)
    assert want[-1] == pytest.approx(W.WARMUP_LR * K)
