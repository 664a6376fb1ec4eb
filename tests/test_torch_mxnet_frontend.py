"""The port's MXNet frontend (horovod_tpu_torch/frontends/mxnet.py) held
against the JAX package's (horovod_tpu/frontends/mxnet.py), over the
JAX tests' stub NDArray (tests/test_mxnet_frontend.py: numpy-backed,
context and dtype aware; no mxnet is installed).

* In this process, the port in a gloo world of one and the JAX package
  in its 8-replica world (every replica the same): each JAX test case
  through both frontends on the same seeded NDArrays; results equal
  (within 1e-6 relative where the JAX side averages 8 f32 copies), the
  context, dtype and shape of the input kept.
* A spawned gloo world of two (tests/torch_frontend_worker.py, started
  with the module's first test) with distinct inputs per rank: allreduce
  with Sum, Average, Min, Max, Product and Adasum against the JAX
  package's reduce bodies under shard_map (bit for bit; Adasum within
  1e-6 of the largest value), broadcast from rank 1, an uneven
  allgather, and DistributedOptimizer's predivide split (pre 1/2, post
  2/k over Sum) giving the mean gradient within 1 ulp.
"""

import numpy as np
import pytest

import horovod_tpu.frontends.mxnet as jmx
import horovod_tpu_torch.frontends.mxnet as tmx
import torch_frontend_worker as W
from test_mxnet_frontend import _ND, stub_mxnet  # noqa: F401
from torch_reduce_reference import op_reference as _op_ref
from torch_world_worker import start_world

K = 2
RTOL = 1e-6      # the JAX side's average of 8 identical f32 copies
TOL_ADASUM = 1e-6


@pytest.fixture(scope="module")
def port():
    tmx.init(device="cpu")
    yield tmx
    tmx.shutdown()


@pytest.fixture()
def both(port, hvd, stub_mxnet):
    return jmx, tmx


def _x(shape=(2, 3), seed=0, ctx="gpu(2)"):
    rng = np.random.default_rng(seed)
    return _ND(rng.normal(size=shape).astype(np.float32), ctx=ctx)


def _same(a, b, rtol=RTOL):
    assert isinstance(a, _ND) and isinstance(b, _ND)
    assert a.context == b.context and a.dtype == b.dtype
    assert a.shape == b.shape
    np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=rtol, atol=0)


def test_allreduce_roundtrip_keeps_context_and_dtype(both):
    x = _x()
    outs = [fv.allreduce(x) for fv in both]
    _same(outs[1], outs[0])
    assert outs[1].context == "gpu(2)" and outs[1].dtype == np.float32
    np.testing.assert_array_equal(outs[1].asnumpy(), x.asnumpy())


@pytest.mark.parametrize("op", ["Sum", "Min", "Max", "Product"])
def test_allreduce_ops(both, op):
    x = _ND(np.abs(_x(seed=1).asnumpy()) + 0.5)
    for fv in both:
        k = fv.size()
        want = {"Sum": x.asnumpy() * k, "Product": x.asnumpy() ** k}.get(
            op, x.asnumpy())
        np.testing.assert_allclose(
            fv.allreduce(x, op=getattr(fv, op)).asnumpy(), want, rtol=RTOL)


def test_broadcast_inplace_and_scalar_shape(both):
    for fv in both:
        x = _ND(np.full((4,), fv.rank() + 3.0, np.float32))
        assert fv.broadcast_(x, root_rank=0) is x
        np.testing.assert_array_equal(x.asnumpy(), 3.0)
        assert fv.allreduce(_ND(np.float32(7.0))).shape == ()
        _same(fv.broadcast(_x(), 0), _x())


def test_allgather_alltoall_barrier(both):
    x = _ND(np.ones((2, 3), np.float32))
    for fv in both:
        assert fv.allgather(x).shape == (2 * fv.size(), 3)
        fv.barrier()
    out, recv = tmx.alltoall(_x((4, 3)))
    _same(out, _x((4, 3)))
    np.testing.assert_array_equal(recv, [4])


def test_grouped_allreduce(both):
    xs = [_x((2,), seed=2), _x((3,), seed=3)]
    outs = [fv.grouped_allreduce(xs, op=fv.Sum) for fv in both]
    for fv, o in zip(both, outs):
        for a, x in zip(o, xs):
            np.testing.assert_allclose(a.asnumpy(),
                                       x.asnumpy() * fv.size(), rtol=RTOL)


def test_broadcast_parameters_and_object(both):
    for fv in both:
        params = {"w": _ND(np.full((2, 2), 5.0, np.float32)),
                  "b": _ND(np.zeros((2,), np.float32))}
        fv.broadcast_parameters(params, root_rank=0)
        np.testing.assert_array_equal(params["w"].asnumpy(), 5.0)
        with pytest.raises(ValueError, match="dict"):
            fv.broadcast_parameters([params["w"]])
        assert fv.broadcast_object({"a": [1]}) == {"a": [1]}


def _update(fv, stub, predivide=1.0):
    base = stub.optimizer.Optimizer()
    opt = fv.DistributedOptimizer(base, gradient_predivide_factor=predivide)
    w = _ND(np.ones((4,), np.float32))
    g = _x((4,), seed=4)
    opt.update(0, w, g, None)
    opt.set_learning_rate(0.5)
    assert base.lr == 0.5 and base.updates == [("update", 0)]
    return w.asnumpy(), g.asnumpy()


@pytest.mark.parametrize("predivide", [1.0, 2.0])
def test_distributed_optimizer_allreduces_before_update(both, stub_mxnet,
                                                        predivide):
    (wj, gj), (wt, gt) = [_update(fv, stub_mxnet, predivide) for fv in both]
    np.testing.assert_allclose(gt, gj, rtol=RTOL)
    np.testing.assert_allclose(wt, wj, rtol=RTOL)
    np.testing.assert_allclose(wt, 1.0 - 0.1 * _x((4,), seed=4).asnumpy(),
                               rtol=1e-6)


def test_distributed_optimizer_predivide_validation(both, stub_mxnet):
    for fv in both:
        with pytest.raises(ValueError, match="predivide"):
            fv.DistributedOptimizer(stub_mxnet.optimizer.Optimizer(),
                                    gradient_predivide_factor=2.0,
                                    op=fv.Sum)


def test_grouped_update_index_list(both, stub_mxnet):
    class _Multi(stub_mxnet.optimizer.Optimizer):
        def update(self, index, weight, grad, state):
            self.updates.append(("update", tuple(index)))

    for fv in both:
        base = _Multi()
        opt = fv.DistributedOptimizer(base)
        ws = [_ND(np.ones((2,), np.float32)), _ND(np.ones((3,), np.float32))]
        gs = [_ND(np.full((2,), 2.0, np.float32)),
              _ND(np.full((3,), 6.0, np.float32))]
        opt.update([0, 1], ws, gs, [None, None])
        assert base.updates == [("update", (0, 1))]
        np.testing.assert_allclose(gs[0].asnumpy(), 2.0, rtol=RTOL)
        np.testing.assert_allclose(gs[1].asnumpy(), 6.0, rtol=RTOL)


def test_update_multi_precision_reduces_too(both, stub_mxnet):
    for fv in both:
        base = stub_mxnet.optimizer.Optimizer()
        g = _ND(np.full((2,), 4.0, np.float32))
        fv.DistributedOptimizer(base).update_multi_precision(
            3, _ND(np.ones((2,), np.float32)), g, None)
        assert base.updates == [("ump", 3)]
        np.testing.assert_array_equal(g.asnumpy(), 4.0)


def test_trainer_needs_mxnet(port, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "mxnet", None)
    with pytest.raises(ImportError, match="requires mxnet"):
        tmx.DistributedTrainer({}, "sgd")


# ----------------------------------------------------------------------
# A gloo world of two (started with the module's first test)
# ----------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(19)
    return {"x": rng.uniform(-2.0, 2.0, (K, 4, 3)).astype(np.float32)}


@pytest.fixture(scope="module", autouse=True)
def _world_started(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mx_world")
    inputs = _inputs()
    outs = [str(tmp / f"rank{r}.npz") for r in range(K)]
    handle = start_world(W.run, [(r, K, str(tmp / "store"), inputs, outs[r],
                                  ("mx",)) for r in range(K)], tmp,
                         deadline=120)
    yield handle, inputs, outs
    handle.join()


@pytest.fixture(scope="module")
def world(_world_started):
    handle, inputs, outs = _world_started
    handle.join()
    return inputs, [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("name", W.OPS)
def test_world_reductions_follow_the_jax_rule(world, name):
    inputs, got = world
    want = _op_ref(inputs["x"], name)
    for r in range(K):
        y = got[r][f"mx_{name}"]
        assert y.dtype == np.float32 and y.shape == want.shape
        if name == "Adasum":
            assert float(np.max(np.abs(y - want))) <= \
                TOL_ADASUM * float(np.max(np.abs(want)))
        else:
            np.testing.assert_array_equal(y, want)


def test_world_broadcast_allgather_and_predivide(world):
    inputs, got = world
    x = inputs["x"]
    mean = _op_ref(x, "Average")
    for r in range(K):
        np.testing.assert_array_equal(got[r]["mx_broadcast"], x[1])
        np.testing.assert_array_equal(got[r]["mx_allgather"],
                                      np.concatenate([x[0][:2], x[1][:3]]))
        # x/2 summed, times 2/2: the mean to within one ulp
        np.testing.assert_allclose(got[r]["mx_predivide_grad"], mean,
                                   rtol=2 ** -23, atol=0)
        np.testing.assert_allclose(got[r]["mx_predivide_weight"],
                                   1.0 - np.float32(0.1) * mean, rtol=1e-6)
