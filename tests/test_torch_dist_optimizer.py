"""DistributedOptimizer of the PyTorch package over a 4-rank gloo world,
against the JAX package's reduction bodies on the same numpy inputs;
fault C5 in a 2-rank world.

Worlds: tests/torch_optimizer_worker.py, spawned, a FileStore under
tmp_path, HOROVOD_FUSION_THRESHOLD=64 so that the four parameters plan
into several buckets. Each case installs seeded per-rank gradients
through a real backward pass (the hooks fire) and reads the gradients
the optimizer installs.

References, per tensor, on the ranks' rows stacked, under shard_map on
the CPU mesh of tests/conftest.py with x64 off: the JAX package's
`_scale_factors` (horovod_tpu/optim/optimizer.py) then `_apply_reduce`
(Average, Sum, Min, Max, Product; gradient_predivide_factor 4; groups;
a process set of 3), and `adasum_reduce_block` for Adasum. compression
fp16 is the JAX Compression.fp16 around an fp16 `_apply_reduce`. The
group plan is the JAX torch frontend's `_group_plan`; the bucket plan
the JAX fusion planner's. backward_passes_per_step is the JAX torch
frontend's sum over passes, which is N times what the optax
DistributedOptimizer of the JAX package applies (it divides by N).
Sparse gradients: numpy's scatter-add of every rank's rows, divided by
the world's size (the frontend's `_sparse_allreduce`), and the same
model under sparse_as_dense. Integer tensors carry no gradient, so the
integer cases are the collectives' (tests/test_torch_collectives.py).

Tolerances, those of tests/test_torch_collectives.py: Min, Max and
Product bit for bit; float32 sums and averages 1e-6 of Σ|x_r|; bf16
3 · 2^-8 of Σ|x_r|; fp16 3 · 2^-11 of Σ|x_r|; Adasum 1e-5 (f32) and
2^-6 (bf16) of the largest value. Sparse: 1e-6 of the largest value.
C5: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_collectives_worker as CW
import torch_optimizer_worker as W
from horovod_tpu.common import types as JT
from horovod_tpu.ops import adasum as jadasum
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.optim.optimizer import _scale_factors
from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.optim.optimizer import (DistributedOptimizer,
                                               group_plan, scale_factors)
from test_torch_collectives import _bits, _close, _shard

K = 4
NP = {"f32": np.float32, "bf16": jnp.bfloat16}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
TOL_SUM = {"f32": 1e-6, "bf16": 3 * 2.0 ** -8, "f16": 3 * 2.0 ** -11}
TOL_ADASUM = {"f32": 1e-5, "bf16": 2.0 ** -6}
N = len(W.SHAPES)


def _inputs():
    rng = np.random.default_rng(11)
    inp = {}
    for dt in ("f32", "bf16"):
        for i, s in enumerate(W.SHAPES):
            inp[f"g{i}_{dt}"] = rng.standard_normal((K,) + s).astype(NP[dt])
    for j in range(3):
        for i, s in enumerate(W.SHAPES):
            inp[f"bp{j}_{i}_f32"] = rng.standard_normal(
                (K,) + s).astype(np.float32)
    inp["emb_idx"] = rng.integers(0, W.EMB[0], (K, 6)).astype(np.int64)
    inp["emb_w"] = rng.standard_normal((K, 6, W.EMB[1])).astype(np.float32)
    return inp


def _wire(inp):
    return {("bf16:" + k if k.endswith("bf16") else k):
            (v.view(np.uint16) if k.endswith("bf16") else v)
            for k, v in inp.items()}


def _got(res, name, i, dt):
    a = res[f"{name}/{i}"]
    return a.view(jnp.bfloat16) if dt == "bf16" else a


def _ref(stacked, dt, op, f=1.0, k=K):
    """_scale_factors, then _apply_reduce, on every rank's rows."""
    pre, post, rop = _scale_factors(op, k, f)
    y = _shard(lambda b: jcoll._apply_reduce(b, rop, k, pre, post),
               stacked, JNP[dt], k)
    return y[0]


def _adasum(stacked, dt, k=K):
    return _shard(lambda b: jadasum.adasum_reduce_block(b, "hvd", k),
                  stacked, JNP[dt], k)[0]


def _check(got, want, dt, op, stacked):
    if op in (JT.ReduceOp.MIN, JT.ReduceOp.MAX, JT.ReduceOp.PRODUCT):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    elif op == JT.ReduceOp.ADASUM:
        _close(got, want, TOL_ADASUM[dt],
               np.max(np.abs(np.asarray(want, np.float64))))
    else:
        _close(got, want, TOL_SUM[dt],
               np.max(np.sum(np.abs(np.asarray(stacked, np.float64)), 0)))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    return CW.spawn(W.run_opt, tmp_path_factory.mktemp("opt"),
                    _wire(inputs), timeout=240)


@pytest.fixture(scope="module")
def c5(tmp_path_factory):
    return CW.spawn(W.run_c5, tmp_path_factory.mktemp("c5"), {}, k=2)


OPS = ["AVERAGE", "SUM", "MIN", "MAX", "PRODUCT"]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("op", OPS)
def test_every_op_on_the_bucket_path(world, inputs, op, dt):
    """Average and Sum, and the elementwise Min, Max and Product, ride
    the hook path's buckets and equal the per-tensor reference."""
    rop = JT.normalize_reduce_op(op)
    for r in range(K):
        assert bool(world[r][f"{op}_{dt}/hooked"])
        assert int(world[r][f"{op}_{dt}/buckets"]) > 1
        for i in range(N):
            stacked = inputs[f"g{i}_{dt}"]
            _check(_got(world[r], f"{op}_{dt}", i, dt),
                   _ref(stacked, dt, rop), dt, rop, stacked)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_adasum_is_per_tensor_not_per_bucket(world, inputs, dt):
    """Adasum takes the step-time path, one call per tensor, and equals
    adasum_reduce_block tensor by tensor; an Adasum over the packed
    bucket differs."""
    flat = np.concatenate([inputs[f"g{i}_{dt}"].reshape(K, -1)
                           for i in range(N)], 1)
    packed = _adasum(flat, dt)
    off, far = 0, 0.0
    for r in range(K):
        assert not bool(world[r][f"ADASUM_{dt}/hooked"])
        assert int(world[r][f"ADASUM_{dt}/calls"]) == N
    for i in range(N):
        stacked = inputs[f"g{i}_{dt}"]
        want = _adasum(stacked, dt)
        for r in range(K):
            _check(_got(world[r], f"ADASUM_{dt}", i, dt), want, dt,
                   JT.ReduceOp.ADASUM, stacked)
        n = want.size
        got = np.asarray(_got(world[0], f"ADASUM_{dt}", i, dt),
                         np.float64).reshape(-1)
        far = max(far, np.max(np.abs(got - np.asarray(
            packed[off:off + n], np.float64))))
        off += n
    assert far > 10 * TOL_ADASUM[dt] * np.max(np.abs(flat.astype(
        np.float64)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gradient_predivide_factor(world, inputs, dt):
    """f = 4: a Sum of g / 4 scaled by 4 / k, as _scale_factors has it."""
    assert scale_factors(JT.ReduceOp.AVERAGE, K, 4.0)[:2] == \
        _scale_factors(JT.ReduceOp.AVERAGE, K, 4.0)[:2]
    for r in range(K):
        for i in range(N):
            stacked = inputs[f"g{i}_{dt}"]
            _check(_got(world[r], f"predivide_{dt}", i, dt),
                   _ref(stacked, dt, JT.ReduceOp.AVERAGE, 4.0), dt,
                   JT.ReduceOp.AVERAGE, stacked)


def test_predivide_needs_average_as_in_jax():
    p = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError):
        DistributedOptimizer(torch.optim.SGD([p], lr=0.1), op=JT.Sum,
                             gradient_predivide_factor=2.0)
    with pytest.raises(ValueError):
        scale_factors(JT.ReduceOp.SUM, K, 2.0)


def test_fp16_compression(world, inputs):
    """Compression.fp16: the f32 gradients travel and reduce in fp16
    and come back f32, as the JAX compressor around an fp16 reduce."""
    from horovod_tpu.ops.compression import Compression as JC
    for i in range(N):
        wire = np.stack([np.asarray(JC.fp16.compress(
            jnp.asarray(inputs[f"g{i}_f32"][r]))[0]) for r in range(K)])
        want = np.asarray(JC.fp16.decompress(
            jnp.asarray(_ref(wire, "f16", JT.ReduceOp.AVERAGE)),
            jnp.float32))
        for r in range(K):
            assert str(world[r][f"fp16/dtype{i}"]) == "torch.float32"
            _close(world[r][f"fp16/{i}"], want, TOL_SUM["f16"],
                   np.max(np.sum(np.abs(wire.astype(np.float64)), 0)))


@pytest.mark.parametrize("name,op", [("groups2", "AVERAGE"),
                                     ("groups_list", "AVERAGE"),
                                     ("groups3_max", "MAX")])
def test_groups_on_the_step_time_path(world, inputs, name, op):
    rop = JT.normalize_reduce_op(op)
    for r in range(K):
        assert not bool(world[r][f"{name}/hooked"])
        for i in range(N):
            stacked = inputs[f"g{i}_f32"]
            _check(world[r][f"{name}/{i}"], _ref(stacked, "f32", rop),
                   "f32", rop, stacked)
    # one collective per bucket of each group's plan
    ps = [torch.zeros(s) for s in W.SHAPES]
    groups = {"groups2": 2, "groups3_max": 3,
              "groups_list": [[ps[1], ps[3]]]}[name]
    want = sum(len(jfusion.plan_buckets(
        [(tuple(p.shape), "float32") for p in g], W.THRESHOLD))
        for g in group_plan(groups, ps))
    assert int(world[0][f"{name}/calls"]) == want


@pytest.mark.parametrize("groups", [0, 1, 2, 3, 7, "pin13", "pin0_23",
                                    "empty"])
def test_group_plan_matches_the_jax_frontend(groups):
    from horovod_tpu.frontends import torch as jtorch
    ps = [torch.nn.Parameter(torch.zeros(s)) for s in W.SHAPES]
    spec = {"pin13": [[ps[1], ps[3]]], "pin0_23": [[ps[0]], [ps[2], ps[3]]],
            "empty": []}.get(groups, groups)
    ref = jtorch.DistributedOptimizer(torch.optim.SGD(ps, lr=0.1),
                                      groups=spec)
    want = [[id(p) for p in g] for g in ref._group_plan(ps)]
    assert [[id(p) for p in g] for g in group_plan(spec, ps)] == want


@pytest.mark.parametrize("name,op", [("set3_avg", "AVERAGE"),
                                     ("set3_adasum", "ADASUM"),
                                     ("set3_groups", "SUM")])
def test_process_set_of_three(world, inputs, name, op):
    """An optimizer over the set {0, 1, 2}: its members reduce over 3
    ranks; rank 3 builds none."""
    rop = JT.normalize_reduce_op(op)
    for r in range(K):
        assert (f"{name}/0" in world[r]) == (r in W.SET3)
    for i in range(N):
        stacked = inputs[f"g{i}_f32"][:3]
        want = _adasum(stacked, "f32", k=3) if rop == JT.ReduceOp.ADASUM \
            else _ref(stacked, "f32", rop, k=3)
        for r in W.SET3:
            _check(world[r][f"{name}/{i}"], want, "f32", rop, stacked)


def test_bucket_plan_matches_jax_on_every_rank(world):
    want = jfusion.plan_signature(jfusion.plan_buckets(
        [(s, "float32") for s in W.SHAPES], W.THRESHOLD, reverse=True))
    for r in range(K):
        assert str(world[r]["plan_sig"]) == want


def test_backward_passes_per_step_sums_like_the_frontend(world, inputs):
    """bpps 3: None and no move on passes 1 and 2; the third applies the
    average of the summed passes (the torch frontend's semantics), which
    is 3 times what the JAX package's optax DistributedOptimizer
    applies from the same passes; the second cycle moves as far again."""
    import horovod_tpu as jhvd
    ps4 = jhvd.ProcessSet(list(range(K)))
    jhvd.init(process_sets=[ps4])
    try:
        names = [f"w{i}" for i in range(N)]
        params = {n: jnp.zeros(s, jnp.float32)
                  for n, s in zip(names, W.SHAPES)}
        jopt = jhvd.DistributedOptimizer(optax.sgd(1.0),
                                         backward_passes_per_step=3,
                                         process_set=ps4)
        state = jopt.init(params)
        for j in range(3):
            grads = {n: inputs[f"bp{j}_{i}_f32"] for i, n in
                     enumerate(names)}
            optax_p, _ = jopt.step(grads, params, state)
    finally:
        jhvd.shutdown()
    for r in range(K):
        res = world[r]
        assert [bool(res[f"bpps/ret{j}"]) for j in range(3)] == \
            [True, True, False]
        assert [bool(res[f"bpps/ret2_{j}"]) for j in range(3)] == \
            [True, True, False]
        for i in range(N):
            for j in range(2):
                assert not res[f"bpps/p{j}_{i}"].any()
            summed = sum(inputs[f"bp{j}_{i}_f32"] for j in range(3))
            want = -_ref(summed, "f32", JT.ReduceOp.AVERAGE)
            scale = np.max(np.sum(np.abs(summed.astype(np.float64)), 0))
            _close(res[f"bpps/p2_{i}"], want, TOL_SUM["f32"], scale)
            _close(res[f"bpps/p2_{i}"],
                   3 * np.asarray(optax_p[f"w{i}"]), 4 * TOL_SUM["f32"],
                   scale)
            _close(res[f"bpps/p_cycle2_{i}"], 2 * want,
                   2 * TOL_SUM["f32"], scale)


def test_sparse_gradient_matches_the_frontend_and_as_dense(world, inputs):
    """An Embedding(sparse=True) beside a dense bias: its gradient
    arrives sparse, rides the first step's bucket as zeros, then leaves
    the plan; it equals numpy's scatter-add over the ranks divided by 4,
    and the same model under sparse_as_dense."""
    dense = np.zeros((K,) + W.EMB)
    for r in range(K):
        np.add.at(dense[r], inputs["emb_idx"][r], inputs["emb_w"][r])
    want = dense.sum(0) / K
    bias = inputs["emb_w"].sum(1).mean(0)
    tol = 1e-6 * np.max(np.abs(dense.sum(0)))
    for r in range(K):
        res = world[r]
        assert [int(res[f"sparse/buckets{s}"]) for s in (0, 1)] == [1, 1]
        assert [int(res[f"as_dense/buckets{s}"]) for s in (0, 1)] == [2, 2]
        for s in (0, 1):
            assert bool(res[f"sparse/is_sparse{s}"])
            _close(res[f"sparse/grad{s}"], want, tol, 1.0)
            _close(res[f"as_dense/grad{s}"], want, tol, 1.0)
            _close(res[f"sparse/bias{s}"], bias, 1e-6, np.abs(bias).max())
        _close(res["sparse/weight"], -2 * want, 2 * tol, 1.0)
        _close(res["sparse/weight"], res["as_dense/weight"], 2 * tol, 1.0)
        _close(res["sparse_sum"], dense.sum(0), tol, 1.0)


def test_sparse_refuses_elementwise_ops():
    """Only Sum and Average are defined on sparse tensors."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collectives as tcoll
    hvd.init(device="cpu")
    try:
        t = torch.sparse_coo_tensor([[0, 2]], torch.ones(2, 3), (4, 3),
                                    check_invariants=True)
        with pytest.raises(HorovodError, match="Sum or Average"):
            tcoll.sparse_allreduce(t, op=hvd.Max)
        got = hvd.allreduce(t, op=hvd.Sum)
        assert got.is_sparse and torch.equal(got.to_dense(), t.to_dense())
    finally:
        hvd.shutdown()


def test_objects_over_a_set_without_rank_1(world):
    """broadcast_object from global rank 2 over {0, 2, 3}: only members
    call it; allgather_object over the world and the set."""
    for r in range(K):
        assert world[r]["obj_gather"].tolist() == [0, 1, 2, 3]
        assert ("obj_set/from" in world[r]) == (r in W.OBJ_SET)
    for r in W.OBJ_SET:
        assert int(world[r]["obj_set/from"]) == 2
        np.testing.assert_array_equal(world[r]["obj_set/t"], [2.0] * 3)
        assert world[r]["obj_set/gather"].tolist() == [0, 20, 30]


def test_c5_fresh_rank_gets_the_roots_momentum(c5):
    """Fault C5: rank 0 holds momentum buffers after one step, rank 1
    none; after broadcast_optimizer_state rank 1 holds rank 0's buffers,
    bit for bit, on its parameters' device."""
    for r in range(2):
        assert int(c5[r]["entries"]) == 2
        assert float(c5[r]["lr"]) == 0.1
        for i in range(2):
            np.testing.assert_array_equal(c5[r][f"buf{i}"], c5[0][f"buf{i}"])
            assert str(c5[r][f"buf_device{i}"]) == "cpu"
    assert np.abs(c5[1]["buf0"]).max() > 0


def test_world_check_of_the_card_runs_on_gloo():
    """The multi-card part of chip_smoke.py's phase 8
    (horovod_tpu_torch/optim/world_check.py) passes its numpy checks in
    a world of 4 gloo ranks started through runner.run."""
    import functools

    from horovod_tpu_torch import runner
    from horovod_tpu_torch.optim import world_check
    res = runner.run(functools.partial(world_check.worker, "cpu"), np=4,
                     timeout=240, extra_env={"OMP_NUM_THREADS": "1"})
    assert [r["size"] for r in res] == [4] * 4
    for r in res:
        assert set(r["ops"]) == set(world_check.TOL) | {"groups2",
                                                         "predivide4"}
        assert not r["ops"]["Adasum"]["hooked"]
        assert r["ops"]["Adasum"]["collectives"] == len(world_check.SHAPES)
        assert r["join"] == {"steps": 5, "join": 3}
        assert r["c5"] == {"entries": 2}
        # its first step: the bucket it rode as zeros, two allgathers
        assert r["sparse"]["collectives"] == 3
        assert r["tuner"] == res[0]["tuner"]
