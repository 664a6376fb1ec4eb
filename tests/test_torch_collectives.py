"""The eager collectives of the PyTorch package over a 4-rank gloo world,
against the JAX package's reduce bodies on the same numpy inputs.

Two spawned worlds (tests/torch_collectives_worker.py, a FileStore under
tmp_path): a flat one that runs every op, process sets included, and
one under HOROVOD_HIERARCHICAL_ALLREDUCE/_ALLGATHER with
HOROVOD_TPU_MESH_SHAPE=2x2, which runs each call hierarchically and
then flat.

The references are the JAX package's own bodies under shard_map on the
CPU mesh of tests/conftest.py, with the ranks' rows stacked: `_apply_reduce`
(Min, Max, Product, Sum, Average), `adasum_reduce_block` with and without
halving, `_rs_block` and `_apply_reduce_hier`, all with x64 off, as the
package runs on its device (an int32 Product stays int32, an int32
Average reducescatter gives float32). Allgather, alltoall and broadcast
move data only; their reference is the numpy semantics the JAX package's
docstrings state (concatenation in rank order; rank j receives
splits[i][j] rows from each rank i, in rank order; the root's tensor),
because its single-controller mode cannot take per-rank dim 0 sizes.

Tolerances: Min, Max, Product and every integer case are bit for bit;
Product multiplies in rank order (bf16 in float32, as jnp.prod does).
Sums of 4 float32 rows: 1e-6 of Σ|x_r| (the library adds in another
order). Sums of 4 bf16 rows: 3 · 2^-8 of Σ|x_r| (three roundings of at
most half a bf16 step). Adasum float32: 1e-5 of the largest value (the
dots are summed in another order); bf16: 2^-6 of the largest value (a
coefficient one f32 step away can move a rounded value by a bf16 step at
each of two levels). A hierarchical float32 or int32 sum over 2x2 adds
pairs in the reference's order and is held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_collectives_worker as W
from horovod_tpu.common import types as JT
from horovod_tpu.ops import adasum as jadasum
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu_torch.optim.optimizer import DistributedOptimizer
import horovod_tpu_torch as hvd

K = 4
NP = {"f32": np.float32, "bf16": jnp.bfloat16, "i32": np.int32}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "i32": jnp.int32}
TOL_SUM = {"f32": 1e-6, "bf16": 3 * 2.0 ** -8}
TOL_ADASUM = {"f32": 1e-5, "bf16": 2.0 ** -6}


def _gen(rng, dt, shape):
    if dt == "i32":
        return rng.integers(-3, 4, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(NP[dt])


def _inputs():
    rng = np.random.default_rng(7)
    inp = {}
    for dt in ("f32", "bf16", "i32"):
        for key, shape in (("red", (K, 5, 3)), ("red2", (K, 11)),
                           ("rs_even", (K, 8, 3)), ("rs_uneven", (K, 10, 2)),
                           ("h", (K, 7))):
            inp[f"{key}_{dt}"] = _gen(rng, dt, shape)
    inp["h2_f32"] = _gen(rng, "f32", (K, 3, 3))
    inp["hag_f32"] = _gen(rng, "f32", (K, 2, 3))
    for dt in ("f32", "i32"):
        inp[f"ag_{dt}"] = [_gen(rng, dt, (n, 3)) for n in W.AG_ROWS]
    inp["ag2_f32"] = [_gen(rng, "f32", (n, 2)) for n in (2, 0, 1, 4)]
    inp["a2a_f32"] = [_gen(rng, "f32", (sum(s), 2)) for s in W.A2A_SPLITS]
    return inp


def _wire(inp):
    """bf16 arrays travel as their bit patterns."""
    return {("bf16:" + k if k.endswith("bf16") else k):
            (v.view(np.uint16) if k.endswith("bf16") else v)
            for k, v in inp.items()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _from_bits(a, dt):
    return a.view(jnp.bfloat16) if dt == "bf16" else a


def _shard(body, stacked, dtype, k=K):
    """body under shard_map over k CPU devices, one row per rank, x64
    off; returns every rank's output block."""
    with jax.enable_x64(False):
        mesh = Mesh(np.array(jax.devices()[:k]), ("hvd",))
        fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("hvd"),
                                   out_specs=P("hvd"), check_vma=False))
        return np.asarray(fn(jnp.asarray(stacked, dtype)))


def _reduce_ref(stacked, dt, op, pre=1.0, post=1.0, k=K):
    y = _shard(lambda b: jcoll._apply_reduce(b, op, k, pre, post), stacked,
               JNP[dt], k)
    for r in range(1, k):
        np.testing.assert_array_equal(_bits(y[r]), _bits(y[0]))
    return y[0]


def _adasum_ref(stacked, dt, halving, k=K):
    y = _shard(lambda b: jadasum.adasum_reduce_block(b, "hvd", k,
                                                     halving=halving),
               stacked, JNP[dt], k)
    return y[0]


def _close(got, want, tol, scale):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= tol * scale, (err, tol * scale)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def flat(tmp_path_factory, inputs):
    return W.spawn(W.run_flat, tmp_path_factory.mktemp("flat"),
                   _wire(inputs))


@pytest.fixture(scope="module")
def hier(tmp_path_factory, inputs):
    return W.spawn(W.run_hier, tmp_path_factory.mktemp("hier"),
                   _wire(inputs))


# ---------------------------------------------------- Min, Max, Product

@pytest.mark.parametrize("dt", ["f32", "bf16", "i32"])
@pytest.mark.parametrize("op", ["MIN", "MAX", "PRODUCT"])
def test_min_max_product_bit_for_bit(flat, inputs, op, dt):
    want = _bits(_reduce_ref(inputs[f"red_{dt}"], dt, JT.ReduceOp[op]))
    want2 = _bits(_reduce_ref(inputs[f"red2_{dt}"], dt, JT.ReduceOp[op]))
    for r in range(K):
        for key, w in ((f"{op}_{dt}", want), (f"grouped_{op}_{dt}", want),
                       (f"grouped2_{op}_{dt}", want2)):
            assert flat[r][key].dtype == w.dtype, key
            np.testing.assert_array_equal(flat[r][key], w, err_msg=key)
    if op == "MAX":
        for r in range(K):
            np.testing.assert_array_equal(flat[r][f"bucketed_MAX_{dt}"],
                                          want)


def test_min_with_scale_factors(flat, inputs):
    want = _reduce_ref(inputs["red_f32"], "f32", JT.ReduceOp.MIN, 2.0, 0.5)
    for r in range(K):
        np.testing.assert_array_equal(flat[r]["MIN_scaled"], want)


@pytest.mark.parametrize("dt", ["f32", "bf16", "i32"])
def test_sum_and_average(flat, inputs, dt):
    x = inputs[f"red_{dt}"]
    scale = np.abs(x.astype(np.float64)).sum(axis=0).max()
    for op in ("SUM", "AVERAGE"):
        want = _reduce_ref(x, dt, JT.ReduceOp[op])
        for r in range(K):
            got = _from_bits(flat[r][f"{op}_{dt}"], dt)
            assert got.dtype == want.dtype
            if dt == "i32":
                np.testing.assert_array_equal(got, want)
            else:
                _close(got, want, TOL_SUM[dt], scale)


# --------------------------------------------------------------- Adasum

@pytest.mark.parametrize("dt", ["f32", "bf16", "i32"])
@pytest.mark.parametrize("halving", [False, True])
def test_adasum_matches_reduce_block(flat, inputs, dt, halving):
    x = inputs[f"red_{dt}"]
    want = _adasum_ref(x, dt, halving)
    tag = "H" if halving else ""
    keys = [f"ADASUM{tag}_{dt}"] + ([] if halving else
                                    [f"grouped_ADASUM_{dt}"])
    for r in range(K):
        for key in keys:
            got = _from_bits(flat[r][key], dt)
            assert got.dtype == want.dtype
            if dt == "i32":
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                _close(got, want, TOL_ADASUM[dt],
                       np.abs(want.astype(np.float64)).max())
    # and the float64 numpy oracle, loosely: the same combination
    if dt == "f32":
        oracle = jadasum.adasum_numpy_reference(list(x))
        _close(want, oracle, 1e-5, np.abs(oracle).max())


@pytest.mark.parametrize("sname,members", [("s012", [0, 1, 2]),
                                           ("s02", [0, 2])])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("halving", [False, True])
def test_adasum_over_process_sets(flat, inputs, sname, members, dt,
                                  halving):
    """{0, 1, 2} runs the fold-in of rank 2 into rank 0 and the read-back."""
    x = inputs[f"red_{dt}"][members]
    want = _adasum_ref(x, dt, halving, k=len(members))
    tag = "H" if halving else ""
    for r in range(K):
        key = f"ADASUM{tag}_{sname}_{dt}"
        if r not in members:
            assert key not in flat[r]
            continue
        _close(_from_bits(flat[r][key], dt), want, TOL_ADASUM[dt],
               np.abs(want.astype(np.float64)).max())


def test_sum_and_broadcast_over_a_set(flat, inputs):
    x = inputs["red_f32"]
    want = _reduce_ref(x[[0, 2]], "f32", JT.ReduceOp.SUM, k=2)
    for r in (0, 2):
        np.testing.assert_array_equal(flat[r]["SUM_s02"], want)
        np.testing.assert_array_equal(flat[r]["bcast_s02"], x[2])
    for r in (1, 3):
        assert str(flat[r]["err:outside_set"]) == "HorovodError"


# ----------------------------------------------------------- allgather

@pytest.mark.parametrize("dt", ["f32", "i32"])
def test_uneven_allgather(flat, inputs, dt):
    want = np.concatenate(inputs[f"ag_{dt}"])
    assert want.shape == (sum(W.AG_ROWS), 3)
    for r in range(K):
        np.testing.assert_array_equal(flat[r][f"ag_{dt}"], want)


def test_grouped_and_even_allgather(flat, inputs):
    for r in range(K):
        np.testing.assert_array_equal(flat[r]["gag_0"],
                                      np.concatenate(inputs["ag_f32"]))
        np.testing.assert_array_equal(flat[r]["gag_1"],
                                      np.concatenate(inputs["ag2_f32"]))
        np.testing.assert_array_equal(
            flat[r]["ag_even"], np.concatenate(list(inputs["red_f32"])))


# ------------------------------------------------------- reducescatter

def _rs_ref(stacked, dt, op, pre=1.0, post=1.0):
    d0 = stacked.shape[1]
    y = _shard(lambda b: jcoll._rs_block(b[0], K, op, pre, post, d0)[None],
               stacked, JNP[dt])
    sizes = [d0 // K + (1 if i < d0 % K else 0) for i in range(K)]
    return [y[i][:sizes[i]] for i in range(K)]


@pytest.mark.parametrize("key", ["rs_even", "rs_uneven"])
@pytest.mark.parametrize("dt", ["f32", "bf16", "i32"])
@pytest.mark.parametrize("op", ["SUM", "AVERAGE"])
def test_reducescatter_matches_rs_block(flat, inputs, key, dt, op):
    x = inputs[f"{key}_{dt}"]
    want = _rs_ref(x, dt, JT.ReduceOp[op])
    scale = np.abs(x.astype(np.float64)).sum(axis=0).max()
    for r in range(K):
        got = flat[r][f"{key}_{op}_{dt}"]
        wdt = want[r].dtype
        got = got.view(jnp.bfloat16) if wdt == jnp.bfloat16 else got
        assert got.dtype == wdt, (got.dtype, wdt)  # int32 Average: float32
        if dt == "i32":
            np.testing.assert_array_equal(got, want[r])
        else:
            _close(got, want[r], TOL_SUM[dt], scale)


def test_reducescatter_scaled_and_grouped(flat, inputs):
    x = inputs["rs_uneven_f32"]
    scaled = _rs_ref(x, "f32", JT.ReduceOp.SUM, 0.5, 3.0)
    g0 = _rs_ref(inputs["rs_even_f32"], "f32", JT.ReduceOp.SUM)
    g1 = _rs_ref(inputs["rs_uneven_i32"], "i32", JT.ReduceOp.SUM)
    for r in range(K):
        _close(flat[r]["rs_scaled"], scaled[r], 1e-6,
               3 * np.abs(x).sum(axis=0).max())
        _close(flat[r]["grs_0"], g0[r], 1e-6,
               np.abs(inputs["rs_even_f32"]).sum(axis=0).max())
        np.testing.assert_array_equal(flat[r]["grs_1"], g1[r])
        assert str(flat[r]["err:rs_min"]) == "HorovodError"


# ------------------------------------------------------------ alltoall

def test_alltoall_with_splits(flat, inputs):
    sends = inputs["a2a_f32"]
    for j in range(K):
        pieces, recv = [], []
        for i in range(K):
            s = W.A2A_SPLITS[i]
            start = sum(s[:j])
            pieces.append(sends[i][start:start + s[j]])
            recv.append(s[j])
        np.testing.assert_array_equal(flat[j]["a2a"], np.concatenate(pieces))
        np.testing.assert_array_equal(flat[j]["a2a_recv"], recv)


def test_alltoall_even_and_refusal(flat, inputs):
    """Without splits, 8 rows go out 2 to each rank; 3 rows are refused
    (the JAX package's condition: dim 0 divisible by the set size)."""
    x = inputs["rs_even_f32"]
    for j in range(K):
        want = np.concatenate([x[i][2 * j:2 * j + 2] for i in range(K)])
        for key in ("a2a_even", "async_a2a"):
            np.testing.assert_array_equal(flat[j][key], want)
        np.testing.assert_array_equal(flat[j]["a2a_even_recv"], [2] * K)
        assert str(flat[j]["err:a2a_indivisible"]) == "HorovodError"


# ------------------------------------------- names and the async forms

def test_duplicate_name_while_in_flight(flat, inputs):
    want = _reduce_ref(inputs["red_f32"], "f32", JT.ReduceOp.AVERAGE)
    for r in range(K):
        assert str(flat[r]["err:dup_async"]) == "DuplicateNameError"
        assert str(flat[r]["err:dup_sync"]) == "DuplicateNameError"
        assert str(flat[r]["err:reuse_after_sync"]) == "none"
        _close(flat[r]["named_async"], want, 1e-6,
               np.abs(inputs["red_f32"]).sum(axis=0).max())


def test_async_forms(flat, inputs):
    x = inputs["red_f32"]
    rs = _rs_ref(inputs["rs_even_f32"], "f32", JT.ReduceOp.SUM)
    for r in range(K):
        np.testing.assert_array_equal(flat[r]["async_ag"],
                                      np.concatenate(inputs["ag_f32"]))
        _close(flat[r]["async_rs"], rs[r], 1e-6,
               np.abs(inputs["rs_even_f32"]).sum(axis=0).max())
        np.testing.assert_array_equal(flat[r]["async_bcast"], x[1])
        np.testing.assert_array_equal(flat[r]["async_grouped"],
                                      x.max(axis=0))
        np.testing.assert_array_equal(flat[r]["async_bucketed"],
                                      inputs["red_i32"].sum(axis=0))


# ---------------------------------------------------------- hierarchical

def _hier_ref(stacked, dt, op, pre=1.0, post=1.0):
    with jax.enable_x64(False):
        mesh = Mesh(np.array(jax.devices()[:K]).reshape(2, 2), ("dcn", "ici"))
        spec = P(("dcn", "ici"))
        fn = jax.jit(jax.shard_map(
            lambda b: jcoll._apply_reduce_hier(b, op, K, 2, pre, post),
            mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False))
        y = np.asarray(fn(jnp.asarray(stacked, JNP[dt])))
    return y[0]


def test_hier_split_and_cross_rank(hier):
    for r in range(K):
        np.testing.assert_array_equal(hier[r]["split"], [2, 2])
        np.testing.assert_array_equal(hier[r]["cross"], [0, 1, 1])


@pytest.mark.parametrize("dt", ["f32", "bf16", "i32"])
@pytest.mark.parametrize("op", ["SUM", "AVERAGE"])
def test_hierarchical_allreduce_matches_flat_and_reference(hier, inputs, dt,
                                                           op):
    """7 values a rank: padded to 8 for the local reduce-scatter."""
    x = inputs[f"h_{dt}"]
    want = _hier_ref(x, dt, JT.ReduceOp[op])
    scale = np.abs(x.astype(np.float64)).sum(axis=0).max()
    for r in range(K):
        got = _from_bits(hier[r][f"hier_{op}_{dt}"], dt)
        flat_ = _from_bits(hier[r][f"flat_{op}_{dt}"], dt)
        assert got.dtype == want.dtype
        if dt == "bf16":
            _close(got, want, TOL_SUM[dt], scale)
        else:
            np.testing.assert_array_equal(got, want)
        if dt == "i32":
            np.testing.assert_array_equal(flat_, got)
        else:
            _close(flat_, got, TOL_SUM[dt], scale)


@pytest.mark.parametrize("op", ["MIN", "MAX"])
def test_min_max_stay_flat_under_hierarchical(hier, inputs, op):
    for dt in ("f32", "bf16", "i32"):
        want = _bits(_reduce_ref(inputs[f"h_{dt}"], dt, JT.ReduceOp[op]))
        for r in range(K):
            np.testing.assert_array_equal(hier[r][f"hier_{op}_{dt}"], want)
            np.testing.assert_array_equal(hier[r][f"flat_{op}_{dt}"], want)


def test_hierarchical_grouped_and_scaled(hier, inputs):
    g0 = _hier_ref(inputs["h_f32"], "f32", JT.ReduceOp.SUM)
    g1 = _hier_ref(inputs["h2_f32"], "f32", JT.ReduceOp.SUM)
    sc = _hier_ref(inputs["h_f32"], "f32", JT.ReduceOp.AVERAGE, 0.5, 3.0)
    for r in range(K):
        np.testing.assert_array_equal(hier[r]["hier_grouped_0"], g0)
        np.testing.assert_array_equal(hier[r]["hier_grouped_1"], g1)
        np.testing.assert_array_equal(hier[r]["hier_scaled"], sc)


def test_hierarchical_allgather(hier, inputs):
    for r in range(K):
        even = np.concatenate(list(inputs["hag_f32"]))
        np.testing.assert_array_equal(hier[r]["hier_ag"], even)
        np.testing.assert_array_equal(hier[r]["flat_ag"], even)
        uneven = np.concatenate(inputs["ag_f32"])
        np.testing.assert_array_equal(hier[r]["hier_ag_uneven"], uneven)
        np.testing.assert_array_equal(hier[r]["flat_ag_uneven"], uneven)


# ----------------------------------------------------- single process

@pytest.mark.parametrize("op", [hvd.Adasum, hvd.Min, hvd.Max, hvd.Product])
def test_optimizer_refuses_unported_ops(op):
    """The optimizer once refused these ops; now it takes each and never
    silently sums: Adasum reduces tensor by tensor at the step (its dots
    are per tensor), Min, Max and Product ride the buckets. In a world
    of one each reduce gives the gradient back, bit for bit."""
    hvd.init(device="cpu")
    try:
        model = torch.nn.Linear(2, 2)
        opt = DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), op=op)
        assert opt.op == op and opt.hooked == (op != hvd.Adasum)
        model(torch.ones(3, 2)).pow(2).sum().backward()
        want = [p.grad.clone() for p in model.parameters()]
        opt.synchronize()
        for p, w in zip(model.parameters(), want):
            assert torch.equal(p.grad, w)
        assert opt.collectives_per_step == (2 if op == hvd.Adasum else 1)
    finally:
        hvd.shutdown()


def test_reduce_op_and_dtypes_match_jax():
    from horovod_tpu_torch.common import types as TT
    assert {m.name: int(m) for m in TT.ReduceOp} == \
        {m.name: int(m) for m in JT.ReduceOp}
    for name in ("Average", "Sum", "Adasum", "Min", "Max", "Product"):
        assert int(getattr(TT, name)) == int(getattr(JT, name))
        assert TT.normalize_reduce_op(name) == JT.normalize_reduce_op(name)
    for good in (torch.bfloat16, torch.int8, torch.bool, torch.float64):
        TT.check_supported_dtype(good)
    with pytest.raises(ValueError):
        TT.check_supported_dtype(torch.complex64)
    with pytest.raises(ValueError):
        JT.check_supported_dtype(jnp.complex64)


def test_collective_bench_runs_on_both_worlds(flat, hier):
    """horovod_tpu_torch.collective_bench (the card's phase 7 and the
    four-card bus GB/s) ran in both worlds: its numpy checks passed
    (they raise otherwise), with the hierarchical ones where the groups
    exist, and its timing covered each op."""
    for r in range(K):
        names = set(flat[r]["bench_check"].tolist())
        assert {"allgather_uneven", "alltoall_splits", "product_bf16"} <= names
        assert ("adasum_set012" in names) == (r < 3)  # members only
        assert not any(n.startswith("hier_") for n in names)
        hnames = set(hier[r]["bench_check"].tolist())
        assert {"hier_sum_f32", "hier_vs_flat_bf16",
                "hier_allgather"} <= hnames
        assert hier[r]["bench_ops"].tolist() == [
            "allgather", "allreduce_flat", "allreduce_hier", "alltoall"]
