"""The rest of the torch API surface in the PyTorch package: the in-place
and grouped async collectives, the build and query calls, the names of
the JAX package's APIs, and the count-weighted SyncBatchNorm.

Spawned gloo worlds of 2 (tests/torch_api_worker.py, one 90 s deadline
each through tests/torch_world_worker.py):
  * every in-place form (allreduce_ with Average, Sum, Max, Product and
    Adasum, with scale factors and on a transposed view;
    grouped_allreduce_ with a transposed member; broadcast_; the
    `_async_` forms) leaves the caller's tensor object, in its own
    storage, holding exactly what the out-of-place form returns, in f32,
    bf16 and int32; the out-of-place results against numpy;
    grouped_allgather_async and grouped_reducescatter_async equal their
    synchronous forms; an in-place async name in flight refuses a
    second op of that name;
  * SyncBatchNorm with per-rank batches of 3 and 5 (f32, NHWC, random
    scale and bias): the outputs, the running stats, and the gradients
    of x, scale and bias (the ranks' scale and bias gradients summed,
    as the optimizer's all-reduce would) against the JAX package's
    `sync_batch_norm` over the concatenated batch of 8 on a one-device
    mesh, and the running stats against its eager `SyncBatchNorm`; then
    with equal batches of 4 against the port's pmean `batch_norm`.
Tolerances: the outputs and input gradients within 1e-5 of the largest
magnitude and the stats within 1e-6 (f32 sums of 8·4·4 values in other
orders); the in-place forms bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu
import horovod_tpu.frontends.torch as jtorch
import horovod_tpu_torch as hvd
import torch_api_worker as W
import torch_collectives_worker as CW
from horovod_tpu.ops import sync_batch_norm as jsbn
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.ops import sync_batch_norm as sbn

K = 2
TOL = 1e-5       # outputs and gradients, of the largest magnitude
TOL_STATS = 1e-6  # means and vars, of the largest magnitude


def _bf16_bits(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16)


def _api_inputs():
    rng = np.random.default_rng(0)
    out = {}
    for dt in W.DTYPES:
        for key, shape in (("x", (K, 37, 5)), ("x2", (K, 6, 3))):
            if dt == "i32":
                out[f"{key}_{dt}"] = rng.integers(-9, 10, shape).astype(
                    np.int32)
            elif dt == "bf16":
                out[f"bf16:{key}_{dt}"] = _bf16_bits(
                    rng.standard_normal(shape).astype(np.float32))
            else:
                out[f"{key}_{dt}"] = rng.standard_normal(shape).astype(
                    np.float32)
    return out


@pytest.fixture(scope="module")
def api(tmp_path_factory):
    inputs = _api_inputs()
    res = CW.spawn(W.run_api, tmp_path_factory.mktemp("api"), inputs, k=K,
                   timeout=90)
    return inputs, res


def _keys(prefix):
    out = []
    for dt in W.DTYPES:
        ops = W.OPS if dt != "i32" else W.OPS[:4]
        out += [(f"{prefix}_{op}_{dt}") for op in ops]
    return out


@pytest.mark.parametrize("key", _keys("ip") + _keys("aip"))
def test_inplace_allreduce_holds_the_out_of_place_result(api, key):
    _, res = api
    oop = "oop_" + key.split("_", 1)[1]
    same = key.replace("ip_", "same_", 1)
    for r in res:
        assert bool(r[same]), f"{key}: not the caller's tensor object"
        np.testing.assert_array_equal(r[key], r[oop])


@pytest.mark.parametrize("dt", W.DTYPES)
def test_inplace_forms_write_into_the_callers_tensors(api, dt):
    _, res = api
    for r in res:
        for flag in ("gsame", "gasame", "gaeq", "bsame", "basame",
                     "same_view"):
            assert bool(r[f"{flag}_{dt}"]), flag
        for i in range(3):
            np.testing.assert_array_equal(r[f"gip{i}_{dt}"],
                                          r[f"goop{i}_{dt}"])
        np.testing.assert_array_equal(r[f"bip_{dt}"], r[f"boop_{dt}"])
        np.testing.assert_array_equal(r[f"baip_{dt}"], r[f"boop_{dt}"])
        np.testing.assert_array_equal(r[f"ip_view_{dt}"],
                                      r[f"oop_SUM_{dt}"])
        if dt != "i32":
            np.testing.assert_array_equal(r[f"ip_scaled_{dt}"],
                                          r[f"oop_scaled_{dt}"])
        for i in range(2):
            np.testing.assert_array_equal(r[f"gag_async{i}_{dt}"],
                                          r[f"gag_sync{i}_{dt}"])
            np.testing.assert_array_equal(r[f"grs_async{i}_{dt}"],
                                          r[f"grs_sync{i}_{dt}"])


@pytest.mark.parametrize("dt", ["f32", "i32"])
def test_out_of_place_results_against_numpy(api, dt):
    inputs, res = api
    x = inputs[f"x_{dt}"]
    want = {"SUM": x[0] + x[1], "MAX": np.maximum(x[0], x[1]),
            "PRODUCT": x[0] * x[1],
            "AVERAGE": (x[0] + x[1]) // 2 if dt == "i32"
            else (x[0] + x[1]) / np.float32(2)}
    for r in res:
        for op, w in want.items():
            np.testing.assert_array_equal(r[f"oop_{op}_{dt}"], w)
        np.testing.assert_array_equal(r[f"boop_{dt}"], x[1])
        np.testing.assert_array_equal(r[f"grs_sync0_{dt}"],
                                      (x[0] + x[1])[:19] if r is res[0]
                                      else (x[0] + x[1])[19:])


def test_inplace_async_name_is_held_until_synchronize(api):
    _, res = api
    assert [str(r["dup"]) for r in res] == ["DuplicateNameError"] * K


def test_build_queries_in_a_gloo_world(api):
    _, res = api
    for rank, r in enumerate(res):
        assert bool(r["gloo_enabled"]) and not bool(r["mpi_enabled"])
        assert r["local_slot_ranks"].tolist() == [rank]


def test_build_queries_answer_from_torchs_build():
    assert hvd.nccl_built() == dist.is_nccl_available()
    assert hvd.gloo_built() == dist.is_gloo_available()
    assert hvd.mpi_built() == dist.is_mpi_available()
    assert hvd.cuda_built() == (torch.version.cuda is not None)
    assert hvd.rocm_built() == (getattr(torch.version, "hip", None)
                                is not None)
    for fn in (hvd.tpu_built, hvd.ccl_built, hvd.ddl_built,
               hvd.mpi_threads_supported):
        assert fn() is False


def test_enabled_queries_before_init_and_local_slot_ranks_needs_init():
    hvd.shutdown()
    assert hvd.gloo_enabled() is False and hvd.mpi_enabled() is False
    with pytest.raises(hvd.HorovodError):
        hvd.local_slot_ranks()


# JAX-only names, or names that another ROADMAP item ports; each with
# its reason.
EXCEPTED = {
    "mesh": "the JAX device mesh; the port's is hybrid_mesh()",
    "ensure_jax_api": "JAX API drift shim",
    "DistributedGradientTransform": "optax only",
    "HorovodTpuError": "the port's base class is HorovodError",
}
# Imports of the two JAX modules, not part of the Horovod API.
NOT_API = {"annotations", "Any", "Iterable", "Optional", "Tuple"}


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")
            and not type(getattr(module, n)).__name__ == "module"}


@pytest.mark.parametrize("module", [jtorch, horovod_tpu],
                         ids=["frontends.torch", "horovod_tpu"])
def test_every_horovod_name_exists_in_the_port(module):
    missing = _public(module) - NOT_API - set(EXCEPTED) - _public(hvd)
    assert not missing, sorted(missing)
    assert set(EXCEPTED) <= _public(jtorch) | _public(horovod_tpu)


FRONTENDS = ["torch", "torch_elastic", "tensorflow", "tensorflow_elastic",
             "keras", "mxnet"]


@pytest.mark.parametrize("name", FRONTENDS)
def test_every_frontend_name_exists_in_the_port(name):
    """Each JAX frontend module's public names are the port's module's
    too (horovod_tpu_torch/frontends/, without importing the framework);
    typing names are imports, not API."""
    import importlib
    jmod = importlib.import_module(f"horovod_tpu.frontends.{name}")
    tmod = importlib.import_module(f"horovod_tpu_torch.frontends.{name}")
    typing_names = {"Any", "Dict", "Iterable", "Iterator", "List",
                    "Optional", "Tuple", "annotations"}
    missing = _public(jmod) - typing_names - _public(tmod)
    assert not missing, sorted(missing)


def test_status_matches_the_jax_package():
    from horovod_tpu.common import types as jtypes
    assert [(m.name, m.value) for m in hvd.StatusType] == \
        [(m.name, m.value) for m in jtypes.StatusType]
    s = hvd.Status.InvalidArgument("bad")
    assert (s.type.value, s.reason, s.ok()) == (4, "bad", False)
    assert hvd.Status.OK().ok() and hvd.Status.InProgress().in_progress()
    assert hvd.broadcast_variables is hvd.broadcast_parameters


# ------------------------------------------------------------ SyncBatchNorm

C = 6
BATCHES = (3, 5)


def _sbn_inputs():
    rng = np.random.default_rng(1)
    out = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
           "bias": rng.normal(0, 0.5, C).astype(np.float32)}
    for r, n in enumerate(BATCHES):
        # a per-channel offset, so that E[x]² is not small against var
        out[f"x{r}"] = (rng.standard_normal((n, 4, 4, C)) * 2 +
                        np.arange(C)).astype(np.float32)
        out[f"ct{r}"] = rng.standard_normal((n, 4, 4, C)).astype(np.float32)
        out[f"xe{r}"] = rng.standard_normal((4, 4, 4, C)).astype(np.float32)
        out[f"cte{r}"] = rng.standard_normal((4, 4, 4, C)).astype(
            np.float32)
    return out


@pytest.fixture(scope="module")
def sbn_world(tmp_path_factory):
    inputs = _sbn_inputs()
    res = CW.spawn(W.run_sbn, tmp_path_factory.mktemp("sbn"), inputs, k=K,
                   timeout=90)
    return inputs, res


def _jax_reference(inputs):
    """The JAX package's sync_batch_norm over the concatenated batch on a
    one-device mesh: (out, mean, var) and the gradients of
    sum(out * ct) for x, scale and bias; and its eager SyncBatchNorm's
    running stats after one call on that batch."""
    x = np.concatenate([inputs[f"x{r}"] for r in range(K)])
    ct = np.concatenate([inputs[f"ct{r}"] for r in range(K)])
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))
    f = jax.shard_map(
        lambda x, s, b: jsbn.sync_batch_norm(x, s, b, axis_name="hvd"),
        mesh=mesh, in_specs=(P(), P(), P()), out_specs=(P(), P(), P()),
        check_vma=False)
    args = (jnp.asarray(x), jnp.asarray(inputs["scale"]),
            jnp.asarray(inputs["bias"]))
    out, mean, var = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a)[0] * ct),
                     argnums=(0, 1, 2))(*args)
    was = horovod_tpu.is_initialized()
    if not was:
        horovod_tpu.init()
    try:
        layer = jsbn.SyncBatchNorm(C)
        layer.scale = jnp.asarray(inputs["scale"])
        layer.bias = jnp.asarray(inputs["bias"])
        eager = np.asarray(layer(jnp.asarray(x)))
        running = (np.asarray(layer.running_mean),
                   np.asarray(layer.running_var))
    finally:
        if not was:
            horovod_tpu.shutdown()
    return dict(out=np.asarray(out), eager=eager, mean=np.asarray(mean),
                var=np.asarray(var), dx=np.asarray(grads[0]),
                dscale=np.asarray(grads[1]), dbias=np.asarray(grads[2]),
                running=running)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (what, err)


def _split(a):
    return np.split(a, np.cumsum(BATCHES)[:-1])


def test_sync_batch_norm_uneven_batches_match_one_bn_over_all(sbn_world):
    inputs, res = sbn_world
    ref = _jax_reference(inputs)
    _close(ref["eager"], ref["out"], TOL, "JAX eager against shard_map")
    for r, (out, dx) in enumerate(zip(_split(ref["out"]),
                                      _split(ref["dx"]))):
        _close(res[r]["out"], out, TOL, f"rank {r} output")
        _close(res[r]["dx"], dx, TOL, f"rank {r} dx")
    _close(sum(r["dscale"] for r in res), ref["dscale"], TOL, "dscale")
    _close(sum(r["dbias"] for r in res), ref["dbias"], TOL, "dbias")
    for r in res:
        _close(r["running_mean"], 0.1 * ref["mean"], TOL_STATS, "mean")
        _close(r["running_var"], 0.9 + 0.1 * ref["var"], TOL_STATS, "var")
        _close(r["running_mean"], ref["running"][0], TOL_STATS,
               "mean vs eager SyncBatchNorm")
        _close(r["running_var"], ref["running"][1], TOL_STATS,
               "var vs eager SyncBatchNorm")


def test_sync_batch_norm_eval_mode_uses_the_running_stats(sbn_world):
    inputs, res = sbn_world
    for r in range(K):
        x = inputs[f"x{r}"]
        m, v = res[r]["running_mean"], res[r]["running_var"]
        want = (x - m) * (1 / np.sqrt(v + 1e-5)) * inputs["scale"] + \
            inputs["bias"]
        _close(res[r]["eval_out"], want, TOL, f"rank {r} eval output")


def test_equal_batches_match_the_pmean_batch_norm(sbn_world):
    _, res = sbn_world
    for r in res:
        _close(r["eq_sync"], r["eq_pmean"], TOL, "output")
        _close(r["eq_dx_sync"], r["eq_dx_pmean"], TOL, "dx")
        _close(r["eq_rm_sync"], r["eq_rm_pmean"], TOL_STATS, "mean")
        _close(r["eq_rv_sync"], r["eq_rv_pmean"], TOL_STATS, "var")


@pytest.fixture()
def world_of_one(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
              "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
              "HOROVOD_CROSS_SIZE", "HOROVOD_COORDINATOR_ADDR",
              "HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_GLOO_RENDEZVOUS_PORT"):
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_sync_batch_norm_in_a_world_of_one_is_the_jax_formula_bn(
        world_of_one):
    """SyncBatchNorm in a world of 1 against the port's batch_norm with
    no group (the JAX models' formula), forward and backward, and the
    layer's conventions: momentum 0.9, the biased var, bf16 normalised
    in bf16."""
    assert hvd.gloo_enabled() and hvd.local_slot_ranks() == [0]
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((4, 3, 3, C)).astype(np.float32)
                     + 1.0, requires_grad=True)
    x2 = x.detach().clone().requires_grad_()
    layer = hvd.SyncBatchNorm(C)
    y = layer(x)
    want, (m, v) = sbn.batch_norm(x2, layer.scale.detach(),
                                  layer.bias.detach(), torch.zeros(C),
                                  torch.ones(C), True)
    _close(y.detach(), want.detach(), TOL, "output")
    ct = torch.tensor(rng.standard_normal(y.shape).astype(np.float32))
    (y * ct).sum().backward()
    (want * ct).sum().backward()
    _close(x.grad, x2.grad, TOL, "dx")
    _close(layer.running_mean, m, TOL_STATS, "running mean")
    _close(layer.running_var, v, TOL_STATS, "running var")
    var = x.detach().double().var(dim=(0, 1, 2), unbiased=False)
    _close(layer.running_var, 0.9 + 0.1 * var, TOL_STATS, "biased var")
    yb = hvd.SyncBatchNorm(C)(x.detach().bfloat16())
    assert yb.dtype == torch.bfloat16
    assert topology.size() == 1
