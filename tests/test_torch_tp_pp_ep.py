"""Tensor, pipeline and expert parallelism of the PyTorch package, and
remat, against the JAX package's functions on the same numpy inputs
(the contract of tests/test_parallel.py:105-251 and the transformer
axis variants of tests/test_gspmd.py).

One spawned gloo world of 4 ranks under HOROVOD_MESH="dp=2,tp=2"
(tests/torch_tp_pp_ep_worker.py through tests/torch_world_worker.py:
one deadline, FileStore under tmp_path), spawned once for this module;
it builds the other meshes inside the world and runs every case in
turn. While it runs, the parent computes the JAX references under
jax.shard_map on the CPU mesh of tests/conftest.py, in threads:

* pipeline_apply at dp=2 x pp=2 (tests/test_parallel.py's stack of 8
  tanh layers, 4 microbatches of 2 rows, D 16) against the sequential
  oracle and JAX's pipeline_apply on the same mesh, with the gradients
  of Σ y² through the reverse schedule: 2e-5 (rtol and atol);
* moe_ffn at dp=2 x ep=2 (T 32, D 8, F 16, E 8) with no drops
  (capacity_factor 64) against the dense top-1 oracle and JAX's
  moe_ffn, and with drops (capacity_factor 1.0) against JAX's moe_ffn,
  with the gradients of Σ out²: 2e-4. Both sides first route and keep
  the same tokens; the input's least top-1/top-2 probability margin is
  asserted well above f32 rounding and printed;
* the LM (L4 D32 H4 F64 S16 V64, f32, attn="local", B 8) from the JAX
  weights, trained by SGD(1e-2) through the sharded step of
  DistributedOptimizer(sharding_spec=..., op=Sum) at dp=2 x tp=2,
  dp=2 x pp=2 (M 2), dp=2 x ep=2 (E 4, capacity_factor 64: nothing
  dropped; and at the default 2.0, where each rank's capacity drops
  tokens), pp=2 x tp=2 (M 2, remat "dots"), and at dp=4 with the pp
  and ep cases' configs: the first step's loss against
  build_loss_and_grads on the same mesh and, where no token drops, on
  one device (1e-4), every rank's reduced gradient shard against JAX's
  (5e-4, rtol and atol), the losses of 3 steps against build_train_step
  (1e-4) and the port's pp=2 and ep=2 trajectories against its dp=4
  ones (5e-4, tests/test_gspmd.py's axis variants); the weights after
  them within 1e-5;
* remat "dots" and "full" at dp=2 x tp=2: loss and reduced gradients
  equal to the run without remat, bit for bit (the recompute re-runs the
  same operations on the same inputs);
* the LM's pp- and ep-sharded leaves (pp=2 x ep=2, 4 experts) saved by
  ckpt/sharded.py fragments, one writer a shard, and restored: equal to
  the JAX weights bit for bit, and cut again for dp=2 x tp=2.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

import torch_tp_pp_ep_worker as W
from torch_world_worker import start_world
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import MeshSpec, build_mesh, moe_ffn, \
    pipeline_apply
from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.parallel import mesh as tmesh

SMALL = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=4,
             max_seq=64, attn="local")
B, S, LR, STEPS = 8, 16, 1e-2, 3
TOL_PIPE, TOL_MOE, TOL_LOSS, TOL_GRAD = 2e-5, 2e-4, 1e-4, 5e-4

# name -> (mesh, config fields, steps)
LM_CASES = {
    "tp": ("dp=2,tp=2", {}, STEPS),
    "tp_dots": ("dp=2,tp=2", dict(remat=True), 1),
    "tp_full": ("dp=2,tp=2", dict(remat=True, remat_policy="full"), 1),
    "pp": ("dp=2,pp=2", dict(microbatches=2), STEPS),
    "pp_ref": ("dp=4", dict(microbatches=2), STEPS),
    "ep": ("dp=2,ep=2", dict(num_experts=4, capacity_factor=64.0), STEPS),
    "ep_ref": ("dp=4", dict(num_experts=4, capacity_factor=64.0), STEPS),
    "ep_drop": ("dp=2,ep=2", dict(num_experts=4), 1),
    "pp_tp_dots": ("pp=2,tp=2", dict(microbatches=2, remat=True), 1),
}
# with the JAX reference on the same mesh
JAX_CASES = ("tp", "pp", "ep", "ep_drop", "pp_tp_dots")


def _jmesh(text):
    spec = MeshSpec.parse(text)
    return build_mesh(spec, jax.devices()[:spec.total])


def _tmesh(text):
    spec = tmesh.MeshSpec.parse(text, 4)
    return tmesh.Mesh(spec, np.arange(4).reshape(spec.sizes()))


def _lm_inputs(kw):
    cfg = jtfm.TransformerConfig(**SMALL, **kw, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jtfm.init(
        jax.random.PRNGKey(0), cfg))
    return cfg, params


TOKENS = np.random.default_rng(7).integers(0, SMALL["vocab"], (B, S))


def _jax_lm(name):
    """JAX's loss and gradients on the case's mesh and on one device
    (microbatches 1), and the losses and weights of STEPS SGD steps."""
    text, kw, steps = LM_CASES[name]
    cfg, params = _lm_inputs(kw)
    tok = jnp.asarray(TOKENS)
    tgt = jnp.roll(tok, -1, axis=1)
    mesh = _jmesh(text)
    jtfm.validate_cfg_for_mesh(cfg, mesh)
    loss, grads = jax.jit(jtfm.build_loss_and_grads(cfg, mesh))(
        jtfm.shard_params(params, cfg, mesh), tok, tgt)
    one = dataclasses.replace(cfg, microbatches=1)
    loss1, _ = jax.jit(jtfm.build_loss_and_grads(
        one, _jmesh("dp=1")))(params, tok, tgt)
    step = jtfm.build_train_step(cfg, mesh, optax.sgd(LR))
    p = jtfm.shard_params(params, cfg, mesh)
    st = optax.sgd(LR).init(p)
    losses = []
    for _ in range(steps):
        p, st, lv = step(p, st, tok, tgt)
        losses.append(float(lv))
    return dict(loss=float(loss), loss1=float(loss1), losses=losses,
                grads=convert.transformer_from_jax(
                    jax.tree_util.tree_map(np.asarray, grads)),
                state=convert.transformer_from_jax(
                    jax.tree_util.tree_map(np.asarray, p)))


# ------------------------------------------------ pipeline and MoE inputs

PP_L, PP_M, PP_MB, PP_D = 8, 4, 2, 16


def _pipe_inputs():
    rng = np.random.default_rng(3)
    ws = (rng.standard_normal((PP_L, PP_D, PP_D)) / PP_D ** 0.5).astype(
        np.float32)
    x = rng.standard_normal((PP_M, PP_MB, PP_D)).astype(np.float32)
    return ws, x


def _jax_pipeline():
    ws, x = (jnp.asarray(a) for a in _pipe_inputs())

    def layer(a, w):
        return jnp.tanh(a @ w), None

    def seq(ws_, x_):
        return jax.vmap(lambda xm: lax.scan(layer, xm, ws_)[0])(x_)

    oracle = seq(ws, x)
    dws, dx = jax.grad(lambda a, b: jnp.sum(seq(a, b) ** 2),
                       argnums=(0, 1))(ws, x)

    def run(w, xm):
        y = pipeline_apply(lambda sw, act: lax.scan(layer, act, sw)[0], w,
                           xm, "pp")
        return lax.psum(y, "pp")

    got = jax.jit(jax.shard_map(run, mesh=_jmesh("dp=2,pp=2"),
                                in_specs=(P("pp"), P()), out_specs=P(),
                                check_vma=False))(ws, x)
    return dict(oracle=np.asarray(oracle), jax=np.asarray(got),
                dws=np.asarray(dws), dx=np.asarray(dx))


MOE_T, MOE_D, MOE_F, MOE_E = 32, 8, 16, 8
MOE_CF = {"moe": 64.0, "moe_drop": 1.0}


def _moe_inputs():
    ks = jax.random.split(jax.random.PRNGKey(5), 4)
    x = jax.random.normal(ks[0], (MOE_T, MOE_D))
    router = jax.random.normal(ks[1], (MOE_D, MOE_E))
    w1 = jax.random.normal(ks[2], (MOE_E, MOE_D, MOE_F)) / MOE_D ** 0.5
    w2 = jax.random.normal(ks[3], (MOE_E, MOE_F, MOE_D)) / MOE_F ** 0.5
    return [np.asarray(a) for a in (x, router, w1, w2)]


def _jax_moe(cf):
    """JAX's moe_ffn at ep=2 (tokens sharded over ep) with its gradients
    of Σ out², its routing, and the dense no-drop oracle."""
    x, router, w1, w2 = (jnp.asarray(a) for a in _moe_inputs())
    mesh = _jmesh("dp=2,ep=2")

    def f(xx, r, a, b):
        return moe_ffn(xx, r, a, b, "ep", capacity_factor=cf)

    specs = (P("ep"), P(), P("ep"), P("ep"))
    fn = jax.shard_map(f, mesh=mesh, in_specs=specs, out_specs=P("ep"),
                       check_vma=False)

    def loss(*args):
        return jnp.sum(fn(*args) ** 2)

    out = jax.jit(fn)(x, router, w1, w2)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(x, router, w1,
                                                          w2)
    probs = jax.nn.softmax(x @ router, -1)
    eidx = jnp.argmax(probs, -1)
    h = jax.nn.gelu(jnp.einsum("td,edf->tef", x, w1))
    y_all = jnp.einsum("tef,efd->ted", h, w2)
    oracle = y_all[jnp.arange(MOE_T), eidx] * jnp.max(probs, -1)[:, None]
    return dict(out=np.asarray(out), oracle=np.asarray(oracle),
                expert=np.asarray(eidx), grads=[np.asarray(g)
                                                for g in grads])


def _jax_keep(expert, cf):
    """Which tokens JAX's moe_ffn keeps: the cumsum slot rule on each
    ep rank's block of T/2 tokens."""
    keep = []
    for blk in np.split(expert, 2):
        onehot = np.eye(MOE_E)[blk]
        pos = (np.cumsum(onehot, 0) - 1) * onehot
        cap = max(1, int(cf * blk.shape[0] / MOE_E))
        keep.append(((pos < cap) & (onehot > 0)).any(-1))
    return np.concatenate(keep)


# ------------------------------------------------------------ the world

CKPT_KW = dict(num_experts=4, microbatches=2)


def _cases(root):
    cases = {"pipeline": ("pipeline", "dp=2,pp=2", _pipe_inputs()),
             "ckpt": ("ckpt", "pp=2,ep=2", (
                 {**SMALL, **CKPT_KW}, _lm_inputs(CKPT_KW)[1], root))}
    for name, cf in MOE_CF.items():
        cases[name] = ("moe", "dp=2,ep=2", (*_moe_inputs(), cf))
    for name, (text, kw, steps) in LM_CASES.items():
        cfg_kw = {k: v for k, v in {**SMALL, **kw}.items()}
        cases[name] = ("lm", text, (cfg_kw, _lm_inputs(kw)[1], TOKENS,
                                    steps, LR))
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_pp_ep")
    outs = [str(tmp / f"rank{r}.npz") for r in range(4)]
    cases = _cases(str(tmp / "ckpt"))
    w = start_world(W.run_lm, [(r, 4, str(tmp / "store"), cases,
                                outs[r]) for r in range(4)], tmp,
                    deadline=150.0)
    jobs = {"pipeline": _jax_pipeline,
            **{n: (lambda cf=cf: _jax_moe(cf)) for n, cf in MOE_CF.items()},
            **{n: (lambda n=n: _jax_lm(n)) for n in JAX_CASES}}
    with ThreadPoolExecutor(4) as pool:  # XLA compiles off the GIL
        futs = {n: pool.submit(f) for n, f in jobs.items()}
        want = {n: f.result() for n, f in futs.items()}
    w.join()
    return [dict(np.load(o)) for o in outs], want


# ------------------------------------------------------------- pipeline

def test_pipeline_matches_sequential_and_jax(world):
    res, want = world
    w = want["pipeline"]
    last = res[1]  # (dp 0, pp 1): the last stage of its pipeline
    np.testing.assert_allclose(last["pipeline/y"], w["oracle"],
                               rtol=TOL_PIPE, atol=TOL_PIPE)
    np.testing.assert_allclose(last["pipeline/y"], w["jax"],
                               rtol=TOL_PIPE, atol=TOL_PIPE)
    assert not res[0]["pipeline/y"].any()  # other stages emit zeros


def test_pipeline_backward_runs_the_reverse_schedule(world):
    """Each stage's weight gradient is its slice of the oracle's; the
    input's gradient arrives at stage 0 (the others get zeros)."""
    res, want = world
    w = want["pipeline"]
    half = PP_L // 2
    for r in range(4):
        stage = r % 2
        np.testing.assert_allclose(
            res[r]["pipeline/dw"], w["dws"][stage * half:(stage + 1) * half],
            rtol=TOL_PIPE, atol=TOL_PIPE)
    np.testing.assert_allclose(res[0]["pipeline/dx"], w["dx"],
                               rtol=TOL_PIPE, atol=TOL_PIPE)
    assert not res[1]["pipeline/dx"].any()


# ------------------------------------------------------------------ MoE

def test_moe_routing_margin_and_agreement(world):
    """No near-tie can flip a route between the two packages: the least
    top-1/top-2 probability margin of the seeded input is far above f32
    rounding, and both sides send and keep the same tokens."""
    res, want = world
    x, router = _moe_inputs()[:2]
    logits = x.astype(np.float64) @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = np.sort(probs, -1)
    margin = float((top[:, -1] - top[:, -2]).min())
    print(f"least top-1/top-2 margin of the MoE input: {margin:.3g}")
    assert margin > 1e-4
    for name, cf in MOE_CF.items():
        expert = np.concatenate([res[r][f"{name}/expert"] for r in (0, 1)])
        keep = np.concatenate([res[r][f"{name}/keep"] for r in (0, 1)])
        np.testing.assert_array_equal(expert, want[name]["expert"])
        np.testing.assert_array_equal(keep, _jax_keep(want[name]["expert"],
                                                      cf))
    assert not np.concatenate([res[r]["moe_drop/keep"]
                               for r in (0, 1)]).all()  # some drop


@pytest.mark.parametrize("name", list(MOE_CF))
def test_moe_sharded_matches_jax(world, name):
    res, want = world
    out = np.concatenate([res[r][f"{name}/out"] for r in (0, 1)])
    np.testing.assert_allclose(out, want[name]["out"], rtol=TOL_MOE,
                               atol=TOL_MOE)
    if name == "moe":  # nothing dropped: the dense oracle
        np.testing.assert_allclose(out, want[name]["oracle"], rtol=TOL_MOE,
                                   atol=TOL_MOE)
    dx, dr, dw1, dw2 = want[name]["grads"]
    got_dx = np.concatenate([res[r][f"{name}/dx"] for r in (0, 1)])
    np.testing.assert_allclose(got_dx, dx, rtol=TOL_MOE, atol=TOL_MOE)
    # the router is replicated: JAX's gradient is the sum of the ranks'
    np.testing.assert_allclose(res[0][f"{name}/drouter"] +
                               res[1][f"{name}/drouter"], dr,
                               rtol=TOL_MOE, atol=TOL_MOE)
    for r in (0, 1):
        n = MOE_E // 2
        np.testing.assert_allclose(res[r][f"{name}/dw1"],
                                   dw1[r * n:(r + 1) * n], rtol=TOL_MOE,
                                   atol=TOL_MOE)
        np.testing.assert_allclose(res[r][f"{name}/dw2"],
                                   dw2[r * n:(r + 1) * n], rtol=TOL_MOE,
                                   atol=TOL_MOE)


# -------------------------------------------------------------- the LM

def _cfg(name):
    return ttfm.TransformerConfig(**SMALL, **LM_CASES[name][1])


@pytest.mark.parametrize("name", JAX_CASES)
def test_lm_first_loss_matches_jax_and_one_device(world, name):
    res, want = world
    for r in res:
        np.testing.assert_allclose(float(r[f"{name}/loss0"]),
                                   want[name]["loss"], rtol=TOL_LOSS)
        if name != "ep_drop":  # capacity per rank drops other tokens
            np.testing.assert_allclose(float(r[f"{name}/loss0"]),
                                       want[name]["loss1"], rtol=TOL_LOSS)


@pytest.mark.parametrize("name", JAX_CASES)
def test_lm_reduced_gradients_match_jax(world, name):
    """Every rank's gradient shard after the sharded reduction is its
    block of JAX's reduced global gradient: expert leaves (reduced over
    dp and tp, not ep) and tp-sharded ones (divided by tp) included."""
    res, want = world
    mesh = _tmesh(LM_CASES[name][0])
    for r in range(4):
        shard = ttfm.shard_state(want[name]["grads"], _cfg(name), mesh, r)
        got = {k[len(name) + 6:]: v for k, v in res[r].items()
               if k.startswith(f"{name}/grad/")}
        assert set(got) == set(shard)
        for k, w in shard.items():
            np.testing.assert_allclose(got[k], w, rtol=TOL_GRAD,
                                       atol=TOL_GRAD, err_msg=f"{r} {k}")


@pytest.mark.parametrize("name", [n for n in JAX_CASES
                                  if LM_CASES[n][2] > 1])
def test_lm_sgd_trajectory_matches_jax(world, name):
    res, want = world
    mesh = _tmesh(LM_CASES[name][0])
    for r in range(4):
        got = [float(res[r][f"{name}/loss{i}"])
               for i in range(LM_CASES[name][2])]
        np.testing.assert_allclose(got, want[name]["losses"], rtol=TOL_LOSS)
        state = ttfm.shard_state(want[name]["state"], _cfg(name), mesh, r)
        for k, w in state.items():
            np.testing.assert_allclose(res[r][f"{name}/state/{k}"], w,
                                       rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["pp", "ep"])
def test_axis_variant_tracks_its_dp_reference(world, name):
    """tests/test_gspmd.py's axis variants: pp=2 (GPipe microbatches) and
    ep=2 (experts over ep) against the same config at dp=4."""
    res, _ = world
    got = [float(res[0][f"{name}/loss{i}"]) for i in range(STEPS)]
    ref = [float(res[0][f"{name}_ref/loss{i}"]) for i in range(STEPS)]
    np.testing.assert_allclose(got, ref, rtol=5e-4)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_equals_no_remat_bit_for_bit(world, policy):
    res, _ = world
    for r in res:
        assert r[f"tp_{policy}/loss0"] == r["tp/loss0"]
        for k in [k for k in r if k.startswith("tp/grad/")]:
            np.testing.assert_array_equal(
                r[f"tp_{policy}/grad/" + k[len("tp/grad/"):]], r[k],
                err_msg=k)


def test_ranks_hold_their_shards(world):
    """At pp=2 x tp=2 stage 0 holds layers 0-1, stage 1 layers 2-3,
    each with H/tp heads."""
    res, _ = world
    for r in range(4):
        layers = {int(k.split(".")[1]) for k in res[r]
                  if k.startswith("pp_tp_dots/state/layers.")}
        assert layers == ({0, 1} if r < 2 else {2, 3})
        assert res[r]["pp_tp_dots/state/layers.%d.wq" % min(layers)].shape \
            == (32, 2, 8)


def test_lm_checkpoint_of_pp_and_ep_shards_restores_onto_another_mesh(
        world):
    """The LM's leaves saved at pp=2 x ep=2 (each stage's layers, each
    rank's experts, one writer a shard, their specs in the manifest)
    assemble to the JAX weights exactly, and cut again for dp=2 x tp=2
    they are each rank's shard of them."""
    res, _ = world
    cfg = ttfm.TransformerConfig(**SMALL, **CKPT_KW)
    want = convert.transformer_from_jax(_lm_inputs(CKPT_KW)[1])
    mesh = _tmesh("dp=2,tp=2")
    for r in range(4):
        whole = {k[len("ckpt/whole/"):]: v for k, v in res[r].items()
                 if k.startswith("ckpt/whole/")}
        assert set(whole) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(whole[k], v, err_msg=k)
        for k, v in ttfm.shard_state(want, cfg, mesh, r).items():
            np.testing.assert_array_equal(res[r][f"ckpt/tp/{k}"], v,
                                          err_msg=k)


# --------------------------------------------- without a spawned world

class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _backward_mms(**kw):
    model = ttfm.TransformerLM(ttfm.TransformerConfig(**SMALL, **kw))
    tok = torch.from_numpy(TOKENS)
    loss = ttfm.loss_fn(model, tok, torch.roll(tok, -1, 1))
    with _CountMM() as c:
        loss.backward()
    return c.mm


def test_remat_dots_saves_the_matmuls():
    """Under "dots" the backward pass recomputes no projection or FFN
    matmul (their outputs are saved); under "full" it recomputes 5 of
    each layer's 6 (q, k, v, o and the FFN's first: the non-reentrant
    recompute stops at the last tensor the backward needs, and nothing
    keeps the FFN's second product)."""
    none, dots = _backward_mms(), _backward_mms(remat=True)
    full = _backward_mms(remat=True, remat_policy="full")
    assert dots == none
    assert full == none + 5 * SMALL["n_layers"]


def test_config_admits_every_option_and_refuses_an_unknown_policy():
    ttfm.TransformerLM(ttfm.TransformerConfig(
        **SMALL, num_experts=4, microbatches=2, remat=True))
    with pytest.raises(HorovodError, match="remat_policy"):
        ttfm.TransformerConfig(**SMALL, remat=True,
                               remat_policy="offload").check()


@pytest.mark.parametrize("axes,cfg_kw,what", [
    (dict(tp=3), dict(), "n_heads % tp"),
    (dict(pp=3), dict(microbatches=2), "n_layers % pp"),
    (dict(ep=3), dict(num_experts=4), "num_experts % ep"),
    (dict(pp=2), dict(), "pp > 1 requires microbatches > 1"),
])
def test_validate_raises_jax_mismatch_errors(axes, cfg_kw, what):
    spec = tmesh.MeshSpec(**axes)
    mesh = tmesh.Mesh(spec, np.arange(spec.total).reshape(spec.sizes()))
    with pytest.raises(HorovodError) as t_err:
        ttfm.validate_cfg_for_mesh(ttfm.TransformerConfig(**SMALL, **cfg_kw),
                                   mesh)
    jmesh = build_mesh(MeshSpec(**axes), jax.devices()[:spec.total])
    with pytest.raises(Exception) as j_err:
        jtfm.validate_cfg_for_mesh(jtfm.TransformerConfig(**SMALL, **cfg_kw),
                                   jmesh)
    assert str(t_err.value) == str(j_err.value) == \
        f"config/mesh mismatch: {what}"


def test_specs_and_reduce_axes_are_the_jax_ones():
    from jax.sharding import PartitionSpec as JP
    from horovod_tpu.optim.optimizer import grad_axes_from_specs as j_axes
    from horovod_tpu_torch.optim.optimizer import grad_axes_from_specs
    for kw in (dict(), dict(num_experts=4)):
        jcfg = jtfm.TransformerConfig(**SMALL, **kw)
        tcfg = ttfm.TransformerConfig(**SMALL, **kw)
        js = jax.tree_util.tree_map(tuple, jtfm.param_specs(jcfg),
                                    is_leaf=lambda x: isinstance(x, JP))
        assert js == ttfm.param_specs(tcfg)
        assert jtfm.grad_reduce_axes(jcfg) == ttfm.grad_reduce_axes(tcfg)
        full = build_mesh(MeshSpec(dp=2, pp=2, ep=2), jax.devices()[:8])
        spec = tmesh.MeshSpec(dp=2, pp=2, ep=2)
        tm = tmesh.Mesh(spec, np.arange(8).reshape(spec.sizes()))
        assert grad_axes_from_specs(ttfm.param_specs(tcfg), tm) == \
            j_axes(jtfm.param_specs(jcfg), full)
