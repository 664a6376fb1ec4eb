"""Sequence parallelism of the PyTorch package (ring and Ulysses
attention over the HOROVOD_MESH sp axis, and the LM over dp x sp)
against the JAX package's functions on the same numpy inputs.

Two spawned gloo worlds (tests/torch_sp_worker.py through
tests/torch_world_worker.py: one deadline of 90 s per world, FileStores
under tmp_path), each spawned once for this module; the parametrised
tests read a module-scoped fixture. While a world runs, the parent
computes the JAX references under jax.shard_map on the CPU mesh of
tests/conftest.py, as tests/test_parallel.py runs them (the Pallas
flash kernels in interpret mode), the cases in threads, since XLA
compiles without the interpreter lock:

1. an sp=4 world: ring_attention on both routes (use_flash True, the
   flash chunks on their plain versions here, and False, the streaming
   path), causal and not, and its gradients; ring_flash_attention
   non-causal with gradients; ulysses_attention and its gradients; bf16
   inputs through the ring. The shapes are tests/test_parallel.py's:
   (B, H, S, dh) = (2, 4, 16, 8), (1, 2, 8, 4) for the gradients, (2, 8,
   16, 4) for Ulysses, (1, 2, 16, 8) in bf16; the tolerances are its
   2e-5 (f32, rtol and atol) and 2e-2 (bf16 against the f32 oracle).
   Gradients are those of each rank's Σ out² with no psum first, as
   there: each shard's k/v cotangents must come back round the ring.
2. a dp=2 x sp=2 world: the LM (L2 D64 H4 F128 S16 V128, f32) for
   attn="ring" and "ulysses" from the JAX weights
   (models/convert.transformer_from_jax), with DistributedOptimizer over
   Adam(1e-3): the logits before training against build_forward, the
   first step's loss and all-reduced gradients against
   build_loss_and_grads, and the losses of 2 steps and the weights after
   them against build_train_step with optax.adam(1e-3), on the same
   mesh. Tolerances: logits 2e-5 (rtol and atol); losses 1e-5 relative;
   each gradient within 1e-5 of its largest magnitude (f32 sums in
   other orders); weights 1e-5 absolute (two Adam steps move a weight by
   at most 2e-3, and an f32 difference in the gradient moves m/√v far
   less than that).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_sp_worker as W
from torch_world_worker import start_world
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import MeshSpec, build_mesh
from horovod_tpu.parallel.ring_attention import ring_attention as j_ring
from horovod_tpu.parallel.ring_attention import (
    ring_flash_attention as j_ring_flash)
from horovod_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from horovod_tpu_torch import transformer_lm as tlm
from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel.ring_attention import (
    blockwise_attention_reference, hop_case, ring_hop)

SP = 4
TOL = 2e-5
TOL_BF16 = 2e-2
JFN = {"ring": j_ring, "ring_flash": j_ring_flash, "ulysses": j_ulysses}


def _qkv(seed, shape, bf16=False):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    if bf16:
        qkv = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in qkv]
    return qkv


# name -> (function, kwargs, (B, H, S, dh), grad, bf16)
CASES = {
    **{f"ring_c{int(c)}_f{int(f)}": ("ring", dict(causal=c, use_flash=f),
                                     (2, 4, 16, 8), False, False)
       for c in (True, False) for f in (True, False)},
    **{f"ring_grad_f{int(f)}": ("ring", dict(causal=True, use_flash=f),
                                (1, 2, 8, 4), True, False)
       for f in (True, False)},
    "ring_flash_nc": ("ring_flash", dict(causal=False), (1, 2, 8, 4), True,
                      False),
    "ulysses": ("ulysses", dict(causal=True), (2, 8, 16, 4), False, False),
    "ulysses_grad": ("ulysses", dict(causal=True), (1, 8, 8, 4), True,
                     False),
    "ring_bf16": ("ring", dict(causal=True), (1, 2, 16, 8), False, True),
}


def _jax_case(fn, kw, qkv, grad):
    """(out, grads or None) of the JAX function under shard_map."""
    m = build_mesh(MeshSpec(sp=SP), jax.devices()[:SP])
    spec = P(None, None, "sp", None)
    f = JFN[fn]
    q, k, v = (jnp.asarray(a) for a in qkv)
    if not grad:
        out = jax.jit(jax.shard_map(
            lambda a, b, c: f(a, b, c, "sp", **kw), mesh=m,
            in_specs=(spec,) * 3, out_specs=spec, check_vma=False))(q, k, v)
        return np.asarray(out), None

    def out_and_grads(a, b, c):
        # The gradient of this shard's Σ out² (no psum first), as
        # tests/test_parallel.py takes it: the vjp of 2·out.
        o, vjp = jax.vjp(lambda x, y, z: f(x, y, z, "sp", **kw), a, b, c)
        return o, vjp(2 * o)

    out, gs = jax.jit(jax.shard_map(
        out_and_grads, mesh=m, in_specs=(spec,) * 3,
        out_specs=(spec, (spec,) * 3), check_vma=False))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in gs]


def _gather(res, key):
    """The ranks' sequence blocks of `key`, concatenated along S."""
    return np.concatenate([r[key] for r in res], axis=2)


@pytest.fixture(scope="module")
def attn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_attn")
    inputs, cases = {}, {}
    for i, (name, (fn, kw, shape, grad, bf16)) in enumerate(CASES.items()):
        inputs[name] = _qkv(10 + i, shape, bf16)
        wire = [a.view(np.uint16) if bf16 else a for a in inputs[name]]
        cases[name] = (fn, kw, *wire, grad)
    outs = [str(tmp / f"rank{r}.npz") for r in range(SP)]
    world = start_world(W.run_attn, [(r, SP, str(tmp / "store"), cases,
                                      outs[r]) for r in range(SP)], tmp)
    with ThreadPoolExecutor(4) as pool:  # XLA compiles off the GIL
        want = dict(zip(CASES, pool.map(
            lambda item: _jax_case(item[1][0], item[1][1], inputs[item[0]],
                                   item[1][3]), CASES.items())))
    world.join()
    return [dict(np.load(o)) for o in outs], want


def _check(res, want, name, tol=TOL):
    o, grads = want[name]
    got = _gather(res, f"{name}/o")
    if got.dtype == np.uint16:
        got = got.view(jnp.bfloat16)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(o, np.float32), rtol=tol, atol=tol)
    for g, w in zip(("dq", "dk", "dv"), grads or ()):
        np.testing.assert_allclose(_gather(res, f"{name}/{g}"), w,
                                   rtol=tol, atol=tol, err_msg=g)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_flash", [True, False])
def test_ring_attention_matches_jax(attn, causal, use_flash):
    _check(*attn, f"ring_c{int(causal)}_f{int(use_flash)}")


@pytest.mark.parametrize("use_flash", [True, False])
def test_ring_attention_grad_matches_jax(attn, use_flash):
    """The k/v cotangents of each hop go back to their source rank."""
    _check(*attn, f"ring_grad_f{int(use_flash)}")


def test_ring_flash_attention_noncausal_with_grads_matches_jax(attn):
    _check(*attn, "ring_flash_nc")


def test_ulysses_matches_jax(attn):
    _check(*attn, "ulysses")


def test_ulysses_grad_matches_jax(attn):
    _check(*attn, "ulysses_grad")


def test_ring_attention_bf16_tolerance(attn):
    """bf16 inputs: the flash-chunk ring merges in f32, so the error
    stays at the bf16 inputs' level, against the JAX ring and the f32
    oracle alike."""
    res, want = attn
    _check(res, want, "ring_bf16", TOL_BF16)
    q, k, v = (torch.from_numpy(np.asarray(a, np.float32))
               for a in _qkv(10 + list(CASES).index("ring_bf16"),
                             CASES["ring_bf16"][2], bf16=True))
    oracle = blockwise_attention_reference(q, k, v, causal=True)
    got = _gather(res, "ring_bf16/o").view(jnp.bfloat16)
    np.testing.assert_allclose(np.asarray(got, np.float32), oracle.numpy(),
                               rtol=TOL_BF16, atol=TOL_BF16)


def test_sp_set_is_the_ring(attn):
    res, _ = attn
    for r in res:
        assert list(r["sp_ranks"]) == list(range(SP))


# ------------------------------------------------------------ the LM

SMALL = dict(vocab=128, d_model=64, n_heads=4, d_ff=128, n_layers=2,
             max_seq=16)
STEPS = 2
ATTNS = ["ring", "ulysses"]


def _jax_lm(attn, params, tokens):
    cfg = jtfm.TransformerConfig(**SMALL, attn=attn, dtype=jnp.float32)
    mesh = build_mesh(MeshSpec(dp=2, sp=2), jax.devices()[:4])
    jtfm.validate_cfg_for_mesh(cfg, mesh)
    params = jtfm.shard_params(params, cfg, mesh)
    tok = jnp.asarray(tokens)
    tgt = jnp.roll(tok, -1, axis=1)
    out = {"logits": np.asarray(
        jax.jit(jtfm.build_forward(cfg, mesh))(params, tok))}
    loss, grads = jax.jit(jtfm.build_loss_and_grads(cfg, mesh))(params, tok,
                                                                 tgt)
    out["loss_and_grads"] = (float(loss), convert.transformer_from_jax(
        jax.tree_util.tree_map(np.asarray, grads)))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    step = jtfm.build_train_step(cfg, mesh, opt)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, tok, tgt)
        losses.append(float(loss))
    out["losses"] = losses
    out["state"] = convert.transformer_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_lm")
    params = jax.tree_util.tree_map(np.asarray, jtfm.init(
        jax.random.PRNGKey(0), jtfm.TransformerConfig(
            **SMALL, dtype=jnp.float32)))
    tokens = np.random.default_rng(7).integers(0, SMALL["vocab"], (4, 16))
    state0 = convert.transformer_from_jax(params)
    outs = [str(tmp / f"rank{r}.npz") for r in range(4)]
    world = start_world(W.run_lm, [(r, 4, str(tmp / "store"), SMALL, state0,
                                    tokens, STEPS, outs[r])
                                   for r in range(4)], tmp)
    with ThreadPoolExecutor(len(ATTNS)) as pool:
        want = dict(zip(ATTNS, pool.map(
            lambda a: _jax_lm(a, params, tokens), ATTNS)))
    world.join()
    return [dict(np.load(o)) for o in outs], want, state0


def _global(res, key):
    """Rank (dp, sp) = (r // 2, r % 2) holds block [dp, sp] of (B, S, …)."""
    rows = [np.concatenate([res[2 * d + s][key] for s in range(2)], axis=1)
            for d in range(2)]
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("attn", ATTNS)
def test_lm_logits_match_jax(lm, attn):
    res, want, _ = lm
    np.testing.assert_allclose(_global(res, f"{attn}/logits"),
                               want[attn]["logits"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("attn", ATTNS)
def test_lm_losses_match_jax(lm, attn):
    res, want, _ = lm
    assert want[attn]["losses"][0] == pytest.approx(
        want[attn]["loss_and_grads"][0], rel=1e-6)
    for i in range(STEPS):
        for r in res:
            np.testing.assert_allclose(float(r[f"{attn}/loss{i}"]),
                                       want[attn]["losses"][i], rtol=1e-5)


@pytest.mark.parametrize("attn", ATTNS)
def test_lm_first_step_gradients_match_jax(lm, attn):
    """The all-reduced gradients of step 1 equal the JAX psum'd ones:
    the ring's and Ulysses' backward return each k/v cotangent to its
    rank before DistributedOptimizer averages the world."""
    res, want, _ = lm
    grads = want[attn]["loss_and_grads"][1]
    for r in res:
        for name, w in grads.items():
            g = r[f"{attn}/grad/{name}"]
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-5 * (np.abs(w).max() + 1e-12),
                err_msg=name)


@pytest.mark.parametrize("attn", ATTNS)
def test_lm_weights_after_two_adam_steps_match_jax(lm, attn):
    res, want, state0 = lm
    for r in res:
        got = {k[len(attn) + 7:]: v for k, v in r.items()
               if k.startswith(f"{attn}/state/")}
        assert set(got) == set(want[attn]["state"])
        for name, v in got.items():
            np.testing.assert_allclose(v, want[attn]["state"][name], rtol=0,
                                       atol=1e-5, err_msg=name)
        assert np.abs(got["layers.0.wq"] - state0["layers.0.wq"]).max() \
            > 1e-4


def test_lm_ranks_sit_on_the_mesh(lm):
    res, _, _ = lm
    assert [list(r["coords"]) for r in res] == [[0, 0, 2], [0, 1, 2],
                                                [1, 0, 2], [1, 1, 2]]


def test_rank_batch_rolls_the_whole_sequence_before_slicing(lm):
    """Each rank's targets are its slice of roll(tokens, -1) over the
    replica's whole sequence: the first slice's last target is the
    second slice's first token."""
    res, _, _ = lm
    for dp in range(2):
        tok, tgt = tlm.make_batch(2, 16, SMALL["vocab"], torch.device("cpu"),
                                  seed=dp)
        for sp in range(2):
            r = res[2 * dp + sp]
            cols = slice(8 * sp, 8 * sp + 8)
            np.testing.assert_array_equal(r["rank_batch/tokens"],
                                          tok[:, cols].numpy())
            np.testing.assert_array_equal(r["rank_batch/targets"],
                                          tgt[:, cols].numpy())
        first = res[2 * dp]["rank_batch/targets"][:, -1]
        np.testing.assert_array_equal(
            first, res[2 * dp + 1]["rank_batch/tokens"][:, 0])


# ------------------------------------------------ without a spawned world

@pytest.mark.parametrize("P_", [1, 2, 4])
def test_hop_cases_are_the_jax_switch(P_):
    """case 1 on the diagonal, 2 for an earlier block, 0 (skipped) for a
    later one, as `jnp.where(src == r, 1, jnp.where(src < r, 2, 0))`;
    every hop is a full chunk when not causal. A causal rank r runs r + 1
    chunks."""
    for r in range(P_):
        cases = [hop_case((r - t) % P_, r, True) for t in range(P_)]
        srcs = np.asarray([(r - t) % P_ for t in range(P_)])
        want = np.where(srcs == r, 1, np.where(srcs < r, 2, 0))
        assert cases == list(want)
        assert sum(c > 0 for c in cases) == r + 1
        assert [hop_case((r - t) % P_, r, False)
                for t in range(P_)] == [2] * P_


def test_skipped_hop_leaves_the_merge_as_the_zero_chunk_would():
    """Case 0 returns (o, L) as they were: what merging JAX's skip branch
    (zeros, lse −1e30) into a finite L gives, bit for bit."""
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.standard_normal((1, 2, 4, 8)).astype(np.float32))
    L = torch.from_numpy(rng.standard_normal((1, 2, 4)).astype(np.float32))
    kv = torch.zeros((2, 1, 2, 4, 8))
    o2, L2 = ring_hop(o, kv, o, L, 0, 0.5)
    L_new = torch.logaddexp(L, torch.full_like(L, -1e30))
    merged = o * torch.exp(L - L_new)[..., None]
    assert torch.equal(L2, L_new) and torch.equal(o2, merged)


@pytest.mark.parametrize("axes,item", [
    (dict(tp=2), "A11 part 2"), (dict(pp=2), "A11 part 2"),
    (dict(ep=2), "A11 part 2")])
def test_validate_refuses_the_unported_axes(axes, item):
    """The tp, pp and ep axes that `item` ported: validate_cfg_for_mesh
    admits what the JAX function admits (tp=2, ep=2) and refuses what it
    refuses with its message (pp=2 without microbatches)."""
    spec = tmesh.MeshSpec(**axes)
    mesh = tmesh.Mesh(spec, np.arange(spec.total).reshape(spec.sizes()))
    jmesh = build_mesh(MeshSpec(**axes), jax.devices()[:spec.total])
    kw = {**SMALL, "attn": "ring"}
    try:
        jtfm.validate_cfg_for_mesh(jtfm.TransformerConfig(**kw), jmesh)
        want = None
    except Exception as e:  # noqa: BLE001 - the message is compared
        want = str(e)
    if want is None:
        ttfm.validate_cfg_for_mesh(ttfm.TransformerConfig(**kw), mesh)
        return
    assert "pp" in axes, item
    with pytest.raises(HorovodError) as err:
        ttfm.validate_cfg_for_mesh(ttfm.TransformerConfig(**kw), mesh)
    assert str(err.value) == want


def test_validate_ulysses_heads_like_jax():
    """n_heads % sp for Ulysses: the port refuses what JAX refuses, with
    its message."""
    cfg_kw = {**SMALL, "n_heads": 6}
    spec = tmesh.MeshSpec(sp=4)
    mesh = tmesh.Mesh(spec, np.arange(4).reshape(spec.sizes()))
    with pytest.raises(HorovodError) as t_err:
        ttfm.validate_cfg_for_mesh(
            ttfm.TransformerConfig(**cfg_kw, attn="ulysses"), mesh)
    jmesh = build_mesh(MeshSpec(sp=4), jax.devices()[:4])
    with pytest.raises(Exception) as j_err:
        jtfm.validate_cfg_for_mesh(
            jtfm.TransformerConfig(**cfg_kw, attn="ulysses"), jmesh)
    assert str(t_err.value) == str(j_err.value)
    ttfm.validate_cfg_for_mesh(  # ring has no heads rule
        ttfm.TransformerConfig(**cfg_kw, attn="ring"), mesh)


@pytest.mark.parametrize("flag", ["--tp", "--pp", "--ep"])
def test_lm_entry_refuses_the_unported_axes(flag, capsys):
    """The axes the entry point refused until ROADMAP A11 part 2: each
    flag now asks HOROVOD_MESH for its axis."""
    args = tlm.parse_args([flag, "2", "--attn", "ring"])
    assert getattr(args, flag[2:]) == 2
    assert tlm.mesh_env(args) == f"{flag[2:]}=2"
    assert "ROADMAP" not in capsys.readouterr().err


def test_ring_without_a_mesh_names_horovod_mesh():
    model = ttfm.TransformerLM(ttfm.TransformerConfig(**SMALL, attn="ring"))
    with pytest.raises(HorovodError, match="HOROVOD_MESH"):
        model(torch.zeros((1, 4), dtype=torch.int64))
