"""The tied-embedding LM (models/tied_lm.py), the sharded step of
DistributedOptimizer(sharding_spec=...) that trains it, and sharded
checkpoints restored onto another mesh, against the JAX package (the
contract of tests/test_gspmd.py:198-342 and :700-741).

One spawned gloo world of 4 ranks under HOROVOD_MESH="dp=2,tp=2"
(tests/torch_tp_pp_ep_worker.py run_tied through
tests/torch_world_worker.py), which also builds the dp=4 and tp=4
meshes. The model is tests/test_gspmd.py's (V256 D32 F64 L2, f32), the
weights init(0) and the batch sample_batch(1, batch 8, seq 16), the same
numbers on both sides. While the world runs, the parent computes the
JAX references: the dense loss and the dense SGD(0.05) and Adam(1e-2)
trajectories through global_loss, and JAX's own sharded SGD trajectory
at dp=2 x tp=2. Tolerances are the JAX file's: the local loss equals
the dense one within 1e-6; trajectories within 2e-5 (SGD, and the
checkpoint resumes against the uninterrupted run) and 5e-5 (Adam),
since the reduction orders differ across mesh shapes.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_tp_pp_ep_worker as W
from torch_world_worker import start_world
from horovod_tpu.models import tied_lm as jtied
from horovod_tpu.optim.optimizer import (build_sharded_train_step,
                                         grad_axes_from_specs as j_axes)
from horovod_tpu.parallel.mesh import MeshSpec, build_mesh
from horovod_tpu_torch.ckpt import manifest as mf
from horovod_tpu_torch.models import tied_lm
from horovod_tpu_torch.optim.optimizer import grad_axes_from_specs
from horovod_tpu_torch.parallel import mesh as tmesh

KW = dict(vocab=256, d_model=32, d_ff=64, n_layers=2)
JCFG, TCFG = jtied.TiedLMConfig(**KW), tied_lm.TiedLMConfig(**KW)


def _inputs():
    params = {k: np.asarray(v) for k, v in jtied.init(0, JCFG).items()}
    tok, tgt = (np.asarray(a) for a in jtied.sample_batch(1, JCFG, batch=8,
                                                          seq=16))
    return params, (tok.astype(np.int64), tgt.astype(np.int64))


def _dense(opt, steps):
    params, (tok, tgt) = _inputs()
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = opt.init(p)
    gl = jax.jit(jax.value_and_grad(
        lambda q: jtied.global_loss(q, tok, tgt, JCFG)))
    out = []
    for _ in range(steps):
        loss, g = gl(p)
        up, st = opt.update(g, st, p)
        p = optax.apply_updates(p, up)
        out.append(float(loss))
    return out


def _jax_hybrid_sgd(steps=5):
    params, (tok, tgt) = _inputs()
    mesh = build_mesh(MeshSpec.parse("dp=2,tp=2"), jax.devices()[:4])
    specs = jtied.param_specs(JCFG)
    step = build_sharded_train_step(
        lambda p, b: jtied.local_loss(p, b[0], b[1], JCFG), optax.sgd(0.05),
        mesh=mesh, param_specs=specs, donate=False)
    p = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
         for k, v in params.items()}
    b = jax.device_put((jnp.asarray(tok, jnp.int32),
                        jnp.asarray(tgt, jnp.int32)),
                       NamedSharding(mesh, P("dp")))
    st = optax.sgd(0.05).init(p)
    out = []
    for _ in range(steps):
        p, st, loss = step(p, st, b)
        out.append(float(loss))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tied_lm")
    params, data = _inputs()
    root = str(tmp / "ckpt")
    outs = [str(tmp / f"rank{r}.npz") for r in range(4)]
    w = start_world(W.run_tied, [(r, 4, str(tmp / "store"), KW, params,
                                  data, root, outs[r]) for r in range(4)],
                    tmp, deadline=120.0)
    jobs = {"dense": lambda: float(jtied.global_loss(
                {k: jnp.asarray(v) for k, v in params.items()},
                *data, JCFG)),
            "sgd": lambda: _dense(optax.sgd(0.05), 5),
            "adam": lambda: _dense(optax.adam(1e-2), 5),
            "jax_hybrid": _jax_hybrid_sgd}
    with ThreadPoolExecutor(4) as pool:
        futs = {n: pool.submit(f) for n, f in jobs.items()}
        want = {n: f.result() for n, f in futs.items()}
    w.join()
    return [dict(np.load(o)) for o in outs], want, root


def test_local_loss_equals_global_loss_value(world):
    """The dp blocks' local losses (every tp member holds its block's)
    average to the dense loss."""
    res, want, _ = world
    by_dp = {}
    for r in res:
        by_dp.setdefault(int(r["dp_index"]), set()).add(
            float(r["local_loss"]))
    assert all(len(v) == 1 for v in by_dp.values()), by_dp
    got = np.mean([v.pop() for v in by_dp.values()])
    np.testing.assert_allclose(got, want["dense"], rtol=1e-6)


def test_hybrid_matches_dp_and_dense_trajectory(world):
    res, want, _ = world
    for r in res:
        hy, dp = list(r["sgd_hybrid"]), list(r["sgd_dp4"])
        np.testing.assert_allclose(dp, want["sgd"], rtol=2e-5)
        np.testing.assert_allclose(hy, want["sgd"], rtol=2e-5)
        np.testing.assert_allclose(hy, dp, rtol=2e-5)
        np.testing.assert_allclose(hy, want["jax_hybrid"], rtol=2e-5)


def test_hybrid_adam_state_shards_like_params(world):
    """Adam's moments live with each rank's shard (the vocab-sharded
    embedding's moment holds V/tp rows), and the hybrid Adam trajectory
    matches dense Adam; hybrid_lm.train is the same run."""
    res, want, _ = world
    for r in res:
        np.testing.assert_allclose(list(r["adam_hybrid"]), want["adam"][:3],
                                   rtol=5e-5)
        assert tuple(r["adam_emb_moment_shape"]) == (KW["vocab"] // 2,
                                                     KW["d_model"])
        np.testing.assert_allclose(list(r["hybrid_lm"]),
                                   list(r["adam_hybrid"]), rtol=1e-6)
        assert bool(r["shard_params_equal"])


def test_sharded_leaves_are_written_with_spec_and_offsets(world):
    """The tp=4 save: the vocab-sharded embedding is 4 shard files (one
    writer each) under its spec, and the world committed step 3."""
    res, _, root = world
    assert all(bool(r["saved"]) for r in res)
    man = mf.read_manifest(f"{root}/{mf.dirname_for(3)}")
    emb = [e for e in man.leaves if e.path == "['params']['emb']"]
    assert emb and len(emb[0].files) == 4 and emb[0].spec[0] == ["tp"]
    assert sorted(f["start"][0] for f in emb[0].files) == [0, 64, 128, 192]


@pytest.mark.parametrize("target", ["hy", "dp4"])
def test_ckpt_restore_onto_smaller_tp_mesh(world, target):
    """Save at tp=4 after 3 Adam steps, resume at dp=2 x tp=2 and at
    dp=4 (tp gone): the assembled leaves re-shard onto the new mesh and
    the trajectory continues within 2e-5 of the uninterrupted run, which
    itself tracks dense Adam."""
    res, want, _ = world
    for r in res:
        ref = list(r["adam_tp4"])
        np.testing.assert_allclose(ref, want["adam"], rtol=5e-5)
        assert int(r[f"restored_step_{target}"]) == 3
        np.testing.assert_allclose(list(r[f"resumed_{target}"]), ref[3:],
                                   rtol=2e-5)


# --------------------------------------------- without a spawned world

def test_init_and_batch_are_the_jax_ones_bit_for_bit():
    params, (tok, tgt) = _inputs()
    got = tied_lm.init(0, TCFG)
    assert set(got) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    t, g = tied_lm.sample_batch(1, TCFG, batch=8, seq=16)
    np.testing.assert_array_equal(t.numpy(), tok)
    np.testing.assert_array_equal(g.numpy(), tgt)
    assert tied_lm.param_specs(TCFG) == {
        k: tuple(v) for k, v in jtied.param_specs(JCFG).items()}
    assert set(tied_lm.replicated_specs(TCFG).values()) == {()}


def test_global_and_one_rank_local_loss_match_jax():
    """On one rank (no mesh: every axis op an identity) local_loss is
    global_loss; both equal JAX's, and so do the gradients; the
    constrain_logits hook is applied as a plain callable."""
    params, (tok, tgt) = _inputs()
    want = float(jtied.global_loss({k: jnp.asarray(v) for k, v in
                                    params.items()}, tok, tgt, JCFG))
    p = {k: torch.from_numpy(v.copy()).requires_grad_()
         for k, v in params.items()}
    t, g = torch.from_numpy(tok), torch.from_numpy(tgt)
    seen = []
    dense = tied_lm.global_loss(p, t, g, TCFG,
                                constrain_logits=lambda x: seen.append(
                                    x.shape) or x)
    local = tied_lm.local_loss(p, t, g, TCFG)
    assert seen == [(8, 16, KW["vocab"])]
    np.testing.assert_allclose(dense.item(), want, rtol=1e-6)
    np.testing.assert_allclose(local.item(), want, rtol=1e-6)
    jg = jax.grad(lambda q: jtied.global_loss(q, tok, tgt, JCFG))(
        {k: jnp.asarray(v) for k, v in params.items()})
    local.backward()
    for k in params:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_grad_axes_from_specs_is_the_jax_rule():
    from jax.sharding import PartitionSpec as JP
    specs = {"emb": ("tp", None), "w": (None, "tp"), "b": (),
             "nested": {"u": (("dp", "tp"),)}}
    jspecs = {"emb": JP("tp", None), "w": JP(None, "tp"), "b": JP(),
              "nested": {"u": JP(("dp", "tp"))}}
    for text in ("dp=2,tp=4", "dp=8"):
        spec = tmesh.MeshSpec.parse(text, 8)
        tm = tmesh.Mesh(spec, np.arange(8).reshape(spec.sizes()))
        jm = build_mesh(MeshSpec.parse(text, 8), jax.devices()[:8])
        assert grad_axes_from_specs(specs, tm) == j_axes(jspecs, jm)
