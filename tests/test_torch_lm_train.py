"""The PyTorch package's LM training path as a whole, over two
processes, against the JAX package's data-parallel train step.

Two spawned gloo workers (tests/torch_lm_worker.py, a FileStore under
tmp_path) train a tiny LM (vocab 64, D 32, H 4, L 2, S 64, f32,
attn="flash" on the kernels' plain versions) for 2 steps through
horovod_tpu_torch.transformer_lm: hvd.broadcast_parameters from rank 0,
hvd.DistributedOptimizer over Adam(1e-3) with a 16 KiB fusion threshold,
so the gradients go out in several buckets. The JAX side runs
models/transformer.build_train_step on a 2-device CPU mesh (dp = 2) with
optax.adam(1e-3), its flash kernels in interpret mode, from the same
weights and tokens.

Tolerance: 1e-5 absolute on every parameter. Two Adam steps move each
weight by at most 2e-3 whatever the gradient's size; the two sides'
gradients differ by f32 summation order (~1e-6 relative), which moves
m/√v, and so the update, far less than that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

import torch_lm_worker
from torch_world_worker import spawn_world
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import MeshSpec, build_mesh
from horovod_tpu_torch.models import convert

STEPS = 2
SMALL = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             max_seq=64)


def _jax_train(params, tokens, k):
    cfg = jtfm.TransformerConfig(**SMALL, attn="flash", dtype=jnp.float32)
    mesh = build_mesh(MeshSpec(dp=k), jax.devices()[:k])
    params = jtfm.shard_params(params, cfg, mesh)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    step = jtfm.build_train_step(cfg, mesh, opt)
    tok = jnp.asarray(tokens)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, tok,
                                       jnp.roll(tok, -1, axis=1))
        losses.append(float(loss))
    return jax.tree_util.tree_map(np.asarray, params), losses


def test_two_process_lm_training_matches_jax(tmp_path):
    k = 2
    params = jax.tree_util.tree_map(np.asarray, jtfm.init(
        jax.random.PRNGKey(0), jtfm.TransformerConfig(
            **SMALL, attn="flash", dtype=jnp.float32)))
    tokens = np.random.default_rng(5).integers(0, SMALL["vocab"], (4, 64))
    state0 = convert.transformer_from_jax(params)

    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(k)]
    spawn_world(torch_lm_worker.run,
                [(r, k, store, SMALL, state0, tokens, STEPS, outs[r])
                 for r in range(k)], tmp_path, deadline=240)
    res = [dict(np.load(o)) for o in outs]

    pj, losses_j = _jax_train(params, tokens, k)
    want = convert.transformer_from_jax(pj)
    assert int(res[0]["n_buckets"]) > 2
    for i in range(STEPS):  # rank-mean of the local losses = JAX's loss
        got = np.mean([float(r[f"loss{i}"]) for r in res])
        np.testing.assert_allclose(got, losses_j[i], rtol=1e-5)
    for r in range(k):
        got = {key[len("state/"):]: v for key, v in res[r].items()
               if key.startswith("state/")}
        assert set(got) == set(want)
        for name, v in got.items():
            np.testing.assert_allclose(v, want[name], rtol=0, atol=1e-5,
                                       err_msg=name)
        # training moved the weights away from the start
        assert np.abs(got["layers.0.wq"] - state0["layers.0.wq"]).max() \
            > 1e-4
