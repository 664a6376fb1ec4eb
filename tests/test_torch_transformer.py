"""The transformer LM of the PyTorch package against the JAX package's
(models/transformer.py), on one device.

The JAX weights (jax.random, float32) reach the port through
models/convert.transformer_from_jax; both sides get the same seeded
numpy tokens. The JAX model runs on a 1-device CPU mesh, its flash
kernels in Pallas interpret mode; the port runs the plain PyTorch
versions of its kernels. Tolerance 2e-4 of the largest magnitude, as
tests/test_models.py holds attn="flash" against "local": f32 through two
layers, sums in different orders.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import MeshSpec, build_mesh
from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as ttfm
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel import mesh as tmesh

TOL = 2e-4
SMALL = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             max_seq=64)


def _cfgs(attn):
    return (jtfm.TransformerConfig(**SMALL, attn=attn, dtype=jnp.float32),
            ttfm.TransformerConfig(**SMALL, attn=attn, dtype=torch.float32))


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach() if torch.is_tensor(b) else b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= tol * (np.max(np.abs(a)) + 1e-9), \
        (np.max(np.abs(a - b)), np.max(np.abs(a)))


def _setup(attn, seed=0):
    jcfg, tcfg = _cfgs(attn)
    params = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    model = ttfm.TransformerLM(tcfg, seed=123)
    convert.load_jax_transformer(model, jax.tree_util.tree_map(
        np.asarray, params))
    tokens = np.random.default_rng(seed).integers(0, SMALL["vocab"],
                                                  (2, 64))
    mesh = build_mesh(MeshSpec(), jax.devices()[:1])
    return jcfg, params, model, tokens, mesh


def test_init_layout_is_the_jax_one():
    """transformer_from_jax of the JAX init gives exactly the port's
    state-dict names and shapes."""
    jcfg, tcfg = _cfgs("flash")
    want = convert.transformer_from_jax(jax.tree_util.tree_map(
        np.asarray, jtfm.init(jax.random.PRNGKey(0), jcfg)))
    got = ttfm.TransformerLM(tcfg).state_dict()
    assert {k: v.shape for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    assert got["layers.1.wq"].shape == (32, 4, 8)
    assert got["layers.0.wo"].shape == (4, 8, 32)


@pytest.mark.parametrize("attn", ["flash", "local"])
def test_logits_match_jax(attn):
    jcfg, params, model, tokens, mesh = _setup(attn)
    want = jax.jit(jtfm.build_forward(jcfg, mesh))(params,
                                                   jnp.asarray(tokens))
    got = model(torch.from_numpy(tokens))
    _close(want, got)


@pytest.mark.parametrize("attn", ["flash", "local"])
def test_loss_and_gradients_match_jax(attn):
    jcfg, params, model, tokens, mesh = _setup(attn, seed=1)
    targets = np.roll(tokens, -1, axis=1)
    loss_j, grads_j = jax.jit(jtfm.build_loss_and_grads(jcfg, mesh))(
        params, jnp.asarray(tokens), jnp.asarray(targets))
    before = tfa.flash_fwd.launches
    loss = ttfm.loss_fn(model, torch.from_numpy(tokens),
                        torch.from_numpy(targets))
    loss.backward()
    assert tfa.flash_fwd.launches == before  # CPU: the plain versions
    np.testing.assert_allclose(float(loss_j), loss.item(), rtol=TOL)
    want = convert.transformer_from_jax(jax.tree_util.tree_map(
        np.asarray, grads_j))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) == set(grads)
    for name, g in want.items():
        _close(g, grads[name])


def test_flash_and_local_agree():
    _, _, model, tokens, _ = _setup("flash", seed=2)
    tok = torch.from_numpy(tokens)
    flash = model(tok)
    model.cfg = ttfm.TransformerConfig(**SMALL, attn="local")
    _close(model(tok).detach().numpy(), flash)


@pytest.mark.parametrize("kw,item", [
    (dict(attn="ring"), "A11"), (dict(attn="ulysses"), "A11"),
    (dict(attn="flash", num_experts=4), "A11"),
    (dict(attn="flash", microbatches=2), "A11"),
    (dict(attn="flash", remat=True), "A11"),
])
def test_unported_options_raise(kw, item):
    cfg = ttfm.TransformerConfig(**{**SMALL, **kw})
    if cfg.attn in ("ring", "ulysses"):
        # Ported (sequence parallelism): the model is admitted, and what
        # stays refused is a mesh with the tp axis of A11 part 2.
        ttfm.TransformerLM(cfg)
        spec = tmesh.MeshSpec(tp=2)
        mesh = tmesh.Mesh(spec, np.arange(2).reshape(spec.sizes()))
        with pytest.raises(HorovodError, match=item):
            ttfm.validate_cfg_for_mesh(cfg, mesh)
        return
    with pytest.raises(HorovodError, match=item):
        ttfm.TransformerLM(cfg)


def test_unknown_attention_raises():
    with pytest.raises(HorovodError):
        ttfm.TransformerLM(ttfm.TransformerConfig(**SMALL, attn="sparse"))


def test_config_defaults_are_the_jax_ones():
    j, t = jtfm.TransformerConfig(), ttfm.TransformerConfig()
    for f in ("vocab", "d_model", "n_heads", "d_ff", "n_layers", "max_seq",
              "num_experts", "capacity_factor", "attn", "microbatches",
              "remat", "remat_policy"):
        assert getattr(j, f) == getattr(t, f), f
    assert t.dtype == torch.float32 and t.head_dim == j.head_dim


def test_new_modules_import_no_jax_at_runtime():
    code = ("import sys, horovod_tpu_torch.transformer_lm, "
            "horovod_tpu_torch.models.transformer, "
            "horovod_tpu_torch.ops.flash_attention, "
            "horovod_tpu_torch.parallel.ring_attention, "
            "horovod_tpu_torch.profiler.flops;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'horovod_tpu', 'optax')];"
            "print(bad); sys.exit(1 if bad else 0)")
    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_flagship_embedding_gradients_get_buckets_of_their_own():
    """At the flagship width (bf16) the 134 MB embedding and unembedding
    gradients exceed the 4 MiB bucket cap: the planner cuts them into
    ≤ 4 MiB chunks, each in a bucket that holds nothing else, and the
    plan is the JAX package's."""
    from horovod_tpu.ops import fusion as jfusion
    from horovod_tpu_torch.ops import fusion as tfusion

    D, H, F, V, S, L = 2048, 16, 8192, 32768, 1024, 12
    dh = D // H
    shapes = {"embed": (V, D), "pos": (S, D), "wq": (D, H, dh),
              "wk": (D, H, dh), "wv": (D, H, dh), "wo": (H, dh, D),
              "w1": (D, F), "b1": (F,), "w2": (F, D), "unembed": (D, V)}
    names = [n for n, _ in ttfm.TransformerLM(ttfm.TransformerConfig(
        **{**SMALL, "n_layers": L}, attn="flash")).named_parameters()]
    plan_in = [(shapes.get(n.split(".")[-1], (D,)), torch.bfloat16)
               for n in names]
    cap = 4 * 1024 * 1024
    plan = tfusion.plan_buckets(plan_in, cap, reverse=True)
    jplan = jfusion.plan_buckets([(s, "bfloat16") for s, _ in plan_in], cap,
                                 reverse=True)
    assert tfusion.plan_signature(plan) == jfusion.plan_signature(jplan)
    big = {names.index("embed"), names.index("unembed")}
    for b in plan:
        idx = {it.index for it in b.items}
        assert sum(it.size for it in b.items) * 2 <= cap
        if idx & big:
            assert len(idx) == 1
    assert sum(1 for b in plan if {it.index for it in b.items} & big) == 64
    assert len(plan) == 391  # as DistributedOptimizer planned on the card
