"""HVD504's atomics on the port's recorded programs (fault C13, closed).

An H100 decided it (chip_smoke.py lm_determinism_check): five backward
passes of the flagship LM step from one state, its batch full of
repeated tokens, gave bit-identical embedding and unembedding gradients,
and so did the tied LM's global_loss. So CUDA's `index_put_` with
accumulate=True (the embedding lookup `E[tokens]` backs into it; CUDA
sorts the indices) and a `scatter_add_` with one index along the
scattered dim (a gather's backward, one target a row) are no hazard,
as XLA's scatter-add in the JAX programs is none. `index_add_` and a
`scatter_add_` whose indices can meet one address accumulate with
atomics in a run-to-run order, and stay HVD504 findings.

Each case records one small backward (analysis/graph.py) and lints it
with the port's numerics rules; the embedding and gather cases are held
against the JAX package's lowered twins, which are clean.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from horovod_tpu.analysis import numerics as jnum
from horovod_tpu_torch.analysis import graph
from horovod_tpu_torch.analysis import numerics as tnum


def port_rules(fn, *entries):
    prog = graph.record(fn, entries=[(t, None) for t in entries])[1]
    return {f.rule_id for f in tnum.lint_programs([prog])}


def jax_rules(fn, *args):
    text = jax.jit(fn).lower(*args).as_text()
    return {f.rule_id for f in jnum.lint_programs(
        [jnum.analyze_text(text, "p0")])}


V, D, B, S = 32, 8, 4, 16


def _tokens():
    # every row of the table is looked up several times
    return torch.arange(B * S).reshape(B, S) % 5


def test_embedding_lookup_backward_is_no_hazard():
    emb = torch.randn(V, D, requires_grad=True)
    tok = _tokens()

    def step():
        return torch.autograd.grad(emb[tok].square().sum(), emb)[0]

    def jstep(e, t):
        return jax.grad(lambda e: jnp.square(e[t]).sum())(e)

    assert jax_rules(jstep, jnp.zeros((V, D)), jnp.asarray(tok.numpy())) \
        == set()
    assert port_rules(step, emb) == set()


def test_target_gather_backward_is_no_hazard():
    logits = torch.randn(B, S, V, requires_grad=True)
    tgt = _tokens()

    def step():
        logp = torch.log_softmax(logits, -1)
        loss = -torch.gather(logp, -1, tgt[..., None]).mean()
        return torch.autograd.grad(loss, logits)[0]

    def jstep(x, t):
        def loss(x):
            logp = jax.nn.log_softmax(x, -1)
            return -jnp.take_along_axis(logp, t[..., None], -1).mean()
        return jax.grad(loss)(x)

    assert jax_rules(jstep, jnp.zeros((B, S, V)),
                     jnp.asarray(tgt.numpy())) == set()
    assert port_rules(step, logits) == set()


@pytest.mark.parametrize("case", ["index_add", "scatter_add_colliding"])
def test_colliding_atomics_stay_a_hazard(case):
    x = torch.zeros(V, D)
    src = torch.randn(B * S, D)
    idx = _tokens().reshape(-1)

    def step():
        if case == "index_add":
            return x.clone().index_add_(0, idx, src)
        # several indices along dim 0 of one column: they meet
        return x.clone().scatter_add_(0, idx[:, None].expand(-1, D), src)

    assert port_rules(step, x) == {"HVD504"}


def test_scatter_add_with_one_index_a_row_is_no_hazard():
    x = torch.zeros(B * S, V)
    src = torch.randn(B * S, 1)
    idx = _tokens().reshape(-1, 1)

    def step():
        return x.clone().scatter_add_(1, idx, src)

    assert port_rules(step, x) == set()
