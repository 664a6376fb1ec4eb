"""Tied-embedding LM (counterpart of horovod_tpu/models/tied_lm.py): the
model the hybrid-parallel step trains, `horovod_tpu_torch/hybrid_lm.py`
runs and bench.py's gspmd_hybrid section measures (a tied embedding and
residual tanh-FFN blocks).

Two formulations of the same math, as in the JAX module:

* `global_loss` — the dense reference on one rank;
* `local_loss` — the shard-local (Megatron-LM, Shoeybi et al.,
  arXiv:1909.08053) formulation for the sharded step of
  optim/optimizer.py: a vocab-parallel embedding lookup (mask, local
  gather, psum over tp), a column/row-parallel FFN (`wi` sharded on its
  F dim, `wo`'s product psum'd) and the vocab-parallel cross entropy
  (pmax/psum log-sum-exp and a masked target gather). Every tp member
  ends with the same loss, computed cooperatively, and no rank holds
  the full logits. Every axis op is an identity at size 1, so the same
  code is the pure data-parallel step on a dp=N mesh.

`init` and `sample_batch` draw from `np.random.default_rng(seed)` in the
JAX order, so the two packages' weights and batches are equal bit for
bit. The parameters are a flat {name: tensor} dict (`emb`, `wi<i>`,
`wo<i>`), the JAX tree's keys.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from horovod_tpu_torch.parallel.comm import pmax, psum
from horovod_tpu_torch.parallel.mesh import axis_index


@dataclasses.dataclass(frozen=True)
class TiedLMConfig:
    vocab: int = 8192
    d_model: int = 512
    d_ff: int = 2048
    n_layers: int = 2
    dtype: Any = torch.float32


def canonical_config() -> TiedLMConfig:
    """The JAX package's canonical shapes (a 16 MB f32 embedding), the
    ones bench.py's gspmd_hybrid section trains."""
    return TiedLMConfig(vocab=8192, d_model=512, d_ff=2048, n_layers=2)


def init(seed: int, cfg: TiedLMConfig,
         device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Global (unsharded) parameters, the JAX `init`'s numbers exactly:
    numpy's default_rng(seed) draws in the same order, cast to
    cfg.dtype."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            device=device, dtype=cfg.dtype)

    params = {"emb": t(rng.standard_normal((cfg.vocab, cfg.d_model))
                       * 0.02)}
    for i in range(cfg.n_layers):
        params[f"wi{i}"] = t(rng.standard_normal((cfg.d_model, cfg.d_ff))
                             * 0.02)
        params[f"wo{i}"] = t(rng.standard_normal((cfg.d_ff, cfg.d_model))
                             * 0.02)
    return params


def param_specs(cfg: TiedLMConfig) -> Dict[str, tuple]:
    """The hybrid layout: vocab-sharded embedding, column-parallel `wi`,
    row-parallel `wo`, every parameter sharded over tp."""
    specs: Dict[str, tuple] = {"emb": ("tp", None)}
    for i in range(cfg.n_layers):
        specs[f"wi{i}"] = (None, "tp")
        specs[f"wo{i}"] = ("tp", None)
    return specs


def replicated_specs(cfg: TiedLMConfig) -> Dict[str, tuple]:
    """Everything replicated (the pure data-parallel layout)."""
    return {k: () for k in param_specs(cfg)}


def sample_batch(seed: int, cfg: TiedLMConfig, batch: int = 16,
                 seq: int = 64, device: Optional[torch.device] = None):
    """Deterministic (tokens, targets), the JAX batch exactly: targets
    are the next-token roll."""
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq)).astype(
        np.int64)).to(device)
    return tok, torch.roll(tok, -1, dims=1)


def global_loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                targets: torch.Tensor, cfg: TiedLMConfig,
                constrain_logits: Optional[Callable] = None
                ) -> torch.Tensor:
    """Dense reference: mean next-token NLL on one rank.
    `constrain_logits` is the JAX analysis twin's sharding-constraint
    hook (static analysis, ROADMAP A15); here it is applied as a plain
    callable on the logits, and the identity is what it should be."""
    h = params["emb"][tokens]
    for i in range(cfg.n_layers):
        h = h + torch.tanh(h @ params[f"wi{i}"]) @ params[f"wo{i}"]
    logits = h @ params["emb"].T          # tied unembedding
    if constrain_logits is not None:
        logits = constrain_logits(logits)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None]).mean()


def local_loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
               targets: torch.Tensor, cfg: TiedLMConfig,
               tp_axis: str = "tp") -> torch.Tensor:
    """Shard-local loss: `params` this rank's shards under param_specs,
    `tokens`/`targets` its batch shard. Returns the local batch shard's
    mean NLL, the same on every `tp_axis` member, not reduced over the
    batch axes (the sharded step owns that)."""
    emb = params["emb"]
    v_loc = emb.shape[0]
    lo = axis_index(tp_axis) * v_loc

    def vocab_parallel_rows(ids):
        """Embedding rows of global ids from the local vocab shard:
        ids outside it give zeros, and the psum assembles the rows."""
        local = ids - lo
        ok = (local >= 0) & (local < v_loc)
        rows = emb[local.clamp(0, v_loc - 1)]
        rows = torch.where(ok[..., None], rows, torch.zeros_like(rows))
        return psum(rows.to(cfg.dtype), tp_axis)

    h = vocab_parallel_rows(tokens)
    for i in range(cfg.n_layers):
        u = torch.tanh(h @ params[f"wi{i}"])               # column-parallel
        h = h + psum(u @ params[f"wo{i}"], tp_axis)        # row-parallel
    lf = (h @ emb.T).float()              # (B_loc, S, V_loc) shard
    # Vocab-parallel log-softmax: the global max (a shift that cancels in
    # the derivative, so it carries no gradient), then the psum'd exp-sum.
    m = pmax(lf.detach().amax(dim=-1), tp_axis)
    se = psum(torch.exp(lf - m[..., None]).sum(dim=-1), tp_axis)
    lse = m + torch.log(se)
    tgt_local = targets - lo
    ok = (tgt_local >= 0) & (tgt_local < v_loc)
    picked = torch.gather(lf, -1, tgt_local.clamp(0, v_loc - 1)[..., None])
    tgt_logit = psum(torch.where(ok, picked[..., 0],
                                 torch.zeros_like(picked[..., 0])), tp_axis)
    return (lse - tgt_logit).mean()
