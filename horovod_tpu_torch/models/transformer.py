"""Transformer LM (counterpart of horovod_tpu/models/transformer.py).

A decoder-only LM with pre-LN blocks, causal attention and a dense GELU
FFN, trained data-parallel: each rank runs the whole model on its shard
of the batch and `hvd.DistributedOptimizer` averages the gradients. The
JAX package's tp/sp/pp/ep mesh axes all have size 1 here.

Parity points with the JAX model:
  * the parameter layout at the module is the JAX one: wq/wk/wv
    (D, H, dh), wo (H, dh, D), w1 (D, F), unembed (D, V), per layer
    (models/convert.transformer_from_jax unstacks the JAX L axis);
  * `_ln` normalises in f32, casts to x.dtype, then applies scale and
    bias in x.dtype; GELU is the tanh form (jax.nn.gelu's default);
  * embedding plus position is added before the cast to cfg.dtype, the
    logits stay in cfg.dtype and the log-softmax runs in f32;
  * attn="flash" runs ops/flash_attention.py (kernels 4–6 on the card),
    attn="local" the exact blockwise_attention_reference.

Not ported yet, and refused with HorovodError rather than computed some
other way: attn "ring" and "ulysses", num_experts > 0, microbatches > 1
and remat=True (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel.ring_attention import (
    blockwise_attention_reference)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    n_layers: int = 4
    max_seq: int = 2048
    num_experts: int = 0          # 0 → dense FFN (the only one ported)
    capacity_factor: float = 2.0
    attn: str = "ring"            # "flash" | "local" ported; see check()
    microbatches: int = 1
    dtype: Any = torch.float32
    remat: bool = False
    remat_policy: str = "dots"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def check(self) -> None:
        """Raise HorovodError for what the port does not run yet."""
        todo = "is not ported to PyTorch yet (ROADMAP A11)"
        if self.attn in ("ring", "ulysses"):
            raise HorovodError(f"attn={self.attn!r} needs a sequence-"
                               f"parallel group and {todo}; use 'flash' "
                               f"or 'local'")
        if self.attn not in ("flash", "local"):
            raise HorovodError(f"attn={self.attn!r}: choose 'flash' or "
                               f"'local'")
        if self.num_experts:
            raise HorovodError(f"num_experts > 0 (MoE FFN) {todo}")
        if self.microbatches > 1:
            raise HorovodError(f"microbatches > 1 (pipeline) {todo}")
        if self.remat:
            raise HorovodError(f"remat=True {todo}")


def init(cfg: TransformerConfig, seed: int = 0,
         device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Random weights as the JAX `init` draws them (normal · fan_in^-½,
    embed · 0.02·√D, pos · 0.02, LN scale 1 and biases 0), from a
    torch.Generator seeded with `seed` on `device`. Returns the module's
    state dict. The numbers differ from JAX's: give both sides the same
    weights through models/convert.transformer_from_jax."""
    D, H, dh, Fd, V = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                       cfg.vocab)
    dev = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.dtype

    def norm(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev)
                * fan_in ** -0.5).to(dt)

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    state = {"embed": (torch.randn((V, D), generator=gen, device=dev)
                       * (0.02 * D ** 0.5)).to(dt),
             "pos": (torch.randn((cfg.max_seq, D), generator=gen,
                                 device=dev) * 0.02).to(dt)}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        state.update({
            p + "ln1_scale": full((D,), 1.0), p + "ln1_bias": full((D,), 0.0),
            p + "wq": norm((D, H, dh), D), p + "wk": norm((D, H, dh), D),
            p + "wv": norm((D, H, dh), D), p + "wo": norm((H, dh, D), H * dh),
            p + "ln2_scale": full((D,), 1.0), p + "ln2_bias": full((D,), 0.0),
            p + "w1": norm((D, Fd), D), p + "b1": full((Fd,), 0.0),
            p + "w2": norm((Fd, D), Fd), p + "b2": full((D,), 0.0)})
    state.update({"lnf_scale": full((D,), 1.0), "lnf_bias": full((D,), 0.0),
                  "unembed": norm((D, V), D)})
    return state


def _ln(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def _meta(cfg: TransformerConfig, *shape) -> nn.Parameter:
    """A parameter slot without storage; TransformerLM assigns init()'s
    tensors to it."""
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device="meta"))


class Layer(nn.Module):
    """One pre-LN block's parameters."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        D, H, dh, Fd = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        p = functools.partial(_meta, cfg)
        self.ln1_scale, self.ln1_bias = p(D), p(D)
        self.wq, self.wk, self.wv = p(D, H, dh), p(D, H, dh), p(D, H, dh)
        self.wo = p(H, dh, D)
        self.ln2_scale, self.ln2_bias = p(D), p(D)
        self.w1, self.b1, self.w2, self.b2 = p(D, Fd), p(Fd), p(Fd, D), p(D)


def _layer(x: torch.Tensor, lp: Layer, cfg: TransformerConfig):
    """One transformer block on x (B, S, D)."""
    h = _ln(x, lp.ln1_scale, lp.ln1_bias)
    # (B, H, S, dh), contiguous: flash_attention views it as (B·H, S, dh).
    q, k, v = (torch.einsum("bsd,dhk->bhsk", h, w).contiguous()
               for w in (lp.wq, lp.wk, lp.wv))
    if cfg.attn == "flash":
        a = flash_attention(q, k, v, causal=True)
    else:
        a = blockwise_attention_reference(q, k, v, causal=True)
    x = x + torch.einsum("bhsk,hkd->bsd", a, lp.wo)
    h2 = _ln(x, lp.ln2_scale, lp.ln2_bias)
    u = F.gelu(torch.matmul(h2, lp.w1) + lp.b1, approximate="tanh")
    return x + (torch.matmul(u, lp.w2) + lp.b2)


class TransformerLM(nn.Module):
    """The LM at `cfg`, weights from `init(cfg, seed, device)`."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0,
                 device: Optional[torch.device] = None):
        super().__init__()
        cfg.check()
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        p = functools.partial(_meta, cfg)
        self.embed, self.pos = p(V, D), p(cfg.max_seq, D)
        self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg.n_layers))
        self.lnf_scale, self.lnf_bias, self.unembed = p(D), p(D), p(D, V)
        self.load_state_dict(init(cfg, seed, device), assign=True)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) int → logits (B, S, V) in cfg.dtype."""
        S = tokens.shape[1]
        x = (self.embed[tokens] + self.pos[:S][None]).to(self.cfg.dtype)
        for lp in self.layers:
            x = _layer(x, lp, self.cfg)
        x = _ln(x, self.lnf_scale, self.lnf_bias)
        return torch.matmul(x, self.unembed)


def loss_fn(model: TransformerLM, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL over this rank's B·S tokens, log-softmax in
    f32. Averaged over ranks by DistributedOptimizer (equal shards), its
    gradient is that of the JAX `_local_loss`: the NLL summed over the
    global batch over the global token count."""
    logp = torch.log_softmax(model(tokens).float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()
