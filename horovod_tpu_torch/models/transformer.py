"""Transformer LM (counterpart of horovod_tpu/models/transformer.py).

A decoder-only LM with pre-LN blocks, causal attention and a dense GELU
FFN. Each rank runs the whole model on its shard of the tokens and
`hvd.DistributedOptimizer` averages the gradients over the world. The
batch is sharded over dp and, under HOROVOD_MESH with sp > 1, the
sequence over sp: each rank of an sp group holds a contiguous slice of
every sequence, adds the positions of its own slice, and attention
crosses the slices by ring (attn="ring", parallel/ring_attention.py)
or Ulysses (attn="ulysses", parallel/ulysses.py) attention over the
group (`hvd.axis_process_set("sp")`). The JAX package's tp, pp and ep
axes stay at size 1 (ROADMAP A11 part 2; `validate_cfg_for_mesh`).

Parity points with the JAX model:
  * the parameter layout at the module is the JAX one: wq/wk/wv
    (D, H, dh), wo (H, dh, D), w1 (D, F), unembed (D, V), per layer
    (models/convert.transformer_from_jax unstacks the JAX L axis);
  * `_ln` normalises in f32, casts to x.dtype, then applies scale and
    bias in x.dtype; GELU is the tanh form (jax.nn.gelu's default);
  * embedding plus position is added before the cast to cfg.dtype, the
    logits stay in cfg.dtype and the log-softmax runs in f32;
  * attn="flash" runs ops/flash_attention.py (kernels 4–6 on the card)
    and refuses sp > 1, as shard-local attention would be wrong there;
    attn="local" the exact blockwise_attention_reference; "ring" and
    "ulysses" need the HOROVOD_MESH mesh (at sp = 1 they run on one
    rank).

Not ported yet, and refused with HorovodError rather than computed some
other way: num_experts > 0, microbatches > 1 and remat=True (ROADMAP
A11 part 2).
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
from horovod_tpu_torch.parallel.mesh import mesh_axis_sizes
from horovod_tpu_torch.parallel.ring_attention import (
    blockwise_attention_reference, ring_attention)
from horovod_tpu_torch.parallel.ulysses import ulysses_attention

ATTN = ("ring", "ulysses", "flash", "local")


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
    attn: str = "ring"            # one of ATTN
    microbatches: int = 1
    dtype: Any = torch.float32
    remat: bool = False
    remat_policy: str = "dots"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def check(self) -> None:
        """Raise HorovodError for what the port does not run yet."""
        todo = "is not ported to PyTorch yet (ROADMAP A11 part 2)"
        if self.attn not in ATTN:
            raise HorovodError(f"attn={self.attn!r}: choose from {ATTN}")
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


def _sp_set(cfg: TransformerConfig):
    """This rank's sp process set, or None where there is no HOROVOD_MESH
    mesh (the rank holds whole sequences)."""
    from horovod_tpu_torch.core import process_sets, topology
    if topology.is_initialized() and topology.mesh_spec() is not None:
        return process_sets.axis_process_set("sp")
    if cfg.attn in ("ring", "ulysses"):
        raise HorovodError(
            f"attn={cfg.attn!r} runs over the sp axis of the HOROVOD_MESH "
            f"mesh: set HOROVOD_MESH (e.g. \"sp=4\") before hvd.init()")
    return None


def _layer(x: torch.Tensor, lp: Layer, cfg: TransformerConfig, sp=None):
    """One transformer block on this rank's activations x (B, S_loc, D);
    `sp` is the sequence-parallel process set (None: S_loc = S)."""
    h = _ln(x, lp.ln1_scale, lp.ln1_bias)
    # (B, H, S, dh), contiguous: flash_attention views it as (B·H, S, dh).
    q, k, v = (torch.einsum("bsd,dhk->bhsk", h, w).contiguous()
               for w in (lp.wq, lp.wk, lp.wv))
    if cfg.attn == "ring":
        a = ring_attention(q, k, v, "sp", causal=True)
    elif cfg.attn == "ulysses":
        a = ulysses_attention(q, k, v, "sp", causal=True)
    elif cfg.attn == "flash":
        # Shard-local attention: silently wrong on a sharded sequence.
        if sp is not None and sp.size() > 1:
            raise HorovodError(
                "attn='flash' requires sp=1 (shard-local attention); use "
                "attn='ring' or 'ulysses' for sequence parallelism")
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
        """This rank's tokens (B, S_loc) int → logits (B, S_loc, V) in
        cfg.dtype. Under sp > 1 the tokens are slice sp_idx of each
        sequence, at positions [sp_idx·S_loc, (sp_idx+1)·S_loc)."""
        from horovod_tpu_torch.core import topology
        sp = _sp_set(self.cfg)
        S = tokens.shape[1]
        i = sp.rank_index(topology.rank()) if sp is not None else 0
        pos = self.pos[i * S:(i + 1) * S]
        x = (self.embed[tokens] + pos[None]).to(self.cfg.dtype)
        for lp in self.layers:
            x = _layer(x, lp, self.cfg, sp)
        x = _ln(x, self.lnf_scale, self.lnf_bias)
        return torch.matmul(x, self.unembed)


def loss_fn(model: TransformerLM, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL over this rank's B·S_loc tokens, log-softmax
    in f32. Averaged over the world by DistributedOptimizer (equal
    shards over dp and sp), its gradient is that of the JAX
    `_local_loss` summed by the gradient psums: the NLL summed over the
    global batch over the global token count.

    Under sp > 1 that holds only because the ring's (and Ulysses')
    backward returns each k/v cotangent to the rank the block came from:
    rank r's loss depends on the k and v of every rank before it, and
    those ranks' wk and wv gradients must hold that dependence before
    the all-reduce sums the ranks' gradients."""
    logp = torch.log_softmax(model(tokens).float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()


def validate_cfg_for_mesh(cfg: TransformerConfig, mesh) -> None:
    """Refuse a config the mesh (`hvd.hybrid_mesh()`, or None for a
    data-parallel world) cannot run: tp, pp and ep above 1 are not
    ported (ROADMAP A11 part 2); Ulysses needs heads % sp == 0."""
    ax = mesh_axis_sizes(mesh) if mesh is not None else {}
    for a in ("tp", "pp", "ep"):
        if ax.get(a, 1) > 1:
            raise HorovodError(
                f"mesh axis {a}={ax[a]} is not ported to PyTorch yet "
                f"(ROADMAP A11 part 2); the port runs dp and sp")
    if cfg.attn == "ulysses" and cfg.n_heads % ax.get("sp", 1):
        raise HorovodError("config/mesh mismatch: heads/tp % sp for ulysses")
