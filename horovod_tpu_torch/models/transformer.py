"""Transformer LM (counterpart of horovod_tpu/models/transformer.py).

A decoder-only LM with pre-LN blocks, causal attention and a dense GELU
or top-1 MoE FFN, over every axis of the HOROVOD_MESH mesh
(parallel/mesh.py), each rank holding its shard of the weights as the
JAX `param_specs` lays them out:

  dp/ep — the batch shards over (dp, ep);
  tp    — each rank holds H/tp heads of wq/wk/wv/wo and F/tp columns of
          w1/b1 (rows of w2); the attention output and the dense FFN's
          are summed over tp (parallel/comm.py psum);
  sp    — each rank of an sp group holds a contiguous slice of every
          sequence and adds the positions of its own slice; attention
          crosses the slices by ring (attn="ring",
          parallel/ring_attention.py) or Ulysses (attn="ulysses",
          parallel/ulysses.py) attention;
  pp    — stage s holds layers [s·L/pp, (s+1)·L/pp), under their global
          names (`layers.<i>`), and the microbatches run the GPipe
          schedule of parallel/pipeline.py; only the last stage's
          logits are real (zeros elsewhere);
  ep    — with num_experts > 0 every layer's FFN is the MoE of
          parallel/moe.py, each rank holding E/ep experts.

Parity points with the JAX model:
  * the parameter layout at the module is the JAX one: wq/wk/wv
    (D, H, dh), wo (H, dh, D), w1 (D, F), router (D, E), we1 (E, D, F),
    unembed (D, V), per layer (models/convert.transformer_from_jax
    unstacks the JAX L axis, `transformer_shard_from_jax` cuts a rank's
    shard);
  * `_ln` normalises in f32, casts to x.dtype, then applies scale and
    bias in x.dtype; GELU is the tanh form (jax.nn.gelu's default);
  * embedding plus position is added before the cast to cfg.dtype, the
    logits stay in cfg.dtype and the log-softmax runs in f32;
  * attn="flash" runs ops/flash_attention.py (kernels 4–6 on the card)
    and refuses sp > 1, as shard-local attention would be wrong there;
    attn="local" the exact blockwise_attention_reference; "ring" and
    "ulysses" need the HOROVOD_MESH mesh (at sp = 1 they run on one
    rank);
  * remat=True recomputes each layer in the backward pass
    (torch.utils.checkpoint, non-reentrant): "full" saves nothing,
    "dots" saves the outputs of the matmuls without a batch dimension
    (the projections, the FFN and the router: aten.mm) and recomputes
    the rest, as jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    does. The flash kernels launch outside the dispatcher, where no
    policy sees them: kernel 4 runs again in every recompute, as JAX
    recomputes the attention under "dots".

Two losses: `loss_fn`, the mean over this rank's tokens, for the
data-parallel world whose DistributedOptimizer averages the ranks; and
`local_loss`, the JAX `_local_loss` (masked to the last pipeline stage,
over the global token count), for the sharded step of
optim/optimizer.py, which sums each gradient over the axes its leaf is
replicated on (`grad_reduce_axes`).
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
from horovod_tpu_torch.parallel.comm import psum
from horovod_tpu_torch.parallel.mesh import (axes_process_set, axis_index,
                                             axis_sizes, current_mesh,
                                             mesh_axis_sizes, shard_of,
                                             use_mesh)
from horovod_tpu_torch.parallel.moe import moe_ffn
from horovod_tpu_torch.parallel.pipeline import pipeline_apply
from horovod_tpu_torch.parallel.ring_attention import (
    blockwise_attention_reference, ring_attention)
from horovod_tpu_torch.parallel.ulysses import ulysses_attention

ATTN = ("ring", "ulysses", "flash", "local")
REMAT_POLICIES = ("dots", "full")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    n_layers: int = 4
    max_seq: int = 2048
    num_experts: int = 0          # 0 → dense FFN; > 0 → MoE every layer
    capacity_factor: float = 2.0
    attn: str = "ring"            # one of ATTN
    microbatches: int = 1         # pipeline microbatches
    dtype: Any = torch.float32
    remat: bool = False
    remat_policy: str = "dots"    # one of REMAT_POLICIES

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def check(self) -> None:
        """Raise HorovodError for an attention or remat policy the
        model does not know."""
        if self.attn not in ATTN:
            raise HorovodError(f"attn={self.attn!r}: choose from {ATTN}")
        if self.remat and self.remat_policy not in REMAT_POLICIES:
            raise HorovodError(
                f"remat_policy={self.remat_policy!r}: choose from "
                f"{sorted(REMAT_POLICIES)} (remat=False turns remat off)")


def init(cfg: TransformerConfig, seed: int = 0,
         device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Random global weights as the JAX `init` draws them (normal ·
    fan_in^-½, embed · 0.02·√D, pos · 0.02, LN scale 1 and biases 0),
    from a torch.Generator seeded with `seed` on `device`, under the
    module's names. The numbers differ from JAX's: give both sides the
    same weights through models/convert.transformer_from_jax."""
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
            p + "ln2_scale": full((D,), 1.0), p + "ln2_bias": full((D,), 0.0)})
        if cfg.num_experts:
            E = cfg.num_experts
            state.update({p + "router": norm((D, E), D),
                          p + "we1": norm((E, D, Fd), D),
                          p + "we2": norm((E, Fd, D), Fd)})
        else:
            state.update({p + "w1": norm((D, Fd), D),
                          p + "b1": full((Fd,), 0.0),
                          p + "w2": norm((Fd, D), Fd),
                          p + "b2": full((D,), 0.0)})
    state.update({"lnf_scale": full((D,), 1.0), "lnf_bias": full((D,), 0.0),
                  "unembed": norm((D, V), D)})
    return state


def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """The JAX `param_specs` tree (specs as tuples): the layer leaves are
    the JAX stacked ones, their first entry "pp" the layer axis."""
    lp = {"ln1_scale": ("pp", None), "ln1_bias": ("pp", None),
          "wq": ("pp", None, "tp", None), "wk": ("pp", None, "tp", None),
          "wv": ("pp", None, "tp", None), "wo": ("pp", "tp", None, None),
          "ln2_scale": ("pp", None), "ln2_bias": ("pp", None)}
    if cfg.num_experts:
        lp.update({"router": ("pp", None, None),
                   "we1": ("pp", "ep", None, None),
                   "we2": ("pp", "ep", None, None)})
    else:
        lp.update({"w1": ("pp", None, "tp"), "b1": ("pp", "tp"),
                   "w2": ("pp", "tp", None), "b2": ("pp", None)})
    return {"embed": (), "pos": (), "layers": lp, "lnf_scale": (),
            "lnf_bias": (), "unembed": ()}


def grad_reduce_axes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The JAX `grad_reduce_axes` tree: per leaf, the axes its gradient
    is summed over (after the division by tp; see local_loss). It is
    what optim/optimizer.py grad_axes_from_specs derives from
    `param_specs` on a mesh whose every axis is live."""
    data_axes = ("dp", "ep", "sp", "tp")
    glob = ("dp", "ep", "sp", "pp", "tp")
    tp_sharded = ("dp", "ep", "sp")
    lp = {"ln1_scale": data_axes, "ln1_bias": data_axes,
          "ln2_scale": data_axes, "ln2_bias": data_axes,
          "wq": tp_sharded, "wk": tp_sharded, "wv": tp_sharded,
          "wo": tp_sharded}
    if cfg.num_experts:
        lp.update({"router": data_axes, "we1": ("dp", "sp", "tp"),
                   "we2": ("dp", "sp", "tp")})
    else:
        lp.update({"w1": tp_sharded, "b1": tp_sharded, "w2": tp_sharded,
                   "b2": data_axes})
    return {"embed": glob, "pos": glob, "layers": lp, "lnf_scale": glob,
            "lnf_bias": glob, "unembed": glob}


def leaf_spec(cfg: TransformerConfig, name: str) -> tuple:
    """The spec of the module's parameter `name` (`layers.3.wq` → the
    stacked leaf's ("pp", None, "tp", None))."""
    specs = param_specs(cfg)
    parts = name.split(".")
    return specs["layers"][parts[-1]] if parts[0] == "layers" \
        else specs[name]


def named_specs(model: "TransformerLM") -> Dict[str, tuple]:
    """{parameter name: spec} of `model`, for
    DistributedOptimizer(sharding_spec=...)."""
    return {n: leaf_spec(model.cfg, n) for n, _ in model.named_parameters()}


def shard_state(state: Dict[str, Any], cfg: TransformerConfig, mesh=None,
                rank: Optional[int] = None) -> Dict[str, Any]:
    """Rank `rank`'s (default this rank's) entries of a global state dict
    on `mesh` (default the mesh in force): the layers of its pipeline
    stage, each leaf cut by its spec. The whole dict without a mesh."""
    m = mesh if mesh is not None else current_mesh()
    if m is None:
        return dict(state)
    if rank is None:
        from horovod_tpu_torch.core import topology
        rank = topology.rank()
    per = cfg.n_layers // mesh_axis_sizes(m)["pp"]
    stage = m.coords(rank)["pp"]
    out = {}
    for name, v in state.items():
        parts = name.split(".")
        if parts[0] == "layers" and int(parts[1]) // per != stage:
            continue
        out[name] = shard_of(v, leaf_spec(cfg, name), m, rank)
    return out


def checkpoint_tree(model: "TransformerLM", tree: Optional[dict] = None,
                    specs: Optional[dict] = None) -> dict:
    """`tree` ({parameter name: tensor}, default the model's parameters
    under named_specs; an optimizer's named state under its
    opt_state_specs works too) as checkpoint Fragments
    (ckpt/sharded.py) over the whole LM's names: every rank saves the
    same tree, as the checkpointer's writers must. The layers of the
    other pipeline stages are declared (their global shape and spec, no
    data) and written by their own stage."""
    from horovod_tpu_torch.ckpt import sharded
    if tree is None:
        tree = {n: p.detach() for n, p in model.named_parameters()}
        specs = named_specs(model)
    frags = sharded.fragments(tree, specs, model.mesh)
    mine = list(model.layers)
    for i in range(model.cfg.n_layers):
        if str(i) in model.layers:
            continue
        src = f"layers.{mine[i % len(mine)]}."  # the same leaves as layer i
        for name in [n for n in frags if n.startswith(src)]:
            frags[f"layers.{i}.{name[len(src):]}"] = _declared(frags[name])
    return frags


def _declared(x):
    """A leaf another stage writes: its entry, without data."""
    from horovod_tpu_torch.ckpt import sharded
    if isinstance(x, dict):
        return {k: _declared(v) for k, v in x.items()}
    if isinstance(x, sharded.Fragment):
        return x._replace(data=x.data.new_empty(0), write=False)
    return x


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
    """One pre-LN block's parameters, this rank's shard of them on a mesh
    of axis sizes `sizes`."""

    def __init__(self, cfg: TransformerConfig, sizes: Dict[str, int]):
        super().__init__()
        D, dh = cfg.d_model, cfg.head_dim
        H, Fd = cfg.n_heads // sizes["tp"], cfg.d_ff // sizes["tp"]
        p = functools.partial(_meta, cfg)
        self.ln1_scale, self.ln1_bias = p(D), p(D)
        self.wq, self.wk, self.wv = p(D, H, dh), p(D, H, dh), p(D, H, dh)
        self.wo = p(H, dh, D)
        self.ln2_scale, self.ln2_bias = p(D), p(D)
        if cfg.num_experts:
            E = cfg.num_experts // sizes["ep"]
            self.router = p(D, cfg.num_experts)
            self.we1, self.we2 = p(E, D, cfg.d_ff), p(E, cfg.d_ff, D)
        else:
            self.w1, self.b1 = p(D, Fd), p(Fd)
            self.w2, self.b2 = p(Fd, D), p(cfg.d_model)


def _sp_set(cfg: TransformerConfig):
    """This rank's sp process set, or None where sp is 1 or there is no
    mesh (the rank holds whole sequences)."""
    if current_mesh() is not None:
        return axes_process_set("sp")
    if cfg.attn in ("ring", "ulysses"):
        raise HorovodError(
            f"attn={cfg.attn!r} runs over the sp axis of the HOROVOD_MESH "
            f"mesh: set HOROVOD_MESH (e.g. \"sp=4\") before hvd.init()")
    return None


def batch_shard(x: torch.Tensor, mesh=None, rank: Optional[int] = None
                ) -> torch.Tensor:
    """Rank `rank`'s block of a global (B, S, ...) batch: rows over
    (dp, ep), columns over sp (the JAX bspec P(("dp", "ep"), "sp"))."""
    return shard_of(x, (("dp", "ep"), "sp"), mesh, rank)


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (B, S, D) by w (D, H, dh) → (B, H, S, dh), contiguous (what
    flash_attention views as (B·H, S, dh)); one aten.mm."""
    B, S, D = h.shape
    out = torch.matmul(h, w.reshape(D, -1)).view(B, S, w.shape[1], -1)
    return out.transpose(1, 2).contiguous()


def _layer(x: torch.Tensor, lp: Layer, cfg: TransformerConfig, sp=None):
    """One transformer block on this rank's activations x (B, S_loc, D);
    `sp` is the sequence-parallel process set (None: S_loc = S)."""
    h = _ln(x, lp.ln1_scale, lp.ln1_bias)
    q, k, v = (_proj(h, w) for w in (lp.wq, lp.wk, lp.wv))
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
    B, Hl, S, dh = a.shape
    o = torch.matmul(a.transpose(1, 2).reshape(B, S, Hl * dh),
                     lp.wo.reshape(Hl * dh, -1))
    x = x + psum(o, "tp")                     # row-parallel combine
    h2 = _ln(x, lp.ln2_scale, lp.ln2_bias)
    if cfg.num_experts:
        D = h2.shape[-1]
        f = moe_ffn(h2.reshape(-1, D), lp.router, lp.we1, lp.we2, "ep",
                    capacity_factor=cfg.capacity_factor).view(h2.shape)
    else:
        u = F.gelu(torch.matmul(h2, lp.w1) + lp.b1, approximate="tanh")
        f = psum(torch.matmul(u, lp.w2), "tp") + lp.b2
    return x + f


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the matmuls without a batch dimension."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: TransformerConfig):
    """`fn` recomputed in the backward pass under cfg.remat_policy, or
    `fn` itself without remat."""
    if not cfg.remat:
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *a: checkpoint(fn, *a, **kw)


class TransformerLM(nn.Module):
    """This rank's share of the LM at `cfg` on the HOROVOD_MESH mesh (the
    whole LM without one), weights from `init(cfg, seed, device)`."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0,
                 device: Optional[torch.device] = None):
        super().__init__()
        cfg.check()
        self.cfg = cfg
        self.mesh = current_mesh()
        validate_cfg_for_mesh(cfg, self.mesh)
        sizes = axis_sizes(self.mesh)
        D, V = cfg.d_model, cfg.vocab
        p = functools.partial(_meta, cfg)
        self.embed, self.pos = p(V, D), p(cfg.max_seq, D)
        per = cfg.n_layers // sizes["pp"]
        first = axis_index("pp", self.mesh) * per
        self.layers = nn.ModuleDict(
            (str(i), Layer(cfg, sizes)) for i in range(first, first + per))
        self.lnf_scale, self.lnf_bias, self.unembed = p(D), p(D), p(D, V)
        self.load_state_dict(shard_state(init(cfg, seed, device), cfg,
                                         self.mesh), assign=True)

    def _stage(self, _, x: torch.Tensor) -> torch.Tensor:
        sp = _sp_set(self.cfg)
        for lp in self.layers.values():
            x = _remat(functools.partial(_layer, lp=lp, cfg=self.cfg,
                                         sp=sp), self.cfg)(x)
        return x

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's tokens (B, S_loc) int → logits (B, S_loc, V) in
        cfg.dtype; under pp > 1 the last stage's, zeros on the others.
        Under sp > 1 the tokens are slice sp_idx of each sequence, at
        positions [sp_idx·S_loc, (sp_idx+1)·S_loc)."""
        with use_mesh(self.mesh):
            _sp_set(self.cfg)  # ring/ulysses refuse to run without a mesh
            B, S = tokens.shape
            i = axis_index("sp")
            pos = self.pos[i * S:(i + 1) * S]
            x = (self.embed[tokens] + pos[None]).to(self.cfg.dtype)
            M = self.cfg.microbatches
            if M > 1:
                if B % M:
                    raise HorovodError(f"local batch {B} not divisible by "
                                       f"microbatches {M}")
                xm = x.reshape(M, B // M, S, x.shape[-1])
                x = pipeline_apply(self._stage, None, xm, "pp").reshape(
                    x.shape)
            else:
                x = self._stage(None, x)
            x = _ln(x, self.lnf_scale, self.lnf_bias)
            return torch.matmul(x, self.unembed)


def _nll(model: TransformerLM, tokens: torch.Tensor,
         targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(model(tokens).float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None])[..., 0]


def loss_fn(model: TransformerLM, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL over this rank's B·S_loc tokens, log-softmax
    in f32: the loss of the data-parallel world (tp = pp = ep = 1).
    Averaged over the world by DistributedOptimizer (equal shards over
    dp and sp), its gradient is that of the JAX `_local_loss` summed by
    the gradient psums: the NLL summed over the global batch over the
    global token count.

    Under sp > 1 that holds only because the ring's (and Ulysses')
    backward returns each k/v cotangent to the rank the block came from:
    rank r's loss depends on the k and v of every rank before it, and
    those ranks' wk and wv gradients must hold that dependence before
    the all-reduce sums the ranks' gradients."""
    return _nll(model, tokens, targets).mean()


def local_loss(model: TransformerLM, tokens: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """The JAX `_local_loss`: this rank's NLL sum over the global token
    count B·S·dp·ep·sp, masked to the last pipeline stage (the others
    hold zeros for logits). Not summed over the mesh: the gradient
    reduction does that (a psum before the backward pass would scale
    the cotangents by the axis sizes). Every tp member computes the
    same value, so per-rank autograd scales each gradient by tp, which
    the sharded step divides back out (optim/optimizer.py
    REDUNDANT_LOSS_AXES)."""
    with use_mesh(model.mesh):
        sizes = axis_sizes()
        is_last = float(axis_index("pp") == sizes["pp"] - 1)
    B, S = tokens.shape
    n_tokens = B * S * sizes["dp"] * sizes["ep"] * sizes["sp"]
    return _nll(model, tokens, targets).sum() * is_last / n_tokens


def validate_cfg_for_mesh(cfg: TransformerConfig, mesh) -> None:
    """Refuse a config the mesh (`hvd.hybrid_mesh()`, or None for a
    data-parallel world) cannot run, with the JAX package's checks and
    messages."""
    ax = axis_sizes(mesh) if mesh is not None else \
        {a: 1 for a in ("dp", "pp", "ep", "sp", "tp")}
    checks = [
        (cfg.n_layers % ax["pp"] == 0, "n_layers % pp"),
        (cfg.n_heads % ax["tp"] == 0, "n_heads % tp"),
        (cfg.d_ff % ax["tp"] == 0, "d_ff % tp"),
        (cfg.num_experts % ax["ep"] == 0 if cfg.num_experts else True,
         "num_experts % ep"),
        # Without the microbatch pipeline stages never exchange
        # activations: each would train its own layers on embeddings.
        (ax["pp"] == 1 or cfg.microbatches > 1,
         "pp > 1 requires microbatches > 1"),
    ]
    if cfg.attn == "ulysses":
        checks.append((cfg.n_heads // ax["tp"] % ax["sp"] == 0,
                       "heads/tp % sp for ulysses"))
    for ok, what in checks:
        if not ok:
            raise HorovodError(f"config/mesh mismatch: {what}")
