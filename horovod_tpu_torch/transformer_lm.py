"""Transformer LM training over the HOROVOD_MESH mesh, PyTorch twin of
examples/transformer_lm.py and of bench.py's transformer section.

Each process trains on its own GPU: hvd.init(), the LM at the given
width and depth with random weights from a seed, Adam(lr 1e-3)
(optax.adam(1e-3) in the JAX bench). Two ways to reduce:
- a data-parallel world (no mesh, or one whose tp, pp and ep are 1):
  rank 0's weights broadcast, DistributedOptimizer with the bucketed
  all-reduce over the whole world, each rank's loss the mean over its
  tokens;
- tp, pp or ep above 1: each rank builds its shard of the seed's
  weights, and DistributedOptimizer(sharding_spec=..., op=Sum) runs the
  sharded step on the LM's local_loss (the JAX build_train_step: every
  gradient over tp, then summed over the axes its leaf is replicated
  on).
The tokens shard over (dp, ep) and sp, as the JAX bspec P(("dp", "ep"),
"sp") cuts them: each data block (dp, ep) draws `--batch-size`
sequences of `--seq-len` tokens from the seed of its block index
dp·ep_size + ep, the targets are the global roll(tokens, -1) along the
sequence, and each rank of the block's sp group keeps its contiguous
slice of both, cut after the roll (a roll of each slice would give each
slice's last position the wrong target). The tp and pp members of a
block hold the same tokens. Prints tokens/s over the global batch,
ms/step, the share of the cards' peak that the model FLOPs reach, and
the world's mean loss.

Run:  python -m horovod_tpu_torch.transformer_lm --attn flash
      python -m horovod_tpu_torch.transformer_lm --d-model 2048 \\
          --n-layers 12 --n-heads 16 --d-ff 8192 --seq-len 1024 \\
          --batch-size 12 --vocab 32768     (the bench's flagship)
      python -m horovod_tpu_torch.runner.launch -np 4 \\
          python -m horovod_tpu_torch.transformer_lm --attn ring --sp 4

      python -m horovod_tpu_torch.runner.launch -np 4 \\
          python -m horovod_tpu_torch.transformer_lm --pp 2 --tp 2 \\
          --microbatches 2 --remat

The mesh: `--sp`, `--tp`, `--pp` and `--ep` set HOROVOD_MESH (dp takes
the other ranks) where the variable is unset, and must agree with it
where it is set; `--attn ring|ulysses` attends across the sp group,
`--num-experts E` makes every FFN a top-1 MoE of E experts over ep,
`--microbatches M` runs the pipeline (needed where pp > 1), `--remat`
recomputes each layer in the backward pass under `--remat-policy`.
--device cpu runs on the host with gloo (no kernel: the plain versions).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.parallel.mesh import axis_sizes
from horovod_tpu_torch.profiler import flops as F

# bench.py's flagship LM (bench_transformer): the width chip_smoke.py
# trains and profile_step.py --model lm traces.
FLAGSHIP = dict(vocab=32768, d_model=2048, n_heads=16, d_ff=8192,
                n_layers=12, max_seq=1024)
FLAGSHIP_BATCH = 12


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--d-ff", type=int, default=None,
                   help="default: 4 * d-model")
    p.add_argument("--vocab", type=int, default=8192)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8,
                   help="sequences per dp replica")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--attn", default="flash", choices=list(tfm.ATTN))
    for axis, what in MESH_FLAGS.items():
        p.add_argument(f"--{axis}", type=int, default=None,
                       help=f"{what} ranks (HOROVOD_MESH {axis})")
    p.add_argument("--num-experts", type=int, default=0,
                   help="experts of every layer's MoE FFN (0: dense)")
    p.add_argument("--microbatches", type=int, default=1,
                   help="pipeline microbatches (> 1 where pp > 1)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each layer in the backward pass")
    p.add_argument("--remat-policy", default="dots",
                   choices=list(tfm.REMAT_POLICIES))
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default=None, choices=["cpu"],
                   help="cpu: train on the host with gloo")
    return p.parse_args(argv)


#: The mesh flags and what their ranks do.
MESH_FLAGS = {"sp": "sequence-parallel", "tp": "tensor-parallel",
              "pp": "pipeline-stage", "ep": "expert-parallel"}


def mesh_env(args) -> Optional[str]:
    """The HOROVOD_MESH the flags ask for ("tp=2,pp=2"), or None where
    none is given."""
    parts = [f"{a}={getattr(args, a)}" for a in MESH_FLAGS
             if getattr(args, a) is not None]
    return ",".join(parts) if parts else None


def check_mesh_flags(args) -> None:
    """Each mesh flag given must agree with the mesh in force."""
    spec = hvd.mesh_spec()
    for axis in MESH_FLAGS:
        want = getattr(args, axis)
        got = getattr(spec, axis) if spec is not None else 1
        if want is not None and want != got:
            raise HorovodError(
                f"--{axis} {want} disagrees with HOROVOD_MESH="
                f"{os.environ.get('HOROVOD_MESH')!r} ({axis}={got})")


def config(args) -> tfm.TransformerConfig:
    return tfm.TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        d_ff=args.d_ff or 4 * args.d_model, n_layers=args.n_layers,
        max_seq=args.seq_len, attn=args.attn, num_experts=args.num_experts,
        microbatches=args.microbatches,
        remat=args.remat, remat_policy=args.remat_policy,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32)


def sharded(mesh) -> bool:
    """Whether the LM runs the sharded step on `mesh`: tp, pp or ep > 1."""
    return mesh is not None and any(mesh.shape[a] > 1
                                    for a in ("tp", "pp", "ep"))


def build(cfg: tfm.TransformerConfig, device, seed: int = 0):
    """(model, optimizer, step) for one rank; `step(batch)` trains one
    step and returns the loss (world_loss makes it the world's).
    Data-parallel: rank 0's weights broadcast, the bucketed hook path.
    Sharded: the rank's shard of the seed's weights, the optimizer's
    sharded step on the LM's local_loss."""
    model = tfm.TransformerLM(cfg, seed=seed, device=device)
    inner = torch.optim.Adam(model.parameters(), lr=1e-3)
    if not sharded(model.mesh):
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            inner, named_parameters=model.named_parameters())

        def step(batch) -> torch.Tensor:
            opt.zero_grad()
            loss = tfm.loss_fn(model, *batch)
            loss.backward()
            opt.step()
            return loss.detach()
        return model, opt, step
    opt = hvd.DistributedOptimizer(
        inner, named_parameters=model.named_parameters(), op=hvd.Sum,
        sharding_spec=tfm.named_specs(model), mesh=model.mesh)
    return model, opt, opt.sharded_step(
        lambda _, batch: tfm.local_loss(model, *batch),
        batch_spec=BATCH_SPEC, loss_axes=LOSS_AXES)


#: How the tokens shard (the JAX bspec), and the axes the local_loss
#: values sum over to the global mean.
BATCH_SPEC = (("dp", "ep"), "sp")
LOSS_AXES = ("dp", "ep", "sp", "pp")


def make_batch(batch: int, seq: int, vocab: int, device, seed: int):
    """Random tokens and their next-token targets, made on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, vocab, (batch, seq), generator=gen,
                           device=device)
    return tokens, torch.roll(tokens, -1, dims=1)


def coords():
    """(data block index, sp index, sp size) of this rank: its block
    dp·ep_size + ep over (dp, ep) and its sp coordinates on the
    HOROVOD_MESH mesh, or (rank, 0, 1) in a data-parallel world."""
    mesh = hvd.hybrid_mesh()
    if mesh is None:
        return hvd.rank(), 0, 1
    at, size = mesh.coords(hvd.rank()), mesh.shape
    return at["dp"] * size["ep"] + at["ep"], at["sp"], size["sp"]


def rank_batch(batch: int, seq: int, vocab: int, device):
    """This rank's (tokens, targets): its data block's batch from the
    block's seed, the targets rolled over the whole sequence, then the
    rank's sp slice of both."""
    dp_i, sp_i, sp_n = coords()
    if seq % sp_n:
        raise HorovodError(f"--seq-len {seq} does not split over sp={sp_n}")
    tokens, targets = make_batch(batch, seq, vocab, device, seed=dp_i)
    n = seq // sp_n
    return (tokens[:, sp_i * n:(sp_i + 1) * n].contiguous(),
            targets[:, sp_i * n:(sp_i + 1) * n].contiguous())


def world_loss(loss: torch.Tensor) -> float:
    """The loss over the global batch: the mean of the ranks' losses,
    whose token counts are equal (the JAX step's psum of the local
    contributions). The sharded step's loss is the world's on every
    rank already, so its mean is itself."""
    return float(hvd.allreduce(loss, op=hvd.Average))


def report(cfg, batch: int, seq: int, step_s: float, device_name: str,
           ranks: int = 1):
    """tokens/s over a global batch of `batch` sequences of `seq` tokens,
    ms/step and the model-FLOPs share of the peak of `ranks` cards
    (None where the card's peak is unknown)."""
    tps = batch * seq / step_s
    flops = F.transformer_train_flops_per_token(
        cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab, seq) * tps
    peak = F.peak_flops_per_chip(device_name)
    return {"tokens_per_s": tps, "step_ms": step_s * 1e3,
            "mfu": flops / (peak * ranks) if peak else None}


def _flash_launches():
    from horovod_tpu_torch.ops import flash_attention as fa
    return {"attn_fwd": fa.flash_fwd.launches,
            "attn_dkdv": fa.flash_bwd_dkdv.launches,
            "attn_dq": fa.flash_bwd_dq.launches}


def run(cfg: tfm.TransformerConfig, batch: int, warmup: int, steps: int,
        seed: int = 0) -> dict:
    """Build the LM from `seed` on this rank's device and train
    `warmup` + `steps` steps on rank_batch. Returns the world's mean loss
    of every step, the global tokens/s and ms/step of the timed steps
    (report), this rank's launches of kernels 4–6 over all the steps
    (counted from 0 here) and its peak device memory."""
    from horovod_tpu_torch.ops import flash_attention as fa
    dev = hvd.device()
    _, _, step = build(cfg, dev, seed)
    data = rank_batch(batch, cfg.max_seq, cfg.vocab, dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    for f in (fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq):
        f.launches = 0
    losses = [step(data) for _ in range(warmup)]
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(data) for _ in range(steps)]
    if cuda:
        torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / max(steps, 1)
    launches = _flash_launches()
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    sizes = axis_sizes()
    return dict(losses=[world_loss(v) for v in losses],
                launches=launches,
                peak_mem_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                             if cuda else None), device=name,
                world=hvd.size(), sp=sizes["sp"], mesh=sizes,
                **report(cfg, hvd.size() // (sizes["pp"] * sizes["sp"] *
                                             sizes["tp"]) * batch,
                         cfg.max_seq, step_s, name, hvd.size()))


def flagship_steps(attn: str, warmup: int = 1, steps: int = 3,
                   **cfg_kw) -> dict:
    """`run` at the flagship width and batch in bf16, in the world this
    process joins (a `runner.run` worker; HOROVOD_MESH from its env),
    `cfg_kw` the config's other fields (num_experts, microbatches,
    remat)."""
    hvd.init()
    try:
        cfg = tfm.TransformerConfig(**FLAGSHIP, attn=attn,
                                    dtype=torch.bfloat16, **cfg_kw)
        return run(cfg, FLAGSHIP_BATCH, warmup, steps)
    finally:
        hvd.shutdown()


def main(argv=None):
    args = parse_args(argv)
    if mesh_env(args) and not os.environ.get("HOROVOD_MESH"):
        os.environ["HOROVOD_MESH"] = mesh_env(args)
    hvd.init(device=args.device)
    try:
        check_mesh_flags(args)
        cfg = config(args)
        if hvd.rank() == 0:
            n = F.transformer_matmul_params(cfg.d_model, cfg.d_ff,
                                            cfg.n_layers, cfg.vocab)
            spec = hvd.mesh_spec()
            print(f"LM L{cfg.n_layers} D{cfg.d_model} F{cfg.d_ff} "
                  f"H{cfg.n_heads} S{args.seq_len} B{args.batch_size} "
                  f"V{cfg.vocab} {args.dtype} attn={cfg.attn}, "
                  f"{n / 1e6:.1f} M params, {hvd.size()} rank(s), mesh "
                  f"{spec.describe() if spec else 'dp only'}")
        r = run(cfg, args.batch_size, args.warmup, args.steps)
        if hvd.rank() == 0:
            mfu = "n/a" if r["mfu"] is None else f"{r['mfu']:.3f}"
            print(f"{r['tokens_per_s']:.0f} tokens/s over the global batch "
                  f"on {r['device']}, {r['step_ms']:.2f} ms/step, "
                  f"model-FLOPs share of peak {mfu}, final loss "
                  f"{r['losses'][-1]:.4f}")
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
