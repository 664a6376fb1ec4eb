"""Data-parallel transformer LM training, PyTorch twin of
examples/transformer_lm.py and of bench.py's transformer section.

Each process trains on its own GPU: hvd.init(), the LM at the given
width and depth with random weights from a seed, broadcast of rank 0's
weights, DistributedOptimizer over Adam(lr 1e-3) (optax.adam(1e-3) in
the JAX bench) with the bucketed all-reduce, seeded tokens with targets
= roll(tokens, -1). Prints tokens/s per GPU, ms/step and the share of
the card's peak that the model FLOPs reach.

Run:  python -m horovod_tpu_torch.transformer_lm --attn flash
      python -m horovod_tpu_torch.transformer_lm --d-model 2048 \\
          --n-layers 12 --n-heads 16 --d-ff 8192 --seq-len 1024 \\
          --batch-size 12 --vocab 32768     (the bench's flagship)

--device cpu runs on the host with gloo (no kernel: the plain versions).
The JAX example's tp/sp/pp/ep axes and ring/Ulysses attention are not
ported yet.
"""

from __future__ import annotations

import argparse
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tfm
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
                   help="per-rank batch size")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--attn", default="flash", choices=["flash", "local"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default=None, choices=["cpu"],
                   help="cpu: train on the host with gloo")
    return p.parse_args(argv)


def config(args) -> tfm.TransformerConfig:
    return tfm.TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        d_ff=args.d_ff or 4 * args.d_model, n_layers=args.n_layers,
        max_seq=args.seq_len, attn=args.attn,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32)


def build(cfg: tfm.TransformerConfig, device, seed: int = 0):
    """(model, optimizer) for one rank, rank 0's weights broadcast."""
    model = tfm.TransformerLM(cfg, seed=seed, device=device)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3),
        named_parameters=model.named_parameters())
    return model, opt


def make_batch(batch: int, seq: int, vocab: int, device, seed: int):
    """Random tokens and their next-token targets, made on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, vocab, (batch, seq), generator=gen,
                           device=device)
    return tokens, torch.roll(tokens, -1, dims=1)


def train_step(model, opt, batch) -> torch.Tensor:
    """One data-parallel step; returns the (local) loss."""
    opt.zero_grad()
    loss = tfm.loss_fn(model, *batch)
    loss.backward()
    opt.step()
    return loss.detach()


def report(cfg, batch: int, seq: int, step_s: float, device_name: str):
    """tokens/s per rank, ms/step and the model-FLOPs share of the card's
    peak (None where the card's peak is unknown)."""
    tps = batch * seq / step_s
    flops = F.transformer_train_flops_per_token(
        cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab, seq) * tps
    peak = F.peak_flops_per_chip(device_name)
    return {"tokens_per_s": tps, "step_ms": step_s * 1e3,
            "mfu": flops / peak if peak else None}


def main(argv=None):
    args = parse_args(argv)
    hvd.init(device=args.device)
    try:
        cfg = config(args)
        dev = hvd.device()
        model, opt = build(cfg, dev)
        batch = make_batch(args.batch_size, args.seq_len, cfg.vocab, dev,
                           seed=hvd.rank())
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        if hvd.rank() == 0:
            n = F.transformer_matmul_params(cfg.d_model, cfg.d_ff,
                                            cfg.n_layers, cfg.vocab)
            print(f"LM L{cfg.n_layers} D{cfg.d_model} F{cfg.d_ff} "
                  f"H{cfg.n_heads} S{args.seq_len} B{args.batch_size} "
                  f"V{cfg.vocab} {args.dtype} attn={cfg.attn}, "
                  f"{n / 1e6:.1f} M params, {hvd.size()} rank(s), {name}")
        for _ in range(args.warmup):
            loss = train_step(model, opt, batch)
        loss.item()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = train_step(model, opt, batch)
        final = loss.item()  # host readback waits for the device
        r = report(cfg, args.batch_size, args.seq_len,
                   (time.perf_counter() - t0) / args.steps, name)
        if hvd.rank() == 0:
            mfu = "n/a" if r["mfu"] is None else f"{r['mfu']:.3f}"
            print(f"{r['tokens_per_s']:.0f} tokens/s per rank, "
                  f"{r['step_ms']:.2f} ms/step, model-FLOPs share of peak "
                  f"{mfu}, final loss {final:.4f}")
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
