"""ResNet synthetic benchmark, PyTorch twin of examples/synthetic_benchmark.py.

Random data, fixed image shape; prints images/sec per iteration. Each
process trains on its own GPU: hvd.init(), broadcast of rank 0's
weights, DistributedOptimizer over SGD(lr 0.01·size, momentum 0.9) with
the bucketed NCCL all-reduce, sync-BN over the world (the JAX
benchmark's axis_name="hvd").

Run, one process per GPU, through the launcher:
    python -m horovod_tpu_torch.runner.launch -np 8 \\
        python -m horovod_tpu_torch.synthetic_benchmark --batch-size 32

Scaling report (the reference's headline metric): the same step in a
world of 1, then in a world of N, both started through
`horovod_tpu_torch.runner.run`; one JSON line with the JAX benchmark's
keys:
    python -m horovod_tpu_torch.synthetic_benchmark --scaling-report 8

The flags are the JAX benchmark's, plus --device (cuda, or cpu for gloo
on the host; N is then bounded by nothing but the caller). Only the
ResNets are ported. Under the launcher's --autotune flags (or
HOROVOD_BUCKET_AUTOTUNE=1), rank 0 prints each tuner sample or
decision, with the buckets a step that its threshold plans, and the
frozen choice; the last line before the rate says whether every step's
loss was finite.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.models import resnet


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet50",
                   choices=["resnet50", "resnet101", "resnet152",
                            "vgg16", "vgg19", "inception3"])
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-rank batch size")
    p.add_argument("--num-warmup-batches", type=int, default=2)
    p.add_argument("--num-batches-per-iter", type=int, default=5)
    p.add_argument("--num-iters", type=int, default=3)
    p.add_argument("--image-size", type=int, default=None,
                   help="default: 299 for inception3, else 224")
    p.add_argument("--fp16-allreduce", action="store_true")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--scaling-report", type=int, default=None, metavar="N",
                   help="run a world of 1, then of N; print per-GPU "
                        "efficiency (needs N visible GPUs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (NCCL, one GPU a rank) or cpu (gloo)")
    args = p.parse_args(argv)
    if args.image_size is None:
        args.image_size = 299 if args.model == "inception3" else 224
    return args


def build(model_name: str, dtype, device, seed: int = 0):
    """The model for one rank, rank 0's weights broadcast."""
    if not model_name.startswith("resnet"):
        raise SystemExit(f"--model {model_name}: only the ResNets are "
                         f"ported to PyTorch so far")
    model = resnet.ResNet(depth=int(model_name[len("resnet"):]),
                          dtype=dtype, device=device, seed=seed)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    return model


def make_optimizer(model, compression=hvd.Compression.none):
    return hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                        momentum=0.9),
        named_parameters=model.named_parameters(), compression=compression)


def make_batch(batch: int, image_size: int, dtype, device, seed: int):
    """A random NHWC image batch and labels, made on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, image_size, image_size, 3), generator=gen,
                    device=device).to(dtype)
    y = torch.randint(0, 1000, (batch,), generator=gen, device=device)
    return x, y


def train_step(model, opt, batch, group) -> torch.Tensor:
    """One data-parallel step; returns the (local) loss."""
    opt.zero_grad()
    loss, new_stats = resnet.loss_fn(model, batch, train=True, group=group)
    loss.backward()
    opt.step()
    model.set_stats(new_stats)
    return loss.detach()


def _init(device: str) -> None:
    hvd.init(device=None if device == "cuda" else "cpu")


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_bench(args, quiet: bool = False) -> float:
    """The training loop in the current world; returns the mean total
    images/sec over the timed iterations."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    dev = hvd.device()
    k = hvd.size()
    model = build(args.model, dtype, dev)
    opt = make_optimizer(model, hvd.Compression.fp16 if
                         args.fp16_allreduce else hvd.Compression.none)
    batch = make_batch(args.batch_size, args.image_size, dtype, dev,
                       seed=hvd.rank())
    group = dist.group.WORLD
    if hvd.rank() == 0:
        print(f"Model: {args.model}, batch {args.batch_size}/rank, "
              f"{k} rank(s), dtype {args.dtype}, {_device_name(dev)}")
        print(f"World: {k} rank(s) joined over {topology.rendezvous()} "
              f"({dist.get_backend()})")
    losses = [train_step(model, opt, batch, group)
              for _ in range(args.num_warmup_batches)]
    finite = bool(torch.stack(losses).isfinite().all()) if losses else True
    rates = []
    for it in range(args.num_iters):
        t0 = time.perf_counter()
        losses = [train_step(model, opt, batch, group)
                  for _ in range(args.num_batches_per_iter)]
        # the host readback waits for the device
        finite &= bool(torch.stack(losses).isfinite().all())
        dt = time.perf_counter() - t0
        rates.append(args.batch_size * k * args.num_batches_per_iter / dt)
        if not quiet and hvd.rank() == 0:
            print(f"Iter #{it}: {rates[-1]:.1f} img/sec total, loss "
                  f"{losses[-1].item():.4f}")
    if not quiet and hvd.rank() == 0:
        report_tuners(opt)
        print(f"All losses finite: {finite}")
    return sum(rates) / len(rates)


def report_tuners(opt) -> None:
    """Print the live tuner's samples or decisions and its choice."""
    pm, bt = topology.parameter_manager(), topology.bucket_tuner()
    cfg = topology.config()
    if pm is not None:
        for vals, score in pm.samples:
            t = vals["fusion_threshold"]
            print(f"Autotune sample: threshold {t} bytes, "
                  f"{opt.buckets_at(t)} buckets/step, score {score:.6g} "
                  f"bytes/s")
        state = "frozen" if pm.frozen else "not frozen"
        print(f"Autotune {state}: {pm.frozen_choice()}, "
              f"{len(opt.plan)} buckets/step")
    if bt is not None:
        for step, new_t, freeze in bt.decisions:
            move = "keep" if new_t is None else f"move to {new_t} bytes"
            print(f"Bucket autotune decision at step {step}: {move}"
                  f"{', freeze' if freeze else ''}")
        state = "frozen" if bt.frozen else "not frozen"
        print(f"Bucket autotune {state}: threshold "
              f"{cfg.fusion_threshold_bytes} bytes, {len(opt.plan)} "
              f"buckets/step, {bt.adjustments} adjustment(s)")


def bench_world(argv) -> float:
    """One rank of a scaling-report world (runs under runner.run): join
    the world, run the benchmark, leave; returns total images/sec."""
    args = parse_args(argv)
    _init(args.device)
    try:
        return run_bench(args, quiet=True)
    finally:
        hvd.shutdown()


def scaling_report(args, argv) -> dict:
    """A world of 1, then of N, each through runner.run; prints one JSON
    line with per-GPU rates and efficiency (the JAX benchmark's keys)."""
    from horovod_tpu_torch import runner
    n = args.scaling_report
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise SystemExit(
                f"--scaling-report {n} needs {n} GPUs, have {have} "
                f"visible. Run on a machine with {n} GPUs, or rehearse "
                f"with --device cpu.")
    # The workers parse the same flags, without the report's own.
    fn = functools.partial(bench_world, _strip_report(argv))
    ips1 = runner.run(fn, np=1)[0]
    ipsn = runner.run(fn, np=n)[0]
    report = {
        "model": args.model, "per_rank_batch": args.batch_size,
        "ips_1chip": round(ips1, 1),
        "ips_per_chip_at_n": round(ipsn / n, 1),
        "n": n, "scaling_efficiency": round((ipsn / n) / ips1, 4),
    }
    print(json.dumps(report), flush=True)
    return report


def _strip_report(argv) -> list:
    """argv without --scaling-report and its value."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--scaling-report":
            skip = True
        elif not a.startswith("--scaling-report="):
            out.append(a)
    return out


def first_step() -> dict:
    """One training step of the world this process joins (run under
    runner.run): ResNet-50 at full width (224², bf16, batch 32) from the
    seed-0 weights and the rank's batch, as `run_bench` builds them.
    Returns the step's loss, the launches of kernels 1 and 2 in it and
    the card's name."""
    from horovod_tpu_torch.ops import conv_block as cb
    hvd.init()
    try:
        dev = hvd.device()
        model = build("resnet50", torch.bfloat16, dev)
        opt = make_optimizer(model)
        batch = make_batch(32, 224, torch.bfloat16, dev, seed=hvd.rank())
        cb.conv1x1_fwd_fused.launches = 0
        cb.conv1x1_bn_act_bwd_fused.launches = 0
        loss = train_step(model, opt, batch, dist.group.WORLD).item()
        return {"loss": loss,
                "launches": {"fwd": cb.conv1x1_fwd_fused.launches,
                             "act_bwd": cb.conv1x1_bn_act_bwd_fused.launches},
                "device": torch.cuda.get_device_name(dev),
                "rendezvous": topology.rendezvous()}
    finally:
        hvd.shutdown()


def main(argv=None):
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.scaling_report:
        import signal

        from horovod_tpu_torch.runner.launch import _exit_on_sigterm
        # A SIGTERM unwinds runner.run, which terminates its workers.
        signal.signal(signal.SIGTERM, _exit_on_sigterm)
        scaling_report(args, argv)
        return
    _init(args.device)
    try:
        ips = run_bench(args)
        if hvd.rank() == 0:
            print(f"Img/sec per rank: {ips / hvd.size():.1f}")
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
