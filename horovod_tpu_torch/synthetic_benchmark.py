"""ResNet synthetic benchmark, PyTorch twin of examples/synthetic_benchmark.py.

Random data, fixed image shape; prints images/sec per iteration. Each
process trains on its own GPU: hvd.init(), broadcast of rank 0's
weights, DistributedOptimizer over SGD(lr 0.01·size, momentum 0.9) with
the bucketed NCCL all-reduce, sync-BN over the world (the JAX
benchmark's axis_name="hvd").

Run:  python -m horovod_tpu_torch.synthetic_benchmark --batch-size 32

The flags are the JAX benchmark's. Only the ResNets are ported, and
--scaling-report waits for the launcher's port.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
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
                   help="1 vs N device efficiency (not ported yet)")
    return p.parse_args(argv)


def build(model_name: str, dtype, device, seed: int = 0):
    """(model, optimizer) for one rank, rank 0's weights broadcast."""
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


def main(argv=None):
    args = parse_args(argv)
    if args.scaling_report:
        raise SystemExit("--scaling-report needs the launcher, which is "
                         "not ported to PyTorch yet")
    hvd.init()
    try:
        if args.image_size is None:
            args.image_size = 299 if args.model == "inception3" else 224
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
                  f"{k} rank(s), dtype {args.dtype}, "
                  f"{torch.cuda.get_device_name(dev)}")
        for _ in range(args.num_warmup_batches):
            loss = train_step(model, opt, batch, group)
        loss.item()
        rates = []
        for it in range(args.num_iters):
            t0 = time.perf_counter()
            for _ in range(args.num_batches_per_iter):
                loss = train_step(model, opt, batch, group)
            loss.item()  # host readback waits for the device
            dt = time.perf_counter() - t0
            rates.append(args.batch_size * k * args.num_batches_per_iter / dt)
            if hvd.rank() == 0:
                print(f"Iter #{it}: {rates[-1]:.1f} img/sec total")
        if hvd.rank() == 0:
            print(f"Img/sec per rank: {sum(rates) / len(rates) / k:.1f}")
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
