"""Where a training step's device time goes, per fused-site route.

    python -m horovod_tpu_torch.profile_step [--batch-size 32] [--steps 3]

Trains ResNet-50 (224², bf16) on one GPU as synthetic_benchmark does, for
each route (HOROVOD_CONV_BLOCK=1, HOROVOD_FUSE_CONV_BN=1, neither), and
traces `--steps` steps after warm-up with torch.profiler. For each route
it prints the wall time per step, the device's busy share (the union of
kernel intervals over the traced window) and the device time by kernel
family, and writes the whole breakdown, top kernels included, to
chiprun_out/profile_step.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch import synthetic_benchmark as sb

ROUTES = {"block": ("1", "0"), "fuse_bn": ("0", "1"), "unfused": ("0", "0")}


def family(name: str) -> str:
    n = name.lower()
    if "hvd" in n:
        return "port kernels"
    if "nccl" in n:
        return "nccl"
    if "gemm" in n and "implicit" not in n or "cutlass" in n:
        return "gemm"
    if any(k in n for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                            "implicit")):
        return "conv"
    if "reduce" in n:
        return "reduction"
    if any(k in n for k in ("elementwise", "vectorized", "unrolled")):
        return "elementwise"
    return "other"


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_route(model, opt, data, group, steps: int):
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        sb.train_step(model, opt, data, group)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sb.train_step(model, opt, data, group)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_family, by_name = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_family[family(e.name)] = by_family.get(family(e.name), 0.0) + d
        by_name[e.name] = by_name.get(e.name, 0.0) + d
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "busy_share": busy / wall_us,
            "kernels_per_step": len(kernels) / steps,
            "family_ms_per_step": {k: v / steps / 1e3 for k, v in
                                   sorted(by_family.items(),
                                          key=lambda kv: -kv[1])},
            "top_ms_per_step": [(n[:120], v / steps / 1e3) for n, v in top]}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    hvd.init()
    try:
        dev = hvd.device()
        model = sb.build("resnet50", torch.bfloat16, dev)
        opt = sb.make_optimizer(model)
        data = sb.make_batch(args.batch_size, args.image_size,
                             torch.bfloat16, dev, seed=hvd.rank())
        out = {"device": torch.cuda.get_device_name(dev),
               "batch": args.batch_size}
        for route, (block, fuse) in ROUTES.items():
            os.environ["HOROVOD_CONV_BLOCK"] = block
            os.environ["HOROVOD_FUSE_CONV_BN"] = fuse
            r = profile_route(model, opt, data, dist.group.WORLD, args.steps)
            out[route] = r
            fam = ", ".join(f"{k} {v:.2f}" for k, v in
                            r["family_ms_per_step"].items())
            print(f"profile {route}: wall {r['wall_ms_per_step']:.2f} ms/step"
                  f", device busy {r['device_busy_ms_per_step']:.2f} ms "
                  f"({r['busy_share']:.3f}), {r['kernels_per_step']:.0f} "
                  f"kernels/step; ms/step by family: {fam}")
        os.makedirs("chiprun_out", exist_ok=True)
        with open("chiprun_out/profile_step.json", "w") as f:
            json.dump(out, f, indent=1)
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
