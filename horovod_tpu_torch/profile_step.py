"""Where a training step's device time goes.

    python -m horovod_tpu_torch.profile_step [--batch-size 32] [--steps 3]
    python -m horovod_tpu_torch.profile_step --model lm [--steps 3]

--model resnet50 (the default) trains ResNet-50 (224², bf16) on one GPU
as synthetic_benchmark does, for each route (HOROVOD_CONV_BLOCK=1,
HOROVOD_FUSE_CONV_BN=1, neither); --model lm trains the transformer LM
at the bench's flagship width (L12 D2048 F8192 H16 S1024 B12 V32768,
bf16, attn="flash") as transformer_lm does. Each times `--steps` steps
after warm-up, then `--steps` more with torch.profiler tracing the
device only, and prints the wall time per step of both, the device's
busy share (the union of kernel intervals over the traced steps' wall
time) and the device time by kernel family, and writes the whole
breakdown, top kernels included, to chiprun_out/profile_step.json
(profile_step_lm.json for the LM).
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
from horovod_tpu_torch import transformer_lm as lm
from horovod_tpu_torch.models import transformer as tfm

ROUTES = {"block": ("1", "0"), "fuse_bn": ("0", "1"), "unfused": ("0", "0")}


def family(name: str) -> str:
    n = name.lower()
    if "hvd" in n:
        return "port kernels"
    if "nccl" in n:
        return "nccl"
    if ("gemm" in n and "implicit" not in n or "cutlass" in n
            or "nvjet" in n):  # nvjet: cuBLAS's Hopper GEMMs
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


def _wall_us(step, steps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6


def profile_route(step, steps: int):
    """Time `steps` calls of step() after 3 warm-up calls, then trace
    `steps` more. Only the device is traced (no host op events), so the
    traced steps take about as long as the untraced ones and the busy
    share is read within the traced window itself."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        step()
    untraced_us = _wall_us(step, steps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_us = _wall_us(step, steps)
    # Device-side events, without the GPU spans of user annotations
    # (e.g. "Optimizer.step#Adam.step"), which cover kernels already
    # counted.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    by_family, by_name = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_family[family(e.name)] = by_family.get(family(e.name), 0.0) + d
        by_name[e.name] = by_name.get(e.name, 0.0) + d
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms_per_step": wall_us / steps / 1e3,
            "untraced_wall_ms_per_step": untraced_us / steps / 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "busy_share": busy / wall_us,
            "kernels_per_step": len(kernels) / steps,
            "family_ms_per_step": {k: v / steps / 1e3 for k, v in
                                   sorted(by_family.items(),
                                          key=lambda kv: -kv[1])},
            "top_ms_per_step": [(n[:120], v / steps / 1e3) for n, v in top]}


def _print(route, r):
    fam = ", ".join(f"{k} {v:.2f}" for k, v in
                    r["family_ms_per_step"].items())
    print(f"profile {route}: wall {r['wall_ms_per_step']:.2f} ms/step"
          f" traced ({r['untraced_wall_ms_per_step']:.2f} untraced)"
          f", device busy {r['device_busy_ms_per_step']:.2f} ms "
          f"({r['busy_share']:.3f}), {r['kernels_per_step']:.0f} "
          f"kernels/step; ms/step by family: {fam}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet50", choices=["resnet50", "lm"])
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: 32 for resnet50, 12 for lm")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    hvd.init()
    try:
        dev = hvd.device()
        out = {"device": torch.cuda.get_device_name(dev),
               "model": args.model}
        if args.model == "lm":
            batch = args.batch_size or lm.FLAGSHIP_BATCH
            cfg = tfm.TransformerConfig(**lm.FLAGSHIP, attn="flash",
                                        dtype=torch.bfloat16)
            seq = cfg.max_seq
            model, opt = lm.build(cfg, dev)
            data = lm.make_batch(batch, seq, cfg.vocab, dev, seed=hvd.rank())
            out.update(batch=batch, seq=seq)
            out["flash"] = profile_route(
                lambda: lm.train_step(model, opt, data), args.steps)
            _print("lm flash", out["flash"])
            name = "profile_step_lm.json"
        else:
            batch = args.batch_size or 32
            model = sb.build("resnet50", torch.bfloat16, dev)
            opt = sb.make_optimizer(model)
            data = sb.make_batch(batch, args.image_size, torch.bfloat16,
                                 dev, seed=hvd.rank())
            out["batch"] = batch
            for route, (block, fuse) in ROUTES.items():
                os.environ["HOROVOD_CONV_BLOCK"] = block
                os.environ["HOROVOD_FUSE_CONV_BN"] = fuse
                out[route] = profile_route(
                    lambda: sb.train_step(model, opt, data,
                                          dist.group.WORLD), args.steps)
                _print(route, out[route])
            name = "profile_step.json"
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", name), "w") as f:
            json.dump(out, f, indent=1)
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
