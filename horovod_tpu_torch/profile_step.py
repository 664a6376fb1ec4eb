"""Where a training step's device time goes.

    python -m horovod_tpu_torch.profile_step [--batch-size 32] [--steps 3]
    python -m horovod_tpu_torch.profile_step --model lm [--steps 3]
        [--num-experts E] [--microbatches M] [--remat [--remat-policy P]]

--model resnet50 (the default) trains ResNet-50 (224², bf16) on one GPU
as synthetic_benchmark does, for each route (HOROVOD_CONV_BLOCK=1,
HOROVOD_FUSE_CONV_BN=1, neither); --model lm trains the transformer LM
at the bench's flagship width (L12 D2048 F8192 H16 S1024 B12 V32768,
bf16, attn="flash") as transformer_lm does, with transformer_lm's
--num-experts, --microbatches and --remat flags. Each times `--steps` steps
after warm-up, then `--steps` more with torch.profiler tracing the
device only, and prints the wall time per step of both, the device's
busy share (the union of kernel intervals over the traced steps' wall
time) and the device time by kernel family, and writes the whole
breakdown, top kernels included, to chiprun_out/profile_step.json
(profile_step_lm.json for the LM). The families are the categories of
profiler/device_profile.py `classify`.
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
from horovod_tpu_torch.profiler import device_profile

ROUTES = {"block": ("1", "0"), "fuse_bn": ("0", "1"), "unfused": ("0", "0")}


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
    kernels = device_profile.kernel_events(prof)
    dp = device_profile.aggregate(kernels, reps=steps)
    busy = _union_us([(start, end) for _, start, end in kernels])
    return {"wall_ms_per_step": wall_us / steps / 1e3,
            "untraced_wall_ms_per_step": untraced_us / steps / 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "busy_share": busy / wall_us,
            "kernels_per_step": len(kernels) / steps,
            "family_ms_per_step": dict(sorted(dp.per_category.items(),
                                              key=lambda kv: -kv[1])),
            "top_ms_per_step": [(n[:120], v) for n, v in dp.top_ops(12)]}


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
    p.add_argument("--num-experts", type=int, default=0)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat-policy", default="dots",
                   choices=list(tfm.REMAT_POLICIES))
    args = p.parse_args(argv)
    hvd.init()
    try:
        dev = hvd.device()
        out = {"device": torch.cuda.get_device_name(dev),
               "model": args.model}
        if args.model == "lm":
            batch = args.batch_size or lm.FLAGSHIP_BATCH
            cfg = tfm.TransformerConfig(
                **lm.FLAGSHIP, attn="flash", dtype=torch.bfloat16,
                num_experts=args.num_experts,
                microbatches=args.microbatches, remat=args.remat,
                remat_policy=args.remat_policy)
            seq = cfg.max_seq
            _, _, step = lm.build(cfg, dev)
            data = lm.make_batch(batch, seq, cfg.vocab, dev, seed=hvd.rank())
            out.update(batch=batch, seq=seq,
                       config=dict(num_experts=cfg.num_experts,
                                   microbatches=cfg.microbatches,
                                   remat=cfg.remat,
                                   remat_policy=cfg.remat_policy))
            out["flash"] = profile_route(
                lambda: step(data), args.steps)
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
