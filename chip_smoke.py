#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build  — nvcc builds the three CUDA kernels from
     horovod_tpu_torch/csrc/, one process per source, in parallel;
  2. kernel checks — each kernel against its plain PyTorch version on
     the card, bf16, at ResNet-50 site shapes (batch 32) plus a ragged M
     and a C that is no multiple of 16; kernel 2's ReLU mask against the
     forward's z > 0 on an input built to sit on the boundary; then each
     kernel, its plain version and a PyTorch yardstick timed at every
     fused site shape of a ResNet-50 step, beside the card's bound;
  3. main path — hvd.init(), ResNet-50 at full width (224², bf16,
     batch 32) with HOROVOD_CONV_BLOCK=1, broadcast_parameters,
     DistributedOptimizer(SGD momentum 0.9) with the bucketed NCCL
     all-reduce: 2 warm-up and 5 timed steps, the launch counters read
     around them; then one step from the same weights on the unfused
     route, whose loss must match;
  4. kernel 3 on its path — 2 steps with HOROVOD_FUSE_CONV_BN=1.
Then the `kernels` JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Exits non-zero without a CUDA device, and wherever a check fails.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12    # dense bf16 tensor cores, same source

CHECK_SHAPES = [(100352, 64, 256), (25088, 512, 128), (6272, 1024, 256),
                (6272, 1024, 512), (6271, 64, 200), (1001, 24, 50)]
# Tolerances, each relative to the reference's scale (bf16 keeps 8
# significant bits; both sides accumulate in f32 in different orders, so
# a rounded output may differ by one bf16 step, 2^-7 of the largest
# value; f32 outputs only by accumulation order):
TOL_BF16 = 2.0 ** -7        # y, dx: max|Δ| / max|ref|
TOL_SUMS = 1e-3             # Σy: max|Δ| / Σ|y| per channel; Σy²: relative
TOL_DW = 1e-3               # dW (f32): max|Δ| / max|ref|
TOL_LOSS = 2e-2             # fused vs unfused step loss, relative (bf16
                            # activations through 50 layers)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(kind: str, m: int, cin: int, c: int):
    """(bound ms, bytes ms, flops ms): each input read once, each output
    written once, over HBM; the products' flops over bf16 peak."""
    if kind == "fwd":
        nbytes = 2 * m * cin + 2 * cin * c + 2 * m * c + 2 * 4 * c
        flops = 2 * m * cin * c
    else:
        rows = 7 if kind == "act_bwd" else 5
        nbytes = (2 * 2 * m * c + 2 * m * cin + 2 * cin * c + 4 * rows * c
                  + 2 * m * cin + 4 * cin * c)
        flops = 4 * m * cin * c
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return max(tb, tf), tb, tf


class Failed(Exception):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# ---------------------------------------------------------------- inputs

def site_inputs(m, cin, c, dev, seed):
    """bf16 site inputs and the f32 rows both backward kernels take."""
    import torch
    from horovod_tpu_torch.ops import conv_block as cb
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn((m, cin), generator=g, device=dev).to(bf)
    w = (torch.randn((cin, c), generator=g, device=dev)
         * cin ** -0.5).to(bf)
    scale = (1 + 0.5 * torch.randn((c,), generator=g, device=dev)).to(bf)
    bias = (0.1 * torch.randn((c,), generator=g, device=dev)).to(bf)
    dz = torch.randn((m, c), generator=g, device=dev).to(bf)
    y, ssum, ssq = cb._fwd_plain(x, w)
    mean = ssum / m
    inv = torch.rsqrt(ssq / m - mean.square() + 1e-5)
    db_m, dg_m = cb._bn_act_sums(dz, y, mean, inv, scale, bias, True)
    g2, a2, b2 = cbb.fold_rows(scale.float(), inv, db_m, dg_m, None, None, m)
    db, dg = cbb._bn_sums(dz, y, mean, inv)
    g3, a3, b3 = cbb.fold_rows(scale.float(), inv, db, dg, None, None, m)
    return dict(x=x, w=w, scale=scale, bias=bias, dz=dz, y=y, mean=mean,
                inv=inv, db_m=db_m, dg_m=dg_m, db=db, dg=dg,
                rows2=(g2, mean, inv, a2, b2, scale.float(), bias.float()),
                rows3=(g3, mean, inv, a3, b3))


def run_k1(s):
    from horovod_tpu_torch.ops import conv_block as cb
    return cb.conv1x1_fwd_fused(s["x"], s["w"])


def plain_k1(s):
    from horovod_tpu_torch.ops import conv_block as cb
    return cb._fwd_plain(s["x"], s["w"])


def run_k2(s):
    from horovod_tpu_torch.ops import conv_block as cb
    return cb.conv1x1_bn_act_bwd_fused(
        s["dz"], s["y"], s["x"], s["w"], s["scale"], s["bias"], s["mean"],
        s["inv"], s["db_m"], s["dg_m"])


def plain_k2(s):
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    return cbb._bwd_plain(s["dz"], s["y"], s["x"], s["w"], *s["rows2"])


def run_k3(s):
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    return cbb.conv1x1_bn_bwd_fused(
        s["dz"], s["y"], s["x"], s["w"], s["scale"].float(), s["mean"],
        s["inv"], s["db"], s["dg"])


def plain_k3(s):
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    return cbb._bwd_plain(s["dz"], s["y"], s["x"], s["w"], *s["rows3"])


def library_fwd(s):
    import torch
    y = torch.matmul(s["x"], s["w"])
    yf = y.float()
    return y, yf.sum(0), yf.square().sum(0)


def library_bwd(s, dy):
    import torch
    return torch.matmul(dy, s["w"].t()), torch.matmul(s["x"].t(), dy)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_outputs(name, got, ref):
    """Hold one kernel's outputs against the plain version's; returns
    the max abs error over its outputs."""
    if name == "fwd":
        (y, s1, s2), (yr, s1r, s2r) = got, ref
        e = _err(y, yr)
        need(e <= TOL_BF16 * float(yr.float().abs().max()),
             f"kernel 1 y: max|Δ| {e}")
        scale = yr.float().abs().sum(0) + 1e-30
        rel = float(((s1 - s1r).abs() / scale).max())
        need(rel <= TOL_SUMS, f"kernel 1 sum: {rel} of Σ|y|")
        rel2 = float(((s2 - s2r).abs() / (s2r.abs() + 1e-30)).max())
        need(rel2 <= TOL_SUMS, f"kernel 1 sumsq: relative {rel2}")
        return max(e, _err(s1, s1r), _err(s2, s2r)), f"y {e:.3g}, Σy rel {rel:.3g}, Σy² rel {rel2:.3g}"
    (dx, dw), (dxr, dwr) = got, ref
    e1, e2 = _err(dx, dxr), _err(dw, dwr)
    need(e1 <= TOL_BF16 * float(dxr.float().abs().max()),
         f"{name} dx: max|Δ| {e1}")
    need(e2 <= TOL_DW * float(dwr.abs().max()), f"{name} dW: max|Δ| {e2}")
    return max(e1, e2), (f"dx {e1:.3g} (max {float(dxr.float().abs().max()):.3g}),"
                         f" dW {e2:.3g} (max {float(dwr.abs().max()):.3g})")


def check_kernels(dev):
    """Every kernel against its plain version at CHECK_SHAPES, then the
    mask check; returns each kernel's largest max abs error."""
    import torch
    worst = {"fwd": 0.0, "act_bwd": 0.0, "bn_bwd": 0.0}
    for i, (m, cin, c) in enumerate(CHECK_SHAPES):
        s = site_inputs(m, cin, c, dev, seed=i)
        for name, run, plain in (("fwd", run_k1, plain_k1),
                                 ("act_bwd", run_k2, plain_k2),
                                 ("bn_bwd", run_k3, plain_k3)):
            got = run(s)
            torch.cuda.synchronize()
            ref = plain(s)
            for t in got:
                need(bool(torch.isfinite(t.float()).all()),
                     f"{name} at {(m, cin, c)}: non-finite output")
            err, msg = check_outputs(name, got, ref)
            worst[name] = max(worst[name], err)
            print(f"check {name:8s} M={m:6d} Cin={cin:4d} C={c:4d}: {msg}")
        del s
    mask_check(dev)
    return worst


def mask_check(dev, m=25088, c=256):
    """Kernel 2's ReLU mask equals the forward's z > 0, read out through
    the kernel itself: with w = I, dz = 1, g = 1 and a = b = 0 the
    kernel's dy is its mask and dx = dy @ wᵀ returns it. y takes few
    distinct values and each channel's bias cancels one of them exactly,
    so many pre-activations are exactly 0 (the mask must say 0 there)."""
    import torch
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    g = torch.Generator(device=dev).manual_seed(99)
    y = (torch.round(torch.randn((m, c), generator=g, device=dev) * 4) / 4
         ).to(torch.bfloat16)
    yf = y.float()
    mean = yf.mean(0)
    inv = torch.rsqrt(yf.square().mean(0) - mean.square() + 1e-5)
    scale = (1 + 0.3 * torch.randn((c,), generator=g, device=dev)).to(
        torch.bfloat16).float()
    bias = -(((yf[0] - mean) * inv) * scale)   # row 0's value sits at 0
    zf = ((yf - mean) * inv) * scale + bias     # the forward's f32 chain
    fwd_mask = zf > 0
    on_boundary = int((zf == 0).sum())
    eye = torch.eye(c, device=dev, dtype=torch.bfloat16)
    ones = torch.ones((m, c), device=dev, dtype=torch.bfloat16)
    one, zero = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    dx, _ = cbb.launch_bwd("conv1x1_bn_act_bwd", "hvd_conv1x1_bn_act_bwd",
                           ones, y, ones, eye,
                           [t.contiguous() for t in
                            (one, mean, inv, zero, zero, scale, bias)])
    torch.cuda.synchronize()
    kmask = dx != 0
    equal = int((kmask == fwd_mask).sum())
    print(f"check mask: {equal}/{m * c} equal to the forward's z > 0; "
          f"{on_boundary} pre-activations exactly on the boundary")
    need(on_boundary >= m, "mask check: too few boundary values")
    need(equal == m * c, f"kernel 2 mask differs at {m * c - equal} places")
    return equal, m * c, on_boundary


def time_kernels(dev):
    """Per-step times over the 28 fused sites of a ResNet-50 step at batch
    32: kernel, plain version, PyTorch yardstick and bound, each summed
    over the sites (site shape × its count)."""
    import torch
    from horovod_tpu_torch.models import resnet
    sites = resnet.fused_sites(50, 32, 224)
    shapes = {}
    for _, _, m, cin, c in sites:
        shapes[(m, cin, c)] = shapes.get((m, cin, c), 0) + 1
    agg = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, flops_ms=0.0)
           for k in ("fwd", "act_bwd", "bn_bwd")}
    detail = []
    for i, ((m, cin, c), count) in enumerate(sorted(shapes.items())):
        s = site_inputs(m, cin, c, dev, seed=100 + i)
        dy2 = (s["rows2"][0] * s["dz"].float() - s["rows2"][3]
               - s["rows2"][4] * (s["y"].float() - s["mean"]) * s["inv"]
               ).to(torch.bfloat16)
        for name, run, plain, lib in (
                ("fwd", run_k1, plain_k1, library_fwd),
                ("act_bwd", run_k2, plain_k2, lambda s: library_bwd(s, dy2)),
                ("bn_bwd", run_k3, plain_k3,
                 lambda s: library_bwd(s, dy2))):
            t = {"ms": time_ms(lambda: run(s)),
                 "plain_ms": time_ms(lambda: plain(s), iters=5),
                 "library_ms": time_ms(lambda: lib(s))}
            b, tb, tf = bound(name, m, cin, c)
            t.update(bound_ms=b, bytes_ms=tb, flops_ms=tf)
            for key, v in t.items():
                agg[name][key] += v * count
            detail.append(dict(kernel=name, M=m, Cin=cin, C=c, count=count,
                               **t))
            print(f"time {name:8s} M={m:6d} Cin={cin:4d} C={c:4d} x{count}: "
                  f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, "
                  f"library {t['library_ms']:.4f}, bound {b:.4f} "
                  f"({'bytes' if tb >= tf else 'operations'})")
        del s, dy2
    return agg, detail


# ---------------------------------------------------------------- main path

def reset_counters():
    from horovod_tpu_torch.ops import conv_block as cb
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    for f in (cb.conv1x1_fwd_fused, cb.conv1x1_bn_act_bwd_fused,
              cbb.conv1x1_bn_bwd_fused):
        f.launches = 0


def read_counters():
    from horovod_tpu_torch.ops import conv_block as cb
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    return {"fwd": cb.conv1x1_fwd_fused.launches,
            "act_bwd": cb.conv1x1_bn_act_bwd_fused.launches,
            "bn_bwd": cbb.conv1x1_bn_bwd_fused.launches}


def drive(sb, model, opt, data, group, warmup, timed):
    """`warmup` + `timed` training steps with the launch counters set to
    0 just before and read just after. Returns (losses, img/s of the
    timed steps, ms/step, counts)."""
    import torch
    reset_counters()
    losses = [sb.train_step(model, opt, data, group) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [sb.train_step(model, opt, data, group) for _ in range(timed)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counters()
    losses = [float(v) for v in losses]
    need(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    n = data[0].shape[0]
    return losses, n * timed / dt, dt / timed * 1e3, counts


def main_path(batch=32, image=224, depth=50, warmup=2, timed=5):
    """The port's training path at full width; each route driven with
    the counters read around it."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb

    os.environ["HOROVOD_CONV_BLOCK"] = "1"
    os.environ["HOROVOD_FUSE_CONV_BN"] = "0"
    hvd.init()
    dev = hvd.device()
    model = sb.build(f"resnet{depth}", torch.bfloat16, dev)
    opt = sb.make_optimizer(model)
    data = sb.make_batch(batch, image, torch.bfloat16, dev, seed=hvd.rank())
    group = dist.group.WORLD
    steps = warmup + timed
    out = {"buckets": len(opt.plan), "world": hvd.size(), "batch": batch}

    losses, ips, ms, counts = drive(sb, model, opt, data, group, warmup,
                                    timed)
    out["block"] = dict(losses=losses, img_per_s=ips, step_ms=ms,
                        launches=counts,
                        per_step={k: v / steps for k, v in counts.items()})
    print(f"main path: ResNet-{depth} {image}² bf16 batch {batch}, "
          f"{hvd.size()} rank(s), {out['buckets']} buckets; losses "
          f"{[round(v, 5) for v in losses]}")
    print(f"main path: {ips:.1f} img/s, {ms:.2f} ms/step; launches per "
          f"step {out['block']['per_step']}")
    need(counts["fwd"] == 28 * steps and counts["act_bwd"] == 28 * steps,
         f"expected 28 + 28 launches per step, got {counts}")
    need(counts["bn_bwd"] == 0, "kernel 3 ran on the block route")

    # Same weights, fused and unfused route: the step losses must match.
    snap_m = copy.deepcopy(model.state_dict())
    snap_o = copy.deepcopy(opt.state_dict())
    loss_f = sb.train_step(model, opt, data, group).item()
    model.load_state_dict(snap_m)
    opt.load_state_dict(snap_o)
    os.environ["HOROVOD_CONV_BLOCK"] = "0"
    losses, ips, ms, counts = drive(sb, model, opt, data, group, 1, timed)
    loss_u = losses[0]
    rel = abs(loss_f - loss_u) / max(abs(loss_u), 1e-6)
    out["unfused"] = dict(losses=losses, img_per_s=ips, step_ms=ms,
                          launches=counts, loss_fused=loss_f,
                          loss_rel=rel)
    print(f"route check: fused loss {loss_f:.6f}, unfused {loss_u:.6f}, "
          f"relative difference {rel:.3g} (tolerance {TOL_LOSS}); "
          f"unfused route {ips:.1f} img/s, {ms:.2f} ms/step")
    need(sum(counts.values()) == 0, "the unfused route ran a kernel")
    need(rel <= TOL_LOSS, "fused and unfused losses disagree")

    # Kernel 3 on its own path.
    os.environ["HOROVOD_FUSE_CONV_BN"] = "1"
    losses, ips, ms, counts = drive(sb, model, opt, data, group, warmup,
                                    timed)
    out["fuse_bn"] = dict(losses=losses, img_per_s=ips, step_ms=ms,
                          launches=counts)
    print(f"fuse-bn path: {ips:.1f} img/s, {ms:.2f} ms/step; launches "
          f"{counts}")
    need(counts["bn_bwd"] == 28 * steps and counts["fwd"] == 0
         and counts["act_bwd"] == 0,
         f"expected 28 launches of kernel 3 per step, got {counts}")
    hvd.shutdown()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from horovod_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {len(kernels.SOURCES)} kernels in {build_s:.1f} s")
    for name, log in kernels.ptxas_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    errs = check_kernels(dev)
    agg, detail = time_kernels(dev)
    torch.cuda.empty_cache()
    path = main_path()

    src = "horovod_tpu_torch/csrc/"
    meta = {"fwd": ("conv1x1_fwd_fused", src + "conv1x1_fwd.cu",
                    "horovod_tpu/ops/conv_block.py:192"),
            "act_bwd": ("conv1x1_bn_act_bwd_fused",
                        src + "conv1x1_bn_act_bwd.cu",
                        "horovod_tpu/ops/conv_block.py:323"),
            "bn_bwd": ("conv1x1_bn_bwd_fused", src + "conv1x1_bn_bwd.cu",
                       "horovod_tpu/ops/conv_bn_backward.py:186")}
    launches = dict(path["block"]["launches"])
    launches["bn_bwd"] = path["fuse_bn"]["launches"]["bn_bwd"]
    line = {"kernels": [
        {"name": meta[k][0], "route": "cuda", "source": meta[k][1],
         "replaces": meta[k][2], "launches": launches[k],
         "max_abs_err": errs[k], "ms": agg[k]["ms"],
         "plain_ms": agg[k]["plain_ms"], "bound_ms": agg[k]["bound_ms"],
         "bound_by": ("bytes" if agg[k]["bytes_ms"] >= agg[k]["flops_ms"]
                      else "operations"),
         "library_ms": agg[k]["library_ms"]} for k in meta]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/chip_smoke.json", "w") as f:
        json.dump({"build_s": build_s, "kernels": line["kernels"],
                   "sites": detail, "main_path": path, "nvidia_smi": smi},
                  f, indent=1)
    print(json.dumps(line))
    need(bool(smi), "nvidia-smi gave no card name and power limit")
    print(smi[0])  # as nvidia-smi gives them: "<name>, <power.limit>"
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
