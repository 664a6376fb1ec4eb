#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build  — nvcc builds the six CUDA kernels from
     horovod_tpu_torch/csrc/, one process per source, in parallel; what
     ptxas says of registers and spills, and the HGMMA (wgmma) and
     UTMALDG (TMA) instructions in each library's SASS, which all six
     must have (each has a Hopper instance);
  2. conv kernel checks — kernels 1–3 against their plain PyTorch
     versions on the card, in bf16 and in f32, at ResNet-50 site shapes
     (batch 32) plus ragged M (on the Hopper instances, and on the
     simple ones) and a C that is no multiple of 16, each line naming
     the instance that ran (`hopper` or `simple`); kernel 2's ReLU mask
     against the forward's z > 0 on an input built to sit on the
     boundary, with bf16 and with f32 y; two launches of each Hopper
     instance of kernels 1–3 at (6272, 1024, 512) giving bitwise-equal
     y, Σy, Σy², dx and dW, and two of kernel 6's at the LM's shape
     giving the same dq; then each kernel, its plain version and a
     PyTorch yardstick timed at every fused site shape of a ResNet-50
     step, in both types, beside the card's bound (device time from the
     profiler's trace, `device_ms`; the wall time of back-to-back calls
     beside it);
  3. flash kernel checks — kernels 4–6 against their plain versions at
     the LM's shape (B·H 192, S 1024, dh 128, causal, bf16), non-causal,
     a ragged S, dh 64, a non-causal chunk (Sq 512, Sk 1024) with an lse
     cotangent, f32, dh 32 with a ragged S, dh 80 (zero-padded to the
     128 instance), dh 200 (the 256 instance) in bf16 and f32, and dh
     320 and 512 (the wide path, padded to 512) in bf16 and f32, each
     line naming the instance that ran; then each timed (device time)
     at the LM's shape beside its bound, its plain version and
     scaled_dot_product_attention (kernel 6 has no PyTorch call of its
     own: kernels 5 + 6 are timed as a pair against SDPA's backward),
     and once more at dh 512 (B·H 16, S 1024: the wide path);
  4. ResNet main path — hvd.init(), ResNet-50 at full width (224², bf16,
     batch 32) with HOROVOD_CONV_BLOCK=1 (every site on the Hopper
     instances of kernels 1 and 2), broadcast_parameters,
     DistributedOptimizer(SGD momentum 0.9) with the bucketed NCCL
     all-reduce: 2 warm-up and 5 timed steps, the launch counters read
     around them; then one step from the same weights on the unfused
     route, whose loss must match; kernel 3 on its path, 7 steps with
     HOROVOD_FUSE_CONV_BN=1; one f32 step on the block route against one
     f32 unfused step from the same weights;
  5. LM main path — the transformer LM at the bench's flagship width
     (L12 D2048 F8192 H16 S1024 B12 V32768, bf16, Adam) through
     horovod_tpu_torch.transformer_lm with attn="flash": 2 warm-up and
     5 timed steps, 12 launches of each flash kernel per step, all on
     the Hopper instances (bf16, dh 128); then one
     step from the same weights with attn="local", whose loss must match;
  6. the launcher — `python -m horovod_tpu_torch.runner.launch
     --check-build` names the card and the six kernels built by phase 1;
     the launcher starts the synthetic benchmark (ResNet-50, 224², bf16,
     batch 32, HOROVOD_CONV_BLOCK=1) on one rank, which joins its NCCL
     world through the launcher's `tcp://` coordinator and prints its
     img/s; `runner.run` runs one step of the same model in a worker,
     whose loss must equal phase 4's first block-route loss (same seed-0
     weights, same batch) and whose kernels 1 and 2 launch 28 times
     each; `--scaling-report 1` starts both of its worlds through
     `runner.run` and prints the JSON line, and `--scaling-report 2` is
     refused on one card.
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
TF32_FLOPS_PER_S = 495e12    # dense tf32 tensor cores, same source

CHECK_SHAPES = [(100352, 64, 256), (25088, 512, 128), (6272, 1024, 256),
                (6272, 1024, 512), (6271, 256, 1024), (6271, 64, 200),
                (1001, 24, 50)]
REPEAT_SHAPE = (6272, 1024, 512)  # the Hopper instances' determinism check
# Tolerances, each relative to the reference's scale (bf16 keeps 8
# significant bits; both sides accumulate in f32 in different orders, so
# a rounded output may differ by one bf16 step, 2^-7 of the largest
# value; f32 outputs only by accumulation order):
TOL_BF16 = 2.0 ** -7        # y, dx: max|Δ| / max|ref|
TOL_SUMS = 1e-3             # Σy: max|Δ| / Σ|y| per channel; Σy²: relative
TOL_DW = 1e-3               # dW (f32): max|Δ| / max|ref|
TOL_LOSS = 2e-2             # fused vs unfused step loss, relative (bf16
                            # activations through 50 layers)
# f32 runs the conv kernels on tf32 (operands rounded to 11 significant
# bits, products summed in f32), the plain versions in full f32: the
# error of a K-term sum stays near 2^-11 of its typical term, well inside
# 2^-9 of the largest output. The f32 ResNet step carries that rounding
# through 50 layers of random weights.
TOL_TF32 = 2.0 ** -9        # f32 y, dx, dW: max|Δ| / max|ref|
TOL_LOSS_F32 = 1e-2         # f32 block vs unfused step loss, relative
# Flash kernels against their plain versions (full f32 scores), o, dk,
# dv and dq each held tile by tile: every 64-row tile (what one kernel
# block writes) must satisfy ‖Δ_tile‖ ≤ tol·‖ref_tile‖, so an error in
# any tile shows whatever the other tiles hold. In bf16 the kernels
# round p and ds to bf16 (8 significant bits, rms error ~2^-9.3 of a
# value) before the second product and the output to bf16 (the same
# again): ~2^-8.6 of a tile's norm, under 2^-7. In f32 every operand is
# rounded to tf32 (11 bits, rms ~2^-12.3), in the scores, p, dp and ds
# in turn: ~2^-11 of a tile's norm, under 2^-9.
TOL_FLASH = {"bfloat16": 2.0 ** -7, "float32": 2.0 ** -9}  # ‖Δ‖/‖ref‖ a tile
TILE = 64
TOL_LSE = 2e-3              # lse, absolute
TOL_DELTA = 2e-5            # delta = rowsum(do·o) − dlse, each row against
                            # Σ|do·o| + |dlse|: two f32 sums of ≤ 128 terms
                            # in different orders differ by at most
                            # 2·127·2^-24 ≈ 1.5e-5 of that
TOL_LM_LOSS = 1e-4          # flash vs local attention LM step loss,
                            # relative: ~9x the 1.1e-5 measured on an
                            # H100 (bf16 softmax in "local")
TOL_LAUNCHED_LOSS = 1e-3    # the launched worker's first ResNet loss vs
                            # phase 4's, relative: the same weights, batch
                            # and route, and kernels 1 and 2 repeat bit for
                            # bit, so only library choices that differ
                            # between two processes could move it; 1e-3 is
                            # a quarter of the fused vs unfused gap (4e-3)
SCALING_KEYS = ["model", "per_rank_batch", "ips_1chip", "ips_per_chip_at_n",
                "n", "scaling_efficiency"]  # examples/synthetic_benchmark.py


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


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device time of one fn() call: every kernel (and copy) that `iters`
    back-to-back calls run, summed from torch.profiler's trace of the
    card, over iters; the larger of two such windows, since a trace can
    come back with records missing (seen once in f32 on an H100). Unlike
    time_ms it leaves out the host's time between launches: a conv
    wrapper spends ~0.1 ms of Python and launches a call, longer than
    its kernels. Falls back to time_ms when the trace holds no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best_us = 0.0
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        best_us = max(best_us, sum(getattr(e, "device_time_total", 0.0)
                                   for e in prof.key_averages()))
    if best_us <= 0:
        return time_ms(fn, iters, warmup)
    return best_us / 1e3 / iters


def bound(kind: str, m: int, cin: int, c: int, e: int = 2):
    """(bound ms, bytes ms, flops ms) for elements of e bytes (2: bf16,
    4: f32 on tf32): each input read once, each output written once, over
    HBM; the products' flops over the type's tensor-core peak."""
    if kind == "fwd":
        nbytes = e * m * cin + e * cin * c + e * m * c + 2 * 4 * c
        flops = 2 * m * cin * c
    else:
        rows = 7 if kind == "act_bwd" else 5
        nbytes = (e * 2 * m * c + e * m * cin + e * cin * c + 4 * rows * c
                  + e * m * cin + 4 * cin * c)
        flops = 4 * m * cin * c
    peak = BF16_FLOPS_PER_S if e == 2 else TF32_FLOPS_PER_S
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(tb, tf), tb, tf


class Failed(Exception):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# ---------------------------------------------------------------- inputs

def site_inputs(m, cin, c, dev, seed, dtype=None):
    """Site inputs in `dtype` (default bf16) and the f32 rows both
    backward kernels take."""
    import torch
    from horovod_tpu_torch.ops import conv_block as cb
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = dtype or torch.bfloat16
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
        s["dz"], s["y"], s["x"], s["w"], s["scale"], s["mean"], s["inv"],
        s["db"], s["dg"])


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
    import torch
    f32 = ref[0].dtype == torch.float32
    tol_out = TOL_TF32 if f32 else TOL_BF16
    if name == "fwd":
        (y, s1, s2), (yr, s1r, s2r) = got, ref
        e = _err(y, yr)
        need(e <= tol_out * float(yr.float().abs().max()),
             f"kernel 1 y: max|Δ| {e}")
        scale = yr.float().abs().sum(0) + 1e-30
        rel = float(((s1 - s1r).abs() / scale).max())
        need(rel <= TOL_SUMS, f"kernel 1 sum: {rel} of Σ|y|")
        rel2 = float(((s2 - s2r).abs() / (s2r.abs() + 1e-30)).max())
        need(rel2 <= TOL_SUMS, f"kernel 1 sumsq: relative {rel2}")
        return max(e, _err(s1, s1r), _err(s2, s2r)), f"y {e:.3g}, Σy rel {rel:.3g}, Σy² rel {rel2:.3g}"
    (dx, dw), (dxr, dwr) = got, ref
    e1, e2 = _err(dx, dxr), _err(dw, dwr)
    need(e1 <= tol_out * float(dxr.float().abs().max()),
         f"{name} dx: max|Δ| {e1}")
    need(e2 <= (TOL_TF32 if f32 else TOL_DW) * float(dwr.abs().max()),
         f"{name} dW: max|Δ| {e2}")
    return max(e1, e2), (f"dx {e1:.3g} (max {float(dxr.float().abs().max()):.3g}),"
                         f" dW {e2:.3g} (max {float(dwr.abs().max()):.3g})")


def instance(m, cin, c, dtype, kernel="act_bwd") -> str:
    """The instance of kernel 1 ("fwd") or kernels 2 and 3 that runs this
    shape."""
    from horovod_tpu_torch.ops import conv_block as cb
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    pick = cb.fwd_instance if kernel == "fwd" else cbb.bwd_instance
    return pick(m, cin, c, dtype)


def check_kernels(dev, dtype):
    """Kernels 1–3 against their plain versions at CHECK_SHAPES in
    `dtype`, then the mask check; returns each kernel's largest max abs
    error."""
    import torch
    worst = {"fwd": 0.0, "act_bwd": 0.0, "bn_bwd": 0.0}
    tag = str(dtype).replace("torch.", "")
    for i, (m, cin, c) in enumerate(CHECK_SHAPES):
        s = site_inputs(m, cin, c, dev, seed=i, dtype=dtype)
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
            print(f"check {name:8s} {tag} M={m:6d} Cin={cin:4d} C={c:4d}"
                  f" [{instance(m, cin, c, dtype, name)}]: {msg}")
        del s
    mask_check(dev, dtype)
    return worst


def mask_check(dev, dtype, m=25088, c=256):
    """Kernel 2's ReLU mask equals the forward's z > 0, read out through
    the kernel itself: with w = I, dz = 1, g = 1 and a = b = 0 the
    kernel's dy is its mask and dx = dy @ wᵀ returns it. y takes few
    distinct values and each channel's bias cancels one of them exactly,
    so many pre-activations are exactly 0 (the mask must say 0 there)."""
    import torch
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    g = torch.Generator(device=dev).manual_seed(99)
    y = (torch.round(torch.randn((m, c), generator=g, device=dev) * 4) / 4
         ).to(dtype)
    yf = y.float()
    mean = yf.mean(0)
    inv = torch.rsqrt(yf.square().mean(0) - mean.square() + 1e-5)
    scale = (1 + 0.3 * torch.randn((c,), generator=g, device=dev)).to(
        torch.bfloat16).float()
    bias = -(((yf[0] - mean) * inv) * scale)   # row 0's value sits at 0
    zf = ((yf - mean) * inv) * scale + bias     # the forward's f32 chain
    fwd_mask = zf > 0
    on_boundary = int((zf == 0).sum())
    eye = torch.eye(c, device=dev, dtype=dtype)
    ones = torch.ones((m, c), device=dev, dtype=dtype)
    one, zero = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    dx, _ = cbb.launch_bwd("conv1x1_bn_act_bwd", "hvd_conv1x1_bn_act_bwd",
                           ones, y, ones, eye,
                           [t.contiguous() for t in
                            (one, mean, inv, zero, zero, scale, bias)])
    torch.cuda.synchronize()
    kmask = dx != 0
    equal = int((kmask == fwd_mask).sum())
    print(f"check mask ({dtype}) [{instance(m, c, c, dtype)}]: "
          f"{equal}/{m * c} equal to the forward's z > 0; "
          f"{on_boundary} pre-activations exactly on the boundary")
    need(on_boundary >= m, "mask check: too few boundary values")
    need(equal == m * c, f"kernel 2 mask differs at {m * c - equal} places")
    return equal, m * c, on_boundary


def repeat_check(dev, shape=REPEAT_SHAPE, flash_shape=(192, 1024, 128)):
    """Two launches of each Hopper instance (kernels 1, 2 and 3 at
    `shape`, kernel 6 at the LM's per-layer shape; bf16) on the same
    inputs give bitwise-equal outputs: every sum runs in a fixed
    order."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    m, cin, c = shape
    s = site_inputs(m, cin, c, dev, seed=7)
    out = {}
    for name, run in (("fwd", run_k1), ("act_bwd", run_k2),
                      ("bn_bwd", run_k3)):
        need(instance(m, cin, c, torch.bfloat16, name) == "hopper",
             f"{shape} does not take kernel {name}'s Hopper instance")
        a, b = run(s), run(s)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(u, v)) for u, v in zip(a, b))
        out[name] = same
        print(f"check repeat {name} bf16 M={m} Cin={cin} C={c} [hopper]: "
              f"two launches bitwise equal: {same}")
        need(same, f"{name}: two launches of the Hopper instance differ")
    del s
    bh, sq, dh = flash_shape
    need(fa.flash_instance(torch.bfloat16, dh) == "hopper",
         "the LM's head dim does not take kernel 6's Hopper instance")
    x = flash_inputs(bh, sq, sq, dh, True, "bfloat16", False, dev, 9)
    q, k, v, do, sc = x["q"], x["k"], x["v"], x["do"], x["scale"]
    o, lse = fa.flash_fwd(q, k, v, True, sc)
    _, _, delta = fa.flash_bwd_dkdv(q, k, v, o, do, lse, None, True, sc)
    a = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, sc)
    b = fa.flash_bwd_dq(q, k, v, do, lse, delta, True, sc)
    torch.cuda.synchronize()
    out["attn_dq"] = bool(torch.equal(a, b))
    print(f"check repeat attn_dq bf16 BH={bh} S={sq} dh={dh} causal "
          f"[hopper]: two launches bitwise equal: {out['attn_dq']}")
    need(out["attn_dq"], "attn_dq: two launches of the Hopper instance "
         "differ")
    return out


def time_kernels(dev, dtype):
    """Per-step times over the 28 fused sites of a ResNet-50 step at batch
    32 in `dtype`: kernel, plain version, PyTorch yardstick (device time,
    device_ms) and bound, each summed over the sites (site shape × its
    count); and the wall time of back-to-back wrapper calls (time_ms),
    which the host's time a call sets once the kernels are faster."""
    import torch
    from horovod_tpu_torch.models import resnet
    sites = resnet.fused_sites(50, 32, 224)
    shapes = {}
    for _, _, m, cin, c in sites:
        shapes[(m, cin, c)] = shapes.get((m, cin, c), 0) + 1
    agg = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, flops_ms=0.0, wall_ms=0.0)
           for k in ("fwd", "act_bwd", "bn_bwd")}
    detail = []
    for i, ((m, cin, c), count) in enumerate(sorted(shapes.items())):
        s = site_inputs(m, cin, c, dev, seed=100 + i, dtype=dtype)
        dy2 = (s["rows2"][0] * s["dz"].float() - s["rows2"][3]
               - s["rows2"][4] * (s["y"].float() - s["mean"]) * s["inv"]
               ).to(dtype)
        for name, run, plain, lib in (
                ("fwd", run_k1, plain_k1, library_fwd),
                ("act_bwd", run_k2, plain_k2, lambda s: library_bwd(s, dy2)),
                ("bn_bwd", run_k3, plain_k3,
                 lambda s: library_bwd(s, dy2))):
            t = {"ms": device_ms(lambda: run(s)),
                 "plain_ms": device_ms(lambda: plain(s), iters=5),
                 "library_ms": device_ms(lambda: lib(s)),
                 "wall_ms": time_ms(lambda: run(s))}
            b, tb, tf = bound(name, m, cin, c, dtype.itemsize)
            t.update(bound_ms=b, bytes_ms=tb, flops_ms=tf)
            for key, v in t.items():
                agg[name][key] += v * count
            detail.append(dict(kernel=name, dtype=str(dtype), M=m, Cin=cin,
                               C=c, count=count,
                               instance=instance(m, cin, c, dtype, name),
                               **t))
            print(f"time {name:8s} {dtype.itemsize * 8}b M={m:6d} "
                  f"Cin={cin:4d} C={c:4d} x{count} "
                  f"[{instance(m, cin, c, dtype, name)}]: "
                  f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, "
                  f"library {t['library_ms']:.4f}, bound {b:.4f} "
                  f"({'bytes' if tb >= tf else 'operations'}); "
                  f"wall of back-to-back calls {t['wall_ms']:.4f}")
        del s, dy2
    return agg, detail


# ---------------------------------------------------------------- flash

# (label, B·H, Sq, Sk, dh, causal, dtype, with an lse cotangent)
FLASH_CHECKS = [
    ("LM shape", 192, 1024, 1024, 128, True, "bfloat16", False),
    ("non-causal", 48, 1024, 1024, 128, False, "bfloat16", False),
    ("ragged S", 48, 1000, 1000, 128, True, "bfloat16", False),
    ("dh 64", 48, 1024, 1024, 64, True, "bfloat16", False),
    ("chunk + dlse", 48, 512, 1024, 128, False, "bfloat16", True),
    ("f32", 48, 1024, 1024, 128, True, "float32", False),
    ("f32 chunk dh 32 + dlse", 48, 500, 1000, 32, False, "float32", True),
    ("bf16 dh 32 ragged", 48, 1000, 1000, 32, True, "bfloat16", False),
    ("dh 80 padded", 48, 1024, 1024, 80, True, "bfloat16", False),
    ("dh 200 (256 instance)", 48, 1024, 1024, 200, True, "bfloat16", False),
    ("f32 dh 200 + dlse", 8, 512, 512, 200, True, "float32", True),
    ("dh 320 (wide, 512)", 16, 1024, 1024, 320, True, "bfloat16", False),
    ("dh 512 (wide)", 16, 1024, 1024, 512, False, "bfloat16", False),
    ("f32 dh 320 + dlse", 8, 512, 512, 320, True, "float32", True),
]


def flash_inputs(bh, sq, sk, dh, causal, dtype, with_dlse, dev, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(n):
        return torch.randn((bh, n, dh), generator=g, device=dev).to(dt)

    dlse = (0.1 * torch.randn((bh, sq), generator=g, device=dev)
            if with_dlse else None)
    return dict(q=rnd(sq), k=rnd(sk), v=rnd(sk), do=rnd(sq), dlse=dlse,
                causal=causal, scale=dh ** -0.5)


def run_flash(x):
    """Kernels 4, 5, 6 in turn; returns (o, lse, dk, dv, delta, dq)."""
    from horovod_tpu_torch.ops import flash_attention as fa
    c, sc = x["causal"], x["scale"]
    o, lse = fa.flash_fwd(x["q"], x["k"], x["v"], c, sc)
    dk, dv, delta = fa.flash_bwd_dkdv(x["q"], x["k"], x["v"], o, x["do"],
                                      lse, x["dlse"], c, sc)
    dq = fa.flash_bwd_dq(x["q"], x["k"], x["v"], x["do"], lse, delta, c, sc)
    return o, lse, dk, dv, delta, dq


def tile_ratio(a, r, tile=TILE) -> float:
    """max over 64-row tiles (along dim 1 of (BH, S, dh)) of
    ‖a − r‖ / ‖r‖ in the tile."""
    import torch.nn.functional as F
    d2 = (a.float() - r.float()).square().sum(-1)
    r2 = r.float().square().sum(-1)
    pad = -d2.shape[1] % tile
    d2, r2 = (F.pad(t, (0, pad)).reshape(t.shape[0], -1, tile).sum(-1)
              for t in (d2, r2))
    return float((d2 / r2.clamp_min(1e-30)).sqrt().max())


def delta_ratio(delta, delta_r, o, do, dlse) -> float:
    """max over rows of |Δdelta| / (Σ|do·o| + |dlse|)."""
    size = (do.float() * o.float()).abs().sum(-1)
    if dlse is not None:
        size = size + dlse.abs()
    return float(((delta - delta_r).abs() / size.clamp_min(1e-30)).max())


def check_flash(dev):
    """Kernels 4–6 against their plain versions at FLASH_CHECKS, each
    plain version fed what its kernel was fed (the backward ones the
    kernels' o, lse and delta). Returns each kernel's largest max abs
    error and the per-check records (max abs error and worst tile ratio
    of each output)."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    worst = {"attn_fwd": 0.0, "attn_dkdv": 0.0, "attn_dq": 0.0}
    records = []
    for i, (label, bh, sq, sk, dh, causal, dtype, wd) in enumerate(
            FLASH_CHECKS):
        x = flash_inputs(bh, sq, sk, dh, causal, dtype, wd, dev, 200 + i)
        got = run_flash(x)
        torch.cuda.synchronize()
        for t in got:
            need(bool(torch.isfinite(t.float()).all()),
                 f"flash {label}: non-finite output")
        o, lse, dk, dv, delta, dq = got
        q, k, v, do, c, sc = (x[n] for n in ("q", "k", "v", "do", "causal",
                                             "scale"))
        o_r, lse_r = fa._fwd_plain(q, k, v, c, sc)
        dk_r, dv_r, delta_r = fa._bwd_dkdv_plain(q, k, v, o, do, lse,
                                                 x["dlse"], c, sc)
        dq_r = fa._bwd_dq_plain(q, k, v, do, lse, delta, c, sc)
        tol = TOL_FLASH[dtype]
        rec = {"check": label, "BH": bh, "Sq": sq, "Sk": sk, "dh": dh,
               "causal": causal, "dtype": dtype, "dlse": wd}
        for name, a, r in (("o", o, o_r), ("dk", dk, dk_r), ("dv", dv, dv_r),
                           ("dq", dq, dq_r)):
            rec[name] = _err(a, r)
            rec[name + "_tile"] = tile_ratio(a, r)
            need(rec[name + "_tile"] <= tol,
                 f"flash {label} {name}: a tile's ‖Δ‖/‖ref‖ is "
                 f"{rec[name + '_tile']} (tolerance {tol})")
        rec["delta"] = _err(delta, delta_r)
        rec["delta_tile"] = delta_ratio(delta, delta_r, o, do, x["dlse"])
        need(rec["delta_tile"] <= TOL_DELTA,
             f"flash {label} delta: {rec['delta_tile']} of Σ|do·o| + |dlse|")
        rec["lse"] = _err(lse, lse_r)
        need(rec["lse"] <= TOL_LSE, f"flash {label} lse: {rec['lse']}")
        worst["attn_fwd"] = max(worst["attn_fwd"], rec["o"], rec["lse"])
        worst["attn_dkdv"] = max(worst["attn_dkdv"], rec["dk"], rec["dv"],
                                 rec["delta"])
        worst["attn_dq"] = max(worst["attn_dq"], rec["dq"])
        records.append(rec)
        rec["instance"] = fa.flash_instance(getattr(torch, dtype), dh)
        print(f"check flash {label:22s} {dtype} BH={bh} Sq={sq} Sk={sk} "
              f"dh={dh} [{rec['instance']}]: max|Δ| (worst tile ratio) "
              + ", ".join(
                  f"{n} {rec[n]:.3g}" + (f" ({rec[n + '_tile']:.3g})"
                                         if n != "lse" else "")
                  for n in ("o", "lse", "dk", "dv", "dq", "delta")))
        del x, got
    return worst, records


def flash_bound(kind, bh, sq, sk, dh, causal, e):
    """(bound ms, bytes ms, flops ms) of one flash kernel launch: each
    input read once and each output written once over HBM; the products
    over the unmasked (query, key) pairs this causal flag leaves, over the
    type's tensor-core peak (e bytes an element)."""
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    qs, ks, rows = bh * sq * dh, bh * sk * dh, bh * sq
    if kind == "attn_fwd":      # q, k, v -> o, lse
        nbytes, flops = e * (2 * qs + 2 * ks) + 4 * rows, 4 * pairs * dh
    elif kind == "attn_dkdv":   # q, k, v, o, do, lse -> dk, dv, delta
        nbytes = e * (3 * qs + 4 * ks) + 4 * 2 * rows
        flops = 8 * pairs * dh + 2 * sq * dh
    else:                       # q, k, v, do, lse, delta -> dq
        nbytes, flops = e * (3 * qs + 2 * ks) + 4 * 2 * rows, 6 * pairs * dh
    peak = BF16_FLOPS_PER_S if e == 2 else TF32_FLOPS_PER_S
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops * bh / peak * 1e3
    return max(tb, tf), tb, tf


def time_flash(dev, bh=192, s=1024, dh=128, heads=16):
    """Kernels 4–6, their plain versions and
    torch.nn.functional.scaled_dot_product_attention (forward for kernel
    4; its autograd backward, which makes dq, dk and dv in one call, on
    kernel 5's line) at the LM's per-layer shape, causal, bf16. No
    PyTorch call computes dq alone, so kernels 5 + 6 are also timed as
    the pair ("attn_bwd") that SDPA's backward computes."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa
    x = flash_inputs(bh, s, s, dh, True, "bfloat16", False, dev, 300)
    q, k, v, do, sc = x["q"], x["k"], x["v"], x["do"], x["scale"]
    o, lse = fa.flash_fwd(q, k, v, True, sc)
    _, _, delta = fa.flash_bwd_dkdv(q, k, v, o, do, lse, None, True, sc)
    four = [t.reshape(bh // heads, heads, s, dh) for t in (q, k, v, do)]
    leaves = [t.detach().requires_grad_(True) for t in four[:3]]
    o_lib = F.scaled_dot_product_attention(*leaves, is_causal=True)
    runs = {
        "attn_fwd": (lambda: fa.flash_fwd(q, k, v, True, sc),
                     lambda: fa._fwd_plain(q, k, v, True, sc),
                     lambda: F.scaled_dot_product_attention(
                         *four[:3], is_causal=True)),
        "attn_dkdv": (lambda: fa.flash_bwd_dkdv(q, k, v, o, do, lse, None,
                                                True, sc),
                      lambda: fa._bwd_dkdv_plain(q, k, v, o, do, lse, None,
                                                 True, sc),
                      lambda: torch.autograd.grad(o_lib, leaves, four[3],
                                                  retain_graph=True)),
        "attn_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True,
                                            sc),
                    lambda: fa._bwd_dq_plain(q, k, v, do, lse, delta, True,
                                             sc),
                    None)}
    out = {}
    for name, (run, plain, lib) in runs.items():
        b, tb, tf = flash_bound(name, bh, s, s, dh, True, 2)
        t = {"ms": device_ms(run), "plain_ms": device_ms(plain, iters=3),
             "library_ms": device_ms(lib) if lib else None,
             "bound_ms": b, "bytes_ms": tb, "flops_ms": tf}
        out[name] = t
        lib_s = ("n/a (in kernel 5's line)" if lib is None
                 else f"{t['library_ms']:.4f}")
        print(f"time {name:9s} BH={bh} S={s} dh={dh} causal bf16 "
              f"[{fa.flash_instance(torch.bfloat16, dh)}]: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, library "
              f"{lib_s}, bound {b:.4f} "
              f"({'bytes' if tb >= tf else 'operations'})")
    pair = {"ms": device_ms(lambda: (runs["attn_dkdv"][0](),
                                     runs["attn_dq"][0]())),
            "library_ms": out["attn_dkdv"]["library_ms"],
            "bound_ms": sum(flash_bound(k, bh, s, s, dh, True, 2)[0]
                            for k in ("attn_dkdv", "attn_dq"))}
    print(f"time attn_bwd  BH={bh} S={s} dh={dh} causal bf16: kernels 5 + 6 "
          f"{pair['ms']:.4f} ms, SDPA backward {pair['library_ms']:.4f} "
          f"({pair['ms'] / pair['library_ms']:.2f}x), bound "
          f"{pair['bound_ms']:.4f}")
    out["attn_bwd_pair"] = pair
    return out


def sass_counts():
    """Per library, the HGMMA (wgmma) and UTMALDG (TMA load) instructions
    in its SASS, read with the toolkit's cuobjdump: all six kernels must
    have both. None where the toolkit has no cuobjdump."""
    from horovod_tpu_torch import kernels
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("sass: the toolkit has no cuobjdump; HGMMA/UTMALDG not counted")
        return None
    out = {}
    for name in kernels.SOURCES:
        sass = subprocess.run([tool, "-sass", kernels._target(name)],
                              capture_output=True, text=True,
                              timeout=120).stdout
        out[name] = {op: sum(f" {op}." in line or f" {op} " in line
                             for line in sass.splitlines())
                     for op in ("HGMMA", "UTMALDG")}
        print(f"sass {name}: {out[name]['HGMMA']} HGMMA, "
              f"{out[name]['UTMALDG']} UTMALDG")
    for name in kernels.SOURCES:
        need(out[name]["HGMMA"] > 0 and out[name]["UTMALDG"] > 0,
             f"{name}: no wgmma or TMA load in its SASS")
    return out


# ---------------------------------------------------------------- main path

def _wrappers():
    from horovod_tpu_torch.ops import conv_block as cb
    from horovod_tpu_torch.ops import conv_bn_backward as cbb
    from horovod_tpu_torch.ops import flash_attention as fa
    return {"fwd": cb.conv1x1_fwd_fused,
            "act_bwd": cb.conv1x1_bn_act_bwd_fused,
            "bn_bwd": cbb.conv1x1_bn_bwd_fused,
            "attn_fwd": fa.flash_fwd, "attn_dkdv": fa.flash_bwd_dkdv,
            "attn_dq": fa.flash_bwd_dq}


def reset_counters():
    for f in _wrappers().values():
        f.launches = 0


def read_counters():
    return {k: f.launches for k, f in _wrappers().items()}


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
    """The port's ResNet training path at full width; each route driven
    with the counters read around it."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb

    from horovod_tpu_torch.models import resnet
    os.environ["HOROVOD_CONV_BLOCK"] = "1"
    os.environ["HOROVOD_FUSE_CONV_BN"] = "0"
    sites = resnet.fused_sites(depth, batch, image)
    for kernel in ("fwd", "act_bwd"):
        insts = {instance(m, cin, c, torch.bfloat16, kernel)
                 for _, _, m, cin, c in sites}
        need(insts == {"hopper"}, f"kernel {kernel}: the ResNet-{depth} "
             f"sites take {insts}, not only the Hopper instance")
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
    need(counts["bn_bwd"] == 0 and counts["attn_fwd"] == 0,
         "kernel 3 or a flash kernel ran on the block route")

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
    return out


def resnet_f32_check(batch=32, image=224, depth=50):
    """One f32 ResNet step on the block route (kernels 1 and 2 on tf32)
    and one on the unfused route, from the same weights: the losses must
    agree within TOL_LOSS_F32."""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import synthetic_benchmark as sb

    os.environ["HOROVOD_FUSE_CONV_BN"] = "0"
    dev, group = hvd.device(), dist.group.WORLD
    model = sb.build(f"resnet{depth}", torch.float32, dev)
    opt = sb.make_optimizer(model)
    data = sb.make_batch(batch, image, torch.float32, dev, seed=hvd.rank())
    snap_m = copy.deepcopy(model.state_dict())
    snap_o = copy.deepcopy(opt.state_dict())
    out = {}
    for route, flag in (("block", "1"), ("unfused", "0")):
        os.environ["HOROVOD_CONV_BLOCK"] = flag
        model.load_state_dict(snap_m)
        opt.load_state_dict(snap_o)
        reset_counters()
        out[route] = sb.train_step(model, opt, data, group).item()
        out[route + "_launches"] = read_counters()
    rel = abs(out["block"] - out["unfused"]) / max(abs(out["unfused"]),
                                                    1e-6)
    out["loss_rel"] = rel
    print(f"f32 route check: block loss {out['block']:.6f} (launches "
          f"{out['block_launches']}), unfused {out['unfused']:.6f}, "
          f"relative difference {rel:.3g} (tolerance {TOL_LOSS_F32})")
    need(math.isfinite(out["block"]), "non-finite f32 loss")
    need(out["block_launches"]["fwd"] == 28
         and out["block_launches"]["act_bwd"] == 28,
         "f32 block route: expected 28 + 28 launches")
    need(sum(out["unfused_launches"].values()) == 0,
         "the unfused route ran a kernel")
    need(rel <= TOL_LOSS_F32, "f32 block and unfused losses disagree")
    return out


def lm_path(warmup=2, timed=5):
    """The transformer LM at the bench's flagship width and batch
    (transformer_lm.FLAGSHIP) through transformer_lm's build/train_step,
    attn="flash", the counters read around 2 warm-up + 5 timed steps;
    then one step from the same weights with attn="local"."""
    import dataclasses
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import transformer_lm as lm
    from horovod_tpu_torch.models import transformer as tfm

    from horovod_tpu_torch.ops import flash_attention as fa
    cfg = tfm.TransformerConfig(**lm.FLAGSHIP, attn="flash",
                                dtype=torch.bfloat16)
    batch, seq = lm.FLAGSHIP_BATCH, cfg.max_seq
    dh = cfg.d_model // cfg.n_heads
    need(fa.flash_instance(torch.bfloat16, dh) == "hopper",
         f"the LM's head dim {dh} does not take the flash kernels' Hopper "
         f"instances")
    dev = hvd.device()
    model, opt = lm.build(cfg, dev)
    data = lm.make_batch(batch, seq, cfg.vocab, dev, seed=hvd.rank())
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    losses = [lm.train_step(model, opt, data) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [lm.train_step(model, opt, data) for _ in range(timed)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    counts = read_counters()
    losses = [float(v) for v in losses]
    steps = warmup + timed
    r = lm.report(cfg, batch, seq, dt, torch.cuda.get_device_name(dev))
    out = dict(losses=losses, launches=counts, buckets=len(opt.plan),
               per_step={k: v / steps for k, v in counts.items()},
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, **r)
    print(f"LM path: L{cfg.n_layers} D{cfg.d_model} F{cfg.d_ff} "
          f"H{cfg.n_heads} S{seq} B{batch} V{cfg.vocab} bf16, "
          f"{hvd.size()} rank(s), {out['buckets']} buckets; losses "
          f"{[round(v, 5) for v in losses]}")
    print(f"LM path: {r['tokens_per_s']:.1f} tokens/s, {r['step_ms']:.2f} "
          f"ms/step, model-FLOPs share of peak {r['mfu']:.4f}, peak memory "
          f"{out['peak_mem_gb']:.1f} GB; launches per step "
          f"{out['per_step']}")
    need(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    n = cfg.n_layers * steps
    need(counts["attn_fwd"] == n and counts["attn_dkdv"] == n
         and counts["attn_dq"] == n,
         f"expected {cfg.n_layers} launches of kernels 4, 5, 6 per step, "
         f"got {counts}")

    snap_m = copy.deepcopy(model.state_dict())
    snap_o = copy.deepcopy(opt.state_dict())
    loss_f = lm.train_step(model, opt, data).item()
    model.load_state_dict(snap_m)
    opt.load_state_dict(snap_o)
    del snap_m, snap_o
    model.cfg = dataclasses.replace(cfg, attn="local")
    reset_counters()
    loss_l = lm.train_step(model, opt, data).item()
    counts_l = read_counters()
    rel = abs(loss_f - loss_l) / max(abs(loss_l), 1e-6)
    out.update(loss_flash=loss_f, loss_local=loss_l, loss_rel=rel,
               launches_local=counts_l)
    print(f"LM attention check: flash loss {loss_f:.6f}, local "
          f"{loss_l:.6f}, relative difference {rel:.3g} (tolerance "
          f"{TOL_LM_LOSS})")
    need(sum(counts_l.values()) == 0, "the local-attention step ran a kernel")
    need(rel <= TOL_LM_LOSS, "flash and local LM losses disagree")
    return out


def run_bounded(cmd, timeout, env=None):
    """Run `cmd` from the repo root in its own session; returns (exit
    code, stdout + stderr). Past `timeout` it gets SIGTERM (the launcher
    and the scaling report then terminate their workers' process
    groups), then its group SIGKILL, and the phase fails."""
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
        raise Failed(f"{' '.join(cmd)}: still running after {timeout} s")
    return proc.returncode, out


def launched_path(block_loss: float, phase4_ms: float):
    """Phase 6: the launcher, `runner.run` and the scaling report drive
    the ResNet-50 main path on the card in worker processes."""
    import torch
    from horovod_tpu_torch import kernels, runner
    from horovod_tpu_torch import synthetic_benchmark as sb
    py = sys.executable
    card = torch.cuda.get_device_name(0)
    block_env = {"HOROVOD_CONV_BLOCK": "1", "HOROVOD_FUSE_CONV_BN": "0"}
    out = {"seconds": {}}
    t_last = [time.perf_counter()]

    def took(step):
        """Wall seconds since the last step of this phase ended."""
        now = time.perf_counter()
        out["seconds"][step] = now - t_last[0]
        t_last[0] = now
        return out["seconds"][step]

    rc, text = run_bounded([py, "-m", "horovod_tpu_torch.runner.launch",
                            "--check-build"], 120)
    print("\n".join("check-build: " + ln for ln in text.splitlines()
                    if ln.strip()))
    need(rc == 0, f"--check-build exited {rc}")
    need(card in text, "--check-build does not name the card")
    for name in kernels.SOURCES:
        need(f"[X] {name} built" in text,
             f"--check-build does not show kernel {name} built")
    print(f"check-build: {took('check_build'):.1f} s")

    log_dir = os.path.join("chiprun_out", "launch")
    rc, text = run_bounded(
        [py, "-m", "horovod_tpu_torch.runner.launch", "-np", "1",
         "--output-filename", log_dir, py, "-m",
         "horovod_tpu_torch.synthetic_benchmark", "--batch-size", "32",
         "--num-iters", "2"], 600, env=dict(os.environ, **block_env))
    print("\n".join("launch: " + ln for ln in text.splitlines()
                    if "<stdout>:" in ln or "horovodrun" in ln))
    need(rc == 0, f"the launched benchmark exited {rc}")
    lines = [ln for ln in text.splitlines() if ln.startswith("[0]<stdout>: ")]
    need(any("Model: resnet50" in ln and card in ln for ln in lines),
         "the launched worker does not name the card")
    world = [ln for ln in lines if "World: 1 rank(s) joined over tcp://"
             in ln and "(nccl)" in ln]
    need(bool(world), "the launched worker did not join NCCL over the "
         "launcher's tcp:// coordinator")
    rate = [float(ln.rsplit(":", 1)[1]) for ln in lines
            if "Img/sec per rank:" in ln]
    need(len(rate) == 1 and rate[0] > 0, "no Img/sec per rank figure")
    out["launched"] = dict(img_per_s=rate[0], step_ms=32e3 / rate[0],
                           world=world[0], log_dir=log_dir)
    print(f"launched path: {rate[0]:.1f} img/s per rank, "
          f"{32e3 / rate[0]:.2f} ms/step (phase 4 in-process: "
          f"{phase4_ms:.2f} ms/step); {took('launch'):.1f} s")

    res = runner.run(sb.first_step, np=1, extra_env=block_env,
                     timeout=600)[0]
    rel = abs(res["loss"] - block_loss) / max(abs(block_loss), 1e-6)
    out["run"] = dict(res, loss_phase4=block_loss, loss_rel=rel)
    print(f"runner.run: first loss {res['loss']:.6f} on {res['device']} "
          f"over {res['rendezvous']}, phase 4's {block_loss:.6f}, relative "
          f"difference {rel:.3g} (tolerance {TOL_LAUNCHED_LOSS}); launches "
          f"{res['launches']}; {took('run'):.1f} s")
    need(res["device"] == card, "runner.run's worker ran elsewhere")
    need(res["launches"] == {"fwd": 28, "act_bwd": 28},
         f"runner.run's step: expected 28 + 28 launches, got "
         f"{res['launches']}")
    need(rel <= TOL_LAUNCHED_LOSS, "the launched and in-process losses "
         "disagree")

    report_cmd = [py, "-m", "horovod_tpu_torch.synthetic_benchmark",
                  "--batch-size", "32", "--num-warmup-batches", "2",
                  "--num-iters", "2", "--scaling-report"]
    rc, text = run_bounded(report_cmd + ["1"], 600,
                           env=dict(os.environ, **block_env))
    print("\n".join("scaling: " + ln for ln in text.splitlines()
                    if "<stdout>:" in ln or ln.startswith("{")))
    need(rc == 0, f"--scaling-report 1 exited {rc}")
    worlds = [ln for ln in text.splitlines() if "<stdout>: Model:" in ln]
    need(len(worlds) == 2 and all(card in ln for ln in worlds),
         "--scaling-report 1: both worlds must run on the card")
    report = json.loads(text.strip().splitlines()[-1])
    need(list(report) == SCALING_KEYS and report["n"] == 1
         and report["ips_1chip"] > 0, f"--scaling-report 1: {report}")
    out["scaling_report_1"] = report
    print(f"scaling: --scaling-report 1 {took('scaling_report_1'):.1f} s")
    rc, text = run_bounded(report_cmd + ["2"], 120)
    refusal = "--scaling-report 2 needs 2 GPUs, have 1 visible"
    print(f"scaling: --scaling-report 2 exited {rc}: {text.strip()} "
          f"({took('scaling_report_2'):.1f} s)")
    need(rc != 0 and refusal in text, "--scaling-report 2 was not refused "
         "on one card")
    out["scaling_report_2"] = dict(rc=rc, message=text.strip())
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_s = {}

    def lap(name):
        """Wall seconds of the phase that just ended."""
        phase_s[name] = time.perf_counter() - t0 - sum(phase_s.values())
        print(f"phase {name}: {phase_s[name]:.1f} s")

    kernels.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {len(kernels.SOURCES)} kernels in {build_s:.1f} s")
    for name, log in kernels.ptxas_log.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma",
                                       "setmaxnreg", "Performance",
                                       "Compiling entry")):
                print(f"ptxas {name}: {line.strip()}")
    sass = sass_counts()
    lap("1 build")

    errs = check_kernels(dev, torch.bfloat16)  # the main path's type
    errs32 = check_kernels(dev, torch.float32)
    repeat = repeat_check(dev)
    ferrs, flash_checks = check_flash(dev)
    errs.update(ferrs)
    agg, detail = time_kernels(dev, torch.bfloat16)
    agg32, detail32 = time_kernels(dev, torch.float32)
    for tag, a in (("bf16", agg), ("f32", agg32)):
        for k, t in a.items():
            print(f"time {k} {tag} per ResNet-50 step: kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, library "
                  f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f}")
    agg.update(time_flash(dev))
    wide = time_flash(dev, bh=16, s=1024, dh=512, heads=16)  # the wide path
    torch.cuda.empty_cache()
    lap("2-3 kernel checks and times")

    hvd.init()
    path = main_path()
    torch.cuda.empty_cache()
    path["f32"] = resnet_f32_check()
    torch.cuda.empty_cache()
    lap("4 ResNet main path")
    lm = lm_path()
    hvd.shutdown()
    torch.cuda.empty_cache()
    lap("5 LM main path")
    launched = launched_path(path["block"]["losses"][0],
                             path["block"]["step_ms"])
    lap("6 launcher")
    print(f"total: {time.perf_counter() - t0:.1f} s")

    src = "horovod_tpu_torch/csrc/"
    fa = "horovod_tpu/ops/flash_attention.py"
    meta = {"fwd": ("conv1x1_fwd_fused", src + "conv1x1_fwd.cu",
                    "horovod_tpu/ops/conv_block.py:192"),
            "act_bwd": ("conv1x1_bn_act_bwd_fused",
                        src + "conv1x1_bn_act_bwd.cu",
                        "horovod_tpu/ops/conv_block.py:323"),
            "bn_bwd": ("conv1x1_bn_bwd_fused", src + "conv1x1_bn_bwd.cu",
                       "horovod_tpu/ops/conv_bn_backward.py:186"),
            "attn_fwd": ("flash_fwd", src + "flash_fwd.cu", fa + ":105"),
            "attn_dkdv": ("flash_bwd_dkdv", src + "flash_bwd_dkdv.cu",
                          fa + ":274"),
            "attn_dq": ("flash_bwd_dq", src + "flash_bwd_dq.cu",
                        fa + ":303")}
    launches = dict(path["block"]["launches"])
    launches["bn_bwd"] = path["fuse_bn"]["launches"]["bn_bwd"]
    for k in ("attn_fwd", "attn_dkdv", "attn_dq"):
        launches[k] = lm["launches"][k]
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
        json.dump({"build_s": build_s, "sass": sass, "repeat": repeat,
                   "flash_wide_dh512": wide,
                   "attn_bwd_pair": agg["attn_bwd_pair"],
                   "kernels": line["kernels"],
                   "sites": detail + detail32, "conv_f32": agg32,
                   "conv_f32_max_abs_err": errs32,
                   "flash_checks": flash_checks, "main_path": path,
                   "lm_path": lm, "launched_path": launched,
                   "phase_s": phase_s,
                   "nvidia_smi": smi}, f, indent=1)
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
