"""Remat-policy A/B for the flagship transformer LM on one GPU, PyTorch
twin of scripts/remat_ab.py.

    python -m horovod_tpu_torch.remat_ab [--rounds 3] [--steps 10]

The policies: none (remat off), "dots" (torch.utils.checkpoint with the
selective-checkpoint contexts: the matmul outputs saved, the rest
recomputed) and "full" (nothing saved). Each round runs each policy in a
fresh process, the order reversed every other round. A run builds the
LM (L12 D2048 F8192 H16 S1024 B12 V32768, bf16, Adam, attn="flash")
through transformer_lm.build and times its step with
profile_step.profile_route: the wall ms/step of `--steps` untraced steps
after 3 warm-up steps, then the device's busy ms a step over as many
traced ones (the union of kernel intervals), and the peak memory. It
then does the same at a narrow width (D 256, F 1024, H 2: the same
layers, ops and flash instance at dh 128, ~1/60 of the GEMM work),
where the device is idle most of the step, so the wall ms/step is the
host's time to issue the step. Prints one `REMAT {json}` line per run,
then `REMAT summary {json}` with each policy's medians.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

_CHILD = """
import json, sys, dataclasses
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import kernels, profile_step
from horovod_tpu_torch import transformer_lm as lm
from horovod_tpu_torch.models import transformer as tfm
policy, steps = sys.argv[1], int(sys.argv[2])
kernels.build_all()
hvd.init()
dev = hvd.device()
out = {"policy": policy}
base = tfm.TransformerConfig(**lm.FLAGSHIP, attn="flash",
                             dtype=torch.bfloat16, remat=policy != "none",
                             remat_policy="dots" if policy == "none"
                             else policy)
narrow = dataclasses.replace(base, d_model=256, d_ff=1024, n_heads=2)
for tag, cfg in (("flagship", base), ("narrow", narrow)):
    _, _, step = lm.build(cfg, dev)
    data = lm.make_batch(lm.FLAGSHIP_BATCH, cfg.max_seq, cfg.vocab, dev, 0)
    torch.cuda.reset_peak_memory_stats(dev)
    r = profile_step.profile_route(lambda: step(data), steps)
    out[tag] = {"ms_per_step": r["untraced_wall_ms_per_step"],
                "busy_ms_per_step": r["device_busy_ms_per_step"],
                "busy_share": r["busy_share"],
                "kernels_per_step": r["kernels_per_step"],
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del step
    torch.cuda.empty_cache()
hvd.shutdown()
print("REMAT", json.dumps(out), flush=True)
"""

POLICIES = ("none", "dots", "full")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--steps", type=int, default=10)
    a = p.parse_args()
    rc, runs = 0, {k: [] for k in POLICIES}
    for i in range(a.rounds):
        for policy in POLICIES if i % 2 == 0 else POLICIES[::-1]:
            r = subprocess.run([sys.executable, "-c", _CHILD, policy,
                                str(a.steps)], capture_output=True,
                               text=True, timeout=900)
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("REMAT ")]
            print(lines[-1] if lines else
                  f"REMAT {policy} failed (exit {r.returncode}): "
                  f"{r.stderr.strip()[-2000:]}", flush=True)
            if lines:
                runs[policy].append(json.loads(lines[-1].split(" ", 1)[1]))
            rc = rc or r.returncode
    summary = {
        policy: {f"{tag}_{k}": statistics.median(r[tag][k] for r in rs)
                 for tag in ("flagship", "narrow")
                 for k in ("ms_per_step", "busy_ms_per_step",
                           "peak_mem_gb")}
        for policy, rs in runs.items() if rs}
    print("REMAT summary", json.dumps(summary), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
