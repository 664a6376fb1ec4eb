"""A/B of two checkouts on one card: the conv kernels 1–3 over a
ResNet-50 step, flash kernels 4–6 and the LM step.

    python -m horovod_tpu_torch.ab_compare OTHER_CHECKOUT [--rounds 1]
        [--lm-only]

Run from the root of a checkout. Each round runs OTHER, this, this,
OTHER, each in a fresh process from its own checkout (which builds its
own kernels) and times with this checkout's `chip_smoke.device_ms`:
`chip_smoke.time_kernels` in bf16 (kernels 1–3 at every
fused site of a ResNet-50 step at batch 32), `chip_smoke.time_flash` at
the LM's per-layer shape, then `chip_smoke.lm_path` (the flagship LM, 2
warm-up and 5 timed steps). Prints one line per run, `AB <side>
{json}`, with kernels 1–3's ms a step (summed over the 28 sites) and at
each site, the flash kernels' ms a launch (and kernels 5 + 6 as one pair, where
that checkout's chip_smoke times it), scaled_dot_product_attention's
forward and backward ms, ms/step and tokens/s. --lm-only runs the LM
step alone (phase 5 of each checkout's chip_smoke), so that many rounds
fit in one call; the last line, `AB summary {json}`, gives each side's
LM ms/step: every run's, the median, the least and the most. Two
versions are compared only inside one such call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = """
import importlib.util, json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
# Both sides time with this checkout's device_ms (the kernels' device
# time from the profiler's trace), whatever their own chip_smoke uses.
spec = importlib.util.spec_from_file_location(
    "cs_this", os.path.join(sys.argv[2], "chip_smoke.py"))
cs_this = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs_this)
cs.time_ms = cs_this.device_ms
import horovod_tpu_torch as hvd
from horovod_tpu_torch import kernels
kernels.build_all()
dev = torch.device("cuda", 0)
res = {}
if sys.argv[3] != "lm":
    conv, sites = cs.time_kernels(dev, torch.bfloat16)
    t = cs.time_flash(dev)
    res = {"conv_step_ms": {k: v["ms"] for k, v in conv.items()},
           "conv_sites_ms": [[d["kernel"], d["M"], d["Cin"], d["C"],
                              d["ms"]] for d in sites],
           "fwd": t["attn_fwd"]["ms"], "dkdv": t["attn_dkdv"]["ms"],
           "dq": t["attn_dq"]["ms"], "sdpa_fwd": t["attn_fwd"]["library_ms"],
           "sdpa_bwd": t["attn_dkdv"]["library_ms"],
           "dkdv_dq": t.get("attn_bwd_pair", {}).get("ms")}
hvd.init()
lm = cs.lm_path()
hvd.shutdown()
res.update(step_ms=lm["step_ms"], tokens_per_s=lm["tokens_per_s"])
print("AB", sys.argv[1], json.dumps(res), flush=True)
"""


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("other", help="root of the checkout to compare with")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--lm-only", action="store_true",
                   help="time the LM step alone")
    a = p.parse_args()
    trees = {"other": os.path.abspath(a.other), "this": os.getcwd()}
    rc, step_ms = 0, {"other": [], "this": []}
    for _ in range(a.rounds):
        for side in ("other", "this", "this", "other"):
            r = subprocess.run([sys.executable, "-c", _CHILD, side,
                                trees["this"],
                                "lm" if a.lm_only else "all"],
                               cwd=trees[side], capture_output=True,
                               text=True, timeout=900)
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("AB ")]
            print(lines[-1] if lines else
                  f"AB {side} failed (exit {r.returncode}): "
                  f"{r.stderr.strip()[-2000:]}", flush=True)
            if lines:
                step_ms[side].append(json.loads(
                    lines[-1].split(" ", 2)[2])["step_ms"])
            rc = rc or r.returncode
    print("AB summary", json.dumps({
        side: {"step_ms": v, "median": statistics.median(v),
               "min": min(v), "max": max(v)}
        for side, v in step_ms.items() if v}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
