"""Worker for tests/test_torch_layout.py: one rank of a 2-rank gloo world
that trains a mini ResNet (STAGE_BLOCKS[8] = (1, 1), 16x16, 10 classes,
f32) under core/autotune.OnlineLayoutTuner with HOROVOD_LAYOUT_AUTOTUNE=1
and interval 3, swapping the model and its DistributedOptimizer with
models/resnet.relayout whenever the tuner changes arm.

Imports torch and horovod_tpu_torch only. The step walls fed to the
tuner are made up and differ by rank: rank 0 finds the padded arm
faster, rank 1 the declared one, and rank 1's `_decide` raises if
called, so both ranks must end on rank 0's broadcast decision. Writes
{choice, result, the steps at which the arm changed, the padded lanes'
largest magnitude at the end} as JSON to `out_path`.
"""

import json

from torch_collectives_worker import _env

STEPS = 14


def run_tuner(rank, size, store, out_path):
    _env(rank, size, {"HOROVOD_LAYOUT_AUTOTUNE": "1",
                      "HOROVOD_LAYOUT_AUTOTUNE_INTERVAL": "3"})
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import autotune, topology
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.ops import layout

    torch.set_num_threads(1)
    resnet.STAGE_BLOCKS[8] = (1, 1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    try:
        def make_opt(m):
            return hvd.DistributedOptimizer(
                torch.optim.SGD(m.parameters(), lr=0.01, momentum=0.9),
                named_parameters=m.named_parameters())

        model = resnet.ResNet(8, 10)
        opt = make_opt(model)
        plan = layout.plan(model.state_dict(), resnet.conv_stack(8),
                           lane=layout.TPU_LANE)
        tuner = autotune.OnlineLayoutTuner(topology.config())
        if rank != 0:
            def refuse():
                raise AssertionError("rank 1 made the layout decision")
            tuner._decide = refuse
        fast = "nhwc_padded" if rank == 0 else "as_declared"
        gen = torch.Generator().manual_seed(rank)
        x = torch.randn((2, 16, 16, 3), generator=gen)
        y = torch.randint(0, 10, (2,), generator=gen)
        changes = []
        for step in range(STEPS):
            opt.zero_grad()
            loss, stats = resnet.loss_fn(model, (x, y))
            loss.backward()
            opt.step()
            model.set_stats(stats)
            tuner.record_step(0.1 if tuner.choice == fast else 0.2)
            if tuner.update():
                changes.append((step, tuner.choice))
                model, opt = resnet.relayout(model, opt, plan, tuner.choice,
                                             make_opt)
        state = model.state_dict()
        moms = {n: opt.state[p]["momentum_buffer"]
                for n, p in model.named_parameters()}
        lanes = max(plan.padding_max(state), plan.padding_max(moms)) \
            if tuner.choice == layout.NHWC_PADDED else 0.0
        with open(out_path, "w") as f:
            json.dump({"choice": tuner.choice, "result": tuner.result,
                       "frozen": tuner.frozen, "changes": changes,
                       "padded_lanes_max": lanes,
                       "conv1": list(state["s0b0.conv1"].shape)}, f)
    finally:
        hvd.shutdown()
