"""Worker for tests/test_torch_join_callbacks.py: one rank of a 3-rank
gloo world that runs join over uneven loops and the training callbacks.

Imports torch and horovod_tpu_torch only; writes its results to
`out_path` as an .npz file.
"""

import numpy as np

from torch_collectives_worker import _env

LOCAL_STEPS = [2, 4, 3]  # each rank's own batches
SCHEDULE = dict(epochs=4, steps_per_epoch=3)


def lr_trace(cb_list, opt, epochs, steps_per_epoch):
    """Run the callbacks' hooks over a short schedule; the lr in state
    and in the optimizer's groups after every hook call."""
    state = {"steps_per_epoch": steps_per_epoch, "lr": None,
             "opt_state": opt}
    trace = []

    def note():
        lr = float("nan") if state["lr"] is None else state["lr"]
        trace.append((lr, opt.param_groups[0]["lr"]))

    for epoch in range(epochs):
        cb_list.on_epoch_begin(epoch, state)
        note()
        for batch in range(steps_per_epoch):
            cb_list.on_batch_end(batch, state)
            note()
        cb_list.on_epoch_end(epoch, state)
    return trace


def run_join(rank, size, store, inputs, out_path):
    _env(rank, size, {})
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import topology
    from horovod_tpu_torch.optim import callbacks as cbs

    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    out = {}
    try:
        # Uneven loops: agree on the longest, pad with zero steps.
        n = hvd.join_steps(LOCAL_STEPS[rank])
        sums = []
        for step in range(n):
            mine = float(rank + 1) if step < LOCAL_STEPS[rank] else 0.0
            sums.append(hvd.allreduce(torch.tensor([mine]),
                                      op=hvd.Sum).item())
        out["join_steps"] = np.asarray(n)
        out["sums"] = np.asarray(sums)
        out["joined_before"] = np.asarray(topology.joined())
        out["join"] = np.asarray(hvd.join())
        out["joined_after"] = np.asarray(topology.joined())

        # MetricAverageCallback
        state = {"metrics": {"loss": 1.5 * rank + 0.25, "acc": rank / 7.0}}
        cbs.MetricAverageCallback().on_epoch_end(0, state)
        out["metrics"] = np.asarray([state["metrics"]["acc"],
                                     state["metrics"]["loss"]])

        # BroadcastGlobalVariablesCallback: rank 0 resumed (one step,
        # momentum buffers), the others start from their own weights.
        torch.manual_seed(100 + rank)
        model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                    torch.nn.BatchNorm1d(3))
        opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
        if rank == 0:
            model(torch.randn(6, 4)).sum().backward()
            opt.step()
        cbs.CallbackList([cbs.BroadcastGlobalVariablesCallback(0)]
                         ).on_train_begin({"params": model.state_dict(),
                                           "opt_state": opt})
        for k, v in model.state_dict().items():
            out[f"bcast/{k}"] = v.numpy().copy()
        for i, p in enumerate(model.parameters()):
            out[f"bcast/buf{i}"] = \
                opt.state[p]["momentum_buffer"].numpy().copy()

        # The learning-rate callbacks over a short schedule (world of 3).
        p = torch.nn.Parameter(torch.zeros(2))
        opt = torch.optim.SGD([p], lr=0.0)
        warm = lr_trace(cbs.CallbackList([cbs.LearningRateWarmupCallback(
            0.1, warmup_epochs=2)]), opt, **SCHEDULE)
        out["lr_warmup"] = np.asarray(warm, dtype=np.float64)
        hvd.barrier()
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)
