"""Worker for tests/test_torch_collective_semantics.py: one rank of a
gloo world that runs the eager collectives on integer and bf16 inputs.

Imports torch and horovod_tpu_torch only. Started with the `spawn`
method; its inputs arrive as numpy arrays, and it writes every result
to `out_path` as an .npz file (bf16 as its uint16 bit patterns).
"""

import os

import numpy as np


def run(rank: int, size: int, store: str, inputs: dict,
        out_path: str) -> None:
    os.environ.update({"HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(size),
                       "HOROVOD_LOCAL_RANK": str(rank),
                       "HOROVOD_LOCAL_SIZE": str(size)})
    import torch

    import horovod_tpu_torch as hvd

    def bits(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    out = {}
    try:
        ints = torch.from_numpy(inputs["ints"][rank])
        out["allreduce"] = bits(hvd.allreduce(ints))
        out["grouped"] = bits(hvd.grouped_allreduce([ints, ints])[1])
        out["bucketed"] = bits(hvd.bucketed_allreduce([ints])[0])
        bf = torch.from_numpy(inputs["bf16_bits"][rank].view(np.int16)
                              ).view(torch.bfloat16)
        out["bf16_prescale"] = bits(hvd.allreduce(bf, prescale_factor=1 / 3))
        out["bf16_prescale_grouped"] = bits(
            hvd.grouped_allreduce([bf], prescale_factor=1 / 3)[0])
        out["int_postscale"] = bits(hvd.allreduce(ints, postscale_factor=2.5))
        out["int_postscale_bucketed"] = bits(
            hvd.bucketed_allreduce([ints], postscale_factor=2.5)[0])
        hvd.barrier()
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)
