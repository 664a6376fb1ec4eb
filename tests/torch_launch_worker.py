"""Worker code for tests/test_torch_launch.py, run in processes that the
PyTorch package's launcher starts.

`main()` is the script the launcher runs: one rank that joins the gloo
world from the env the launcher injected (optionally without
HOROVOD_COORDINATOR_ADDR, so that rank 0 publishes a coordinator
through the rendezvous KV), all-reduces int32 [3, -4, -8] + rank with
the default Average and prints what it saw as one JSON line. `rank_x10`
and `fail` are module-level functions for `runner.run`.
"""

import json
import os
import sys


def rank_x10() -> int:
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        return hvd.rank() * 10
    finally:
        hvd.shutdown()


def fail() -> None:
    raise ValueError("this rank fails")


def main() -> None:
    if "--kv-coordinator" in sys.argv:
        os.environ.pop("HOROVOD_COORDINATOR_ADDR", None)
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import topology

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    try:
        x = torch.tensor([3, -4, -8], dtype=torch.int32) + hvd.rank()
        y = hvd.allreduce(x)
        print(json.dumps({
            "rank": hvd.rank(), "size": hvd.size(),
            "local_rank": hvd.local_rank(),
            "controller": os.environ.get("HOROVOD_CONTROLLER"),
            "rendezvous": topology.rendezvous(),
            "average": y.tolist(), "dtype": str(y.dtype)}), flush=True)
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
