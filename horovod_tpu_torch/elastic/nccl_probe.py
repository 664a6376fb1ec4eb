"""How this torch's NCCL backend reports a dead peer: the probe behind
elastic mode's settings (core/topology.py), on two cards.

    python -m horovod_tpu_torch.elastic.nccl_probe [--timeout 10]

Two ranks on cuda:0 and cuda:1 with TORCH_NCCL_BLOCKING_WAIT=1 and
TORCH_NCCL_ASYNC_ERROR_HANDLING=0 all-reduce once; rank 1 exits; rank 0
all-reduces again, once through the synchronous call (`sync`) and once
through `async_op=True` and `Work.wait()` (`async`), each in a fresh
pair of processes. Rank 0 prints whether and when the second all-reduce
raised, whether `_abort_process_group()` returned, and whether a new
world of one works in the same process. A rank still running after
`--timeout` + 35 s dumps its stack (faulthandler) and exits.
"""

from __future__ import annotations

import argparse
import datetime
import faulthandler
import os
import socket
import subprocess
import sys
import tempfile
import time


def rank_main(rank: int, port: int, mode: str, timeout: float) -> None:
    os.environ.setdefault("TORCH_NCCL_BLOCKING_WAIT", "1")
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    import torch
    import torch.distributed as dist

    faulthandler.dump_traceback_later(timeout + 35, exit=True)
    torch.cuda.set_device(rank)

    def log(*a):
        print(f"[probe {mode} r{rank} {time.strftime('%H:%M:%S')}]", *a,
              flush=True)

    store = dist.TCPStore("127.0.0.1", port, 2, is_master=(rank == 0),
                          timeout=datetime.timedelta(seconds=30))
    dist.init_process_group("nccl", store=store, rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=timeout))
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    log("first all_reduce", x.tolist())
    if rank == 1:
        log("exiting")
        os._exit(7)
    time.sleep(1)
    t0 = time.time()
    try:
        if mode == "sync":
            dist.all_reduce(x)
        else:
            dist.all_reduce(x, async_op=True).wait()
        log(f"second all_reduce returned after {time.time() - t0:.4f} s")
        torch.cuda.synchronize()
        log("synchronized", x.tolist())
    except Exception as e:
        log(f"raised after {time.time() - t0:.2f} s: {type(e).__name__}: "
            f"{str(e)[:300]}")
    t0 = time.time()
    dist.distributed_c10d._abort_process_group()
    log(f"abort returned after {time.time() - t0:.2f} s")
    y = torch.ones(3, device="cuda")
    torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="nccl_probe_")
    os.close(fd)
    os.unlink(path)
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=timeout))
    dist.all_reduce(y)
    torch.cuda.synchronize()
    log("new world of one all_reduce", y.tolist(),
        f"{time.time() - t0:.4f} s after the abort")
    dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--timeout", type=float, default=10.0,
                   help="the process group's timeout, seconds")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--mode", default="", choices=["", "sync", "async"])
    args = p.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, args.port, args.mode, args.timeout)
        return 0
    import torch
    if torch.cuda.device_count() < 2:
        print("nccl_probe: needs two cards", file=sys.stderr)
        return 1
    for mode in ("sync", "async"):
        with socket.socket() as s:
            s.bind(("", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.elastic.nccl_probe",
             "--rank", str(r), "--port", str(port), "--mode", mode,
             "--timeout", str(args.timeout)]) for r in (0, 1)]
        for proc in procs:
            try:
                proc.wait(timeout=args.timeout + 60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
