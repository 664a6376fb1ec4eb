"""Elastic ResNet-50 training, launched in elastic mode: the worker of
`chip_smoke.py` phase 10's preemption and resize runs.

    python -m horovod_tpu_torch.runner.launch \\
        --host-discovery-script ./discover.sh --min-np 1 \\
        --slots-per-host 1 \\
        python -m horovod_tpu_torch.elastic.resnet_check --steps 6 \\
            --kill-step 3

Each worker runs `hvd.init()`, builds ResNet-50 (seed-0 weights; 224²,
bf16, batch 32 by default; HOROVOD_CONV_BLOCK=1 puts kernels 1 and 2
at its 28 fused sites), wraps SGD(lr 0.01, momentum 0.9) in
`DistributedOptimizer`, and holds model, optimizer and counters in a
`TrainLoopState` wired to an `AsyncCheckpointer` (HOROVOD_CKPT_DIR,
saving every HOROVOD_CKPT_EVERY steps). Step s trains on the batch made
from seed s on every rank, and the learning rate does not scale with
the world, so the run's values do not depend on the world size or on
where it was interrupted: an uninterrupted run of one process is the
reference of every other.

Faults, in round 1 only:
  --kill-step K   every worker SIGKILLs itself after step K's save is
                  committed (a whole-job preemption);
  --exit-step S --exit-rank R
                  rank R writes "localhost:1" into --hosts-file and
                  exits 7 at the start of step S: the survivors' next
                  collective raises HorovodInternalError;
and in a round of size 1 after the first:
  --grow-step G   rank 0 writes "localhost:2" into --hosts-file after
                  step G and holds at the commit until the new round.

Lines on stdout: RESUME (each entry into the training function: step,
source, size, round, wall time), STEP (loss as repr, kernel 1 and 2
launches of the step, size, round, wall time), RAISED (seconds from the
failed step's start to its HorovodInternalError), DIGEST (sha256 of
every tensor of the model's state_dict, at --digest-steps), KILL and
EXIT (wall time), and DONE.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import signal
import sys
import time

import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.ops import conv_block as cb


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--image", type=int, default=224)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--kill-step", type=int, default=0)
    p.add_argument("--exit-step", type=int, default=0)
    p.add_argument("--exit-rank", type=int, default=1)
    p.add_argument("--grow-step", type=int, default=0)
    p.add_argument("--hosts-file", default="")
    p.add_argument("--digest-steps", default="")
    return p.parse_args(argv)


def digest(model) -> str:
    h = hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def batch(step: int, args, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(step)
    x = torch.randn((args.batch, args.image, args.image, 3), generator=gen,
                    device=dev).to(dtype)
    y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
    return x, y


def _write_hosts(path: str, spec: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(spec + "\n")
    os.replace(tmp, path)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    hvd.init(device=None if args.device == "cuda" else "cpu")
    dev = hvd.device()
    dtype = torch.bfloat16 if args.device == "cuda" else torch.float32
    model = resnet.ResNet(depth=args.depth, dtype=dtype, device=dev, seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=model.named_parameters())
    state = elastic.TrainLoopState(model=model, optimizer=opt)
    digests = {int(s) for s in args.digest_steps.split(",") if s}
    held = {"grow": False}

    def now_round() -> str:
        return os.environ.get("HOROVOD_ELASTIC_ROUND", "0")

    @elastic.run
    def train(st):
        print(f"RESUME step={st.step} source={st.last_resume_source} "
              f"size={hvd.size()} rank={hvd.rank()} round={now_round()} "
              f"t={time.time():.6f}", flush=True)
        while st.step < args.steps:
            step = st.step + 1
            if (args.grow_step and st.step >= args.grow_step
                    and hvd.size() == 1 and now_round() != "1"):
                if not held["grow"] and hvd.rank() == 0:
                    _write_hosts(args.hosts_file, "localhost:2")
                    held["grow"] = True
                st.check_host_updates()  # HostsUpdatedInterrupt
                time.sleep(0.1)
                continue
            if (args.exit_step == step and hvd.rank() == args.exit_rank
                    and now_round() == "1"):
                _write_hosts(args.hosts_file, "localhost:1")
                print(f"EXIT rank={hvd.rank()} step={step} "
                      f"t={time.time():.6f}", flush=True)
                os._exit(7)
            t0 = time.perf_counter()
            f0, b0 = (cb.conv1x1_fwd_fused.launches,
                      cb.conv1x1_bn_act_bwd_fused.launches)
            try:
                opt.zero_grad()
                loss, new_stats = resnet.loss_fn(
                    model, batch(step, args, dtype, dev), train=True,
                    group=dist.group.WORLD)
                loss.backward()
                opt.step()
                model.set_stats(new_stats)
                value = loss.item()
            except HorovodInternalError:
                print(f"RAISED step={step} rank={hvd.rank()} "
                      f"after={time.perf_counter() - t0:.3f}", flush=True)
                raise
            st.step = step
            st.record_batch(args.batch)
            st.commit()
            launches = (cb.conv1x1_fwd_fused.launches - f0,
                        cb.conv1x1_bn_act_bwd_fused.launches - b0)
            print(f"STEP step={step} loss={value!r} launches="
                  f"{launches[0]},{launches[1]} size={hvd.size()} "
                  f"rank={hvd.rank()} round={now_round()} "
                  f"t={time.time():.6f}", flush=True)
            if step in digests:
                print(f"DIGEST step={step} rank={hvd.rank()} "
                      f"digest={digest(model)}", flush=True)
            kill = args.kill_step == step and now_round() == "1"
            if kill:
                # the save the next round must find: retried until this
                # step's generation is committed
                ok = st.checkpoint(block=True)
                for _ in range(10):
                    if ok or hvd.rank() != 0:
                        break
                    st.checkpointer.wait(60)
                    ok = st.checkpoint(block=True)
                if hvd.rank() == 0 and not ok:
                    raise SystemExit(f"step {step}'s save never committed")
                hvd.barrier()  # every rank in host code before any dies
                print(f"KILL rank={hvd.rank()} step={step} "
                      f"t={time.time():.6f}", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
            st.maybe_checkpoint()
        return st.step

    final = train(state)
    if state.checkpointer is not None:
        state.checkpointer.close()
    print(f"DONE step={final} rank={hvd.rank()} size={hvd.size()} "
          f"digest={digest(model)}", flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
