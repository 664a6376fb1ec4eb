"""Elastic end-to-end worker for tests/test_torch_elastic_e2e.py (the
port's counterpart of tests/elastic_worker.py, on gloo).

Each step all-reduces ones and adds their sum over the world size to
the model's `w`, so w == step at every committed step if and only if the
state survived.

Protocol with the test:
- WORKER_BOOT is printed once per process start (survivors are never
  respawned);
- rank 0 appends each committed step to ELASTIC_PROGRESS_FILE;
- RESIZED old=<n> new=<n> step=<s> after a round of another size, and
  ELASTIC_DONE rank=<r> size=<n> step=<s> w=<val> at the end.

Modes (argv[1]):
  resize — train to ELASTIC_TOTAL_STEPS; at ELASTIC_WAIT_STEP the first
           round's workers hold at a committed point until the host set
           changes;
  crash  — the worker on ELASTIC_CRASH_HOSTNAME exits 7 at
           ELASTIC_CRASH_STEP in round 1; the survivors' next collective
           raises HorovodInternalError, they restore the last commit and
           join round 2;
  ckpt   — a TrainLoopState with an AsyncCheckpointer (HOROVOD_CKPT_DIR)
           saves every step; at ELASTIC_CKPT_KILL_STEP in round 1 every
           worker SIGKILLs itself after the save is committed, and round
           2's fresh workers resume from the last committed step
           (RESUME ... source=checkpoint).
"""

import os
import signal
import sys
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic

TOTAL_STEPS = int(os.environ.get("ELASTIC_TOTAL_STEPS", "12"))
WAIT_STEP = int(os.environ.get("ELASTIC_WAIT_STEP", "8"))
PROGRESS_FILE = os.environ.get("ELASTIC_PROGRESS_FILE", "")
CRASH_HOSTNAME = os.environ.get("ELASTIC_CRASH_HOSTNAME", "")
CRASH_STEP = int(os.environ.get("ELASTIC_CRASH_STEP", "5"))
CKPT_KILL_STEP = int(os.environ.get("ELASTIC_CKPT_KILL_STEP", "0"))


class W(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(4))


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "resize"
    my_host = os.environ.get("HOROVOD_HOSTNAME", "?")
    boot_round = os.environ.get("HOROVOD_ELASTIC_ROUND", "0")
    print(f"WORKER_BOOT host={my_host} local_rank="
          f"{os.environ.get('HOROVOD_LOCAL_RANK')} round={boot_round}",
          flush=True)
    hvd.init(device="cpu")
    model = W()
    if mode == "ckpt":
        # the checkpointer attaches from HOROVOD_CKPT_DIR
        state = elastic.TrainLoopState(model=model, step=0)
    else:
        state = elastic.TorchState(model=model, step=0)
    # A worker that joins after round 1 was born resized: it must not
    # wait at WAIT_STEP or it would stall the survivors' collectives.
    sizes = {"last": hvd.size(), "resized": boot_round != "1"}

    @elastic.run
    def train(st):
        if mode == "ckpt":
            print(f"RESUME step={st.step} source={st.last_resume_source} "
                  f"size={hvd.size()} "
                  f"round={os.environ.get('HOROVOD_ELASTIC_ROUND')}",
                  flush=True)
        while st.step < TOTAL_STEPS:
            now = hvd.size()
            if now != sizes["last"]:
                print(f"RESIZED old={sizes['last']} new={now} "
                      f"step={st.step}", flush=True)
                sizes["last"] = now
                sizes["resized"] = True
            if (mode == "resize" and st.step >= WAIT_STEP
                    and not sizes["resized"]):
                # hold at a committed point until the driver's next round
                st.check_host_updates()
                time.sleep(0.1)
                continue
            g = hvd.allreduce(torch.ones(4), op=hvd.Sum,
                              name="elastic_step_grad")
            with torch.no_grad():
                model.w.add_(g / now)
            st.step += 1
            if (mode == "crash" and my_host == CRASH_HOSTNAME
                    and st.step == CRASH_STEP
                    and os.environ.get("HOROVOD_ELASTIC_ROUND") == "1"):
                print(f"CRASHING host={my_host} step={st.step}", flush=True)
                os._exit(7)
            if mode == "ckpt":
                st.record_batch(1)
            st.commit()
            if mode == "ckpt":
                kill_now = (CKPT_KILL_STEP > 0 and st.step == CKPT_KILL_STEP
                            and os.environ.get(
                                "HOROVOD_ELASTIC_ROUND") == "1")
                accepted = st.checkpoint(block=kill_now)
                if kill_now:
                    if hvd.rank() == 0:
                        # a save may be skipped under back-pressure:
                        # drain and retry until this step's is committed
                        for _ in range(10):
                            if accepted:
                                break
                            st.checkpointer.wait(30)
                            accepted = st.checkpoint(block=True)
                        if not accepted:
                            raise SystemExit("kill-step save never "
                                             "committed")
                    # every rank in host code before anyone dies
                    hvd.allreduce(torch.ones(1), op=hvd.Sum,
                                  name="ckpt_kill_barrier")
                    print(f"CKPT_KILL host={my_host} step={st.step}",
                          flush=True)
                    os.kill(os.getpid(), signal.SIGKILL)
            if hvd.rank() == 0 and PROGRESS_FILE:
                with open(PROGRESS_FILE, "a") as f:
                    f.write(f"{st.step}\n")
            time.sleep(0.15)
        return st.step

    final = train(state)
    w = float(model.w[0])
    print(f"ELASTIC_DONE rank={hvd.rank()} size={hvd.size()} "
          f"step={final} w={w:.3f}", flush=True)
    if final != TOTAL_STEPS or abs(w - TOTAL_STEPS) > 1e-3:
        raise SystemExit(f"state lost: step {final}, w={w}")
    if state.checkpointer is not None:
        state.checkpointer.close()
    hvd.shutdown()


if __name__ == "__main__":
    main()
