"""Serving replica for tests/test_torch_serve_e2e.py, started by
`python -m horovod_tpu_torch.serve` (the port's counterpart of
tests/serve_replica.py). It

* restores its weights params-only from the training checkpoint the
  test saved (checkpoint.restore_params: no optimizer is built),
* warms every batch bucket (on the CPU, which it asks for: the engine's
  eager path),
* serves until the launcher drains it (exit 0), and
* writes its pid to SERVE_TEST_PID_DIR/<hostname> so the test can
  SIGKILL a chosen replica under load.

Model: y = x @ w + b on a (FEATURES,) input; every answer proves the
checkpoint's weights produced it.
"""

import os
import sys

import numpy as np
import torch

FEATURES = int(os.environ.get("SERVE_TEST_FEATURES", "4"))


class Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(FEATURES))
        self.b = torch.nn.Parameter(torch.zeros(()))


def infer_fn(model, x):
    return x @ model.w + model.b


def main() -> int:
    from horovod_tpu_torch.serve.batching import ContinuousBatcher
    from horovod_tpu_torch.serve.engine import InferenceEngine
    from horovod_tpu_torch.serve.replica import serve_replica

    pid_dir = os.environ.get("SERVE_TEST_PID_DIR", "")
    if pid_dir:
        host = os.environ.get("HOROVOD_HOSTNAME", "localhost")
        os.makedirs(pid_dir, exist_ok=True)
        with open(os.path.join(pid_dir, host), "w") as f:
            f.write(str(os.getpid()))
    torch.set_num_threads(1)
    engine = InferenceEngine.from_checkpoint(
        os.environ["SERVE_TEST_CHECKPOINT"], infer_fn, Linear(),
        name="e2e", device="cpu")
    assert float(engine.model.w.sum()) != 0.0, \
        "checkpoint params came back as zeros"
    batcher = ContinuousBatcher()  # the job's knobs, from the env
    engine.warmup((FEATURES,), np.float32, batcher.buckets)
    return serve_replica(engine)


if __name__ == "__main__":
    sys.exit(main())
