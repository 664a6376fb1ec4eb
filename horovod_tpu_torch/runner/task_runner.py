"""Worker side of the interactive `run(fn)` API (counterpart of
horovod_tpu/runner/task_runner.py).

Loads the pickled function, runs it and writes (ok, result or
traceback) where the launcher reads it; exits 1 if the function raised,
so that the launcher stops the other ranks. It calls nothing of the
framework: the function itself calls `hvd.init`.
"""

from __future__ import annotations

import os
import pickle
import sys

from horovod_tpu_torch.runner.results import capture


def main() -> int:
    fn_path = os.environ["HOROVOD_RUN_FUNC_FILE"]
    out_dir = os.environ["HOROVOD_RUN_RESULT_DIR"]
    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    with open(fn_path, "rb") as f:
        fn = pickle.load(f)
    ok, payload = capture(fn)
    if not ok:
        print(payload, file=sys.stderr, flush=True)
    tmp = os.path.join(out_dir, f".rank_{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump((ok, payload), f)
    os.replace(tmp, os.path.join(out_dir, f"rank_{rank}.pkl"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
