"""LSF/jsrun launch backend (counterpart of horovod_tpu/runner/js_run.py,
after horovod/runner/js_run.py): on LSF clusters `jsrun` places one
resource set of one slot per worker; the workers join through the
launcher's rendezvous with the JSM/OMPI rank variables.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional


def is_lsf_env(env: Optional[dict] = None) -> bool:
    """Reference: util/lsf.py LSFUtils.using_lsf()."""
    e = env or os.environ
    return "LSB_JOBID" in e or "LSB_HOSTS" in e or "LSB_MCPU_HOSTS" in e


def lsf_hosts(env: Optional[dict] = None) -> Dict[str, int]:
    """host -> slots from LSB_MCPU_HOSTS ("h1 16 h2 16") or LSB_HOSTS
    (one entry per slot). Reference: LSFUtils.get_compute_hosts."""
    e = env or os.environ
    mcpu = e.get("LSB_MCPU_HOSTS", "")
    out: Dict[str, int] = {}
    if mcpu:
        toks = mcpu.split()
        pairs = list(zip(toks[::2], toks[1::2]))
        # The first entry is the batch/launch node, not a compute slot
        # (reference: LSFUtils excludes it); keep it only when it is the
        # entire allocation (single-node jobs).
        if len(pairs) > 1:
            pairs = pairs[1:]
        for host, n in pairs:
            out[host] = out.get(host, 0) + int(n)
        return out
    toks = e.get("LSB_HOSTS", "").split()
    if len(set(toks)) > 1:
        toks = toks[1:]  # same batch-node exclusion as the MCPU path
    for host in toks:
        out[host] = out.get(host, 0) + 1
    return out


def js_available() -> bool:
    return shutil.which("jsrun") is not None


def build_jsrun_command(num_proc: int, command: List[str],
                        env: Dict[str, str],
                        gpus_per_rs: int = 0,
                        cpus_per_rs: int = 1,
                        extra_flags: Optional[List[str]] = None
                        ) -> List[str]:
    """One resource set per worker (reference: js_run.py command
    construction: --nrs/--tasks_per_rs/--cpu_per_rs/--gpu_per_rs)."""
    cmd = ["jsrun",
           "--nrs", str(num_proc),
           "--tasks_per_rs", "1",
           "--cpu_per_rs", str(cpus_per_rs)]
    if gpus_per_rs:
        cmd += ["--gpu_per_rs", str(gpus_per_rs)]
    # export by NAME (-E): values stay in the subprocess environment and
    # off the world-readable command line (they include the HMAC secret)
    for k in sorted(env):
        cmd += ["-E", k]
    cmd += ["--stdio_mode", "prepended"]
    cmd += list(extra_flags or [])
    cmd += list(command)
    return cmd


def js_run(num_proc: int, command: List[str], env: Dict[str, str],
           cpus_per_rs: int = 1, gpus_per_rs: int = 0,
           extra_flags: Optional[List[str]] = None) -> int:
    if not js_available():
        raise RuntimeError("jsrun not found; js_run requires an LSF "
                           "allocation (reference: run_controller jsrun "
                           "fallback)")
    from horovod_tpu_torch.runner.mpi_run import _RDV_HANDLE, coordinator_env

    worker_env = coordinator_env(num_proc, env)
    # jsrun tasks see OMPI-style rank vars through JSM's PMIx plumbing.
    worker_env.setdefault("HOROVOD_MPI_RANK_ENV", "OMPI_COMM_WORLD_RANK")
    worker_env.setdefault("HOROVOD_MPI_LOCAL_RANK_ENV",
                          "OMPI_COMM_WORLD_LOCAL_RANK")
    rdv = worker_env.pop(_RDV_HANDLE)
    full_env = dict(os.environ)
    full_env.update(worker_env)
    cmd = build_jsrun_command(
        num_proc, command, env=worker_env,
        cpus_per_rs=cpus_per_rs, gpus_per_rs=gpus_per_rs,
        extra_flags=extra_flags)
    print("js_run:", " ".join(cmd), file=sys.stderr)
    try:
        return subprocess.run(cmd, env=full_env).returncode
    finally:
        rdv.stop()
