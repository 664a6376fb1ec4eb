"""MPI launch backend: build and run an `mpirun` command line
(counterpart of horovod_tpu/runner/mpi_run.py, after horovod/runner/
mpi_run.py): flavour detection through `mpirun --version`, the flavour's
flags and env passthrough by name (`-x` / `-genvlist`), host list and
NIC include list.

`mpirun` only places the processes: the workers join their
torch.distributed world through the launcher's rendezvous exactly as
launch_static's do, with HOROVOD_RANK taken from the rank variable each
MPI flavour exports (named by HOROVOD_MPI_RANK_ENV).
"""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

OMPI = "OpenMPI"
SMPI = "SpectrumMPI"
MPICH = "MPICH"
IMPI = "IntelMPI"
UNKNOWN = "Unknown"
MISSING = "Missing"

# Per-flavor: (base flags, binding args). TCP/oob tuning flags from the
# reference are dropped — the MPI wireup only carries the process launch,
# not tensor traffic.
_FLAVOR_FLAGS: Dict[str, Tuple[List[str], List[str]]] = {
    OMPI: (["--allow-run-as-root", "--tag-output"],
           ["--bind-to", "none", "--map-by", "slot"]),
    SMPI: (["--tag-output"], []),
    MPICH: ([], ["-bind-to", "none", "-map-by", "slot"]),
    IMPI: ([], []),
}

# Env var each flavor sets with the process's global/local rank; workers
# read them when HOROVOD_RANK/HOROVOD_LOCAL_RANK are absent
# (common/config.py _env_or_mpi).
RANK_ENV = {
    OMPI: "OMPI_COMM_WORLD_RANK",
    SMPI: "OMPI_COMM_WORLD_RANK",
    MPICH: "PMI_RANK",
    IMPI: "PMI_RANK",
}
LOCAL_RANK_ENV = {
    OMPI: "OMPI_COMM_WORLD_LOCAL_RANK",
    SMPI: "OMPI_COMM_WORLD_LOCAL_RANK",
    MPICH: "MPI_LOCALRANKID",
    IMPI: "MPI_LOCALRANKID",
}


def _exec_version(env: Optional[dict]) -> Optional[Tuple[str, int]]:
    try:
        res = subprocess.run(["mpirun", "--version"],
                             capture_output=True, text=True, timeout=30,
                             env=env)
        return res.stdout + res.stderr, res.returncode
    except (OSError, subprocess.TimeoutExpired):
        return None


def detect_mpi_implementation(env: Optional[dict] = None,
                              _exec=_exec_version) -> str:
    """Reference: _get_mpi_implementation (mpi_run.py:82)."""
    res = _exec(env)
    if res is None:
        return MISSING
    output, code = res
    if code != 0:
        return MISSING
    if "Open MPI" in output or "OpenRTE" in output:
        return OMPI
    if "IBM Spectrum MPI" in output:
        return SMPI
    if "Intel(R) MPI" in output:
        return IMPI
    if "MPICH" in output or "HYDRA" in output:
        return MPICH
    return UNKNOWN


def mpi_available(env: Optional[dict] = None) -> bool:
    return shutil.which("mpirun", path=(env or os.environ).get(
        "PATH")) is not None


def build_mpirun_command(num_proc: int, hosts: str, command: List[str],
                         env: Dict[str, str],
                         implementation: str,
                         nics: Optional[List[str]] = None,
                         extra_flags: Optional[List[str]] = None
                         ) -> List[str]:
    """Flavor-specific mpirun invocation (reference: mpi_run settings →
    mpirun_command assembly, mpi_run.py:133-240).

    `env` entries travel BY NAME ONLY — `-x NAME` (OpenMPI/Spectrum) or
    `-genvlist N1,N2,...` (MPICH/Intel); values come from the launcher's
    exported subprocess environment. Values must never ride the command
    line: it is world-readable via /proc on shared HPC nodes and these
    vars include the job HMAC secret (reference passes env by name the
    same way, mpi_run.py:-x).
    """
    if implementation in (MISSING, UNKNOWN):
        raise RuntimeError(
            f"cannot build mpirun command: implementation is "
            f"{implementation}")
    base, binding = _FLAVOR_FLAGS[implementation]
    cmd = ["mpirun"] + list(base)
    cmd += ["-np", str(num_proc)]
    if implementation in (OMPI, SMPI):
        cmd += ["-H", hosts]
        if nics:  # OpenMPI takes ONE comma-joined value per MCA key
            cmd += ["-mca", "btl_tcp_if_include", ",".join(nics)]
        for k in sorted(env):
            cmd += ["-x", k]
    else:
        cmd += ["-hosts", ",".join(h.split(":")[0]
                                   for h in hosts.split(","))]
        if nics:
            cmd += ["-iface", nics[0]]
        if env:
            cmd += ["-genvlist", ",".join(sorted(env))]
    cmd += binding
    cmd += list(extra_flags or [])
    cmd += list(command)
    return cmd


def mpi_run(num_proc: int, hosts: str, command: List[str],
            env: Dict[str, str],
            nics: Optional[List[str]] = None,
            extra_flags: Optional[List[str]] = None,
            _detect=None) -> int:
    """Launch `command` on num_proc slots via mpirun; returns exit code.

    The coordinator env (HOROVOD_RENDEZVOUS_*, secret, SIZE) is injected
    exactly as launch_static does, so workers bootstrap identically
    regardless of which placer started them.
    """
    impl = (_detect or detect_mpi_implementation)(None)
    if impl in (MISSING, UNKNOWN):
        raise RuntimeError(
            "mpirun is not available or unrecognized; install OpenMPI/"
            "MPICH/IntelMPI or use the default launcher")
    worker_env = coordinator_env(num_proc, env)
    worker_env.setdefault("HOROVOD_MPI_RANK_ENV", RANK_ENV[impl])
    worker_env.setdefault("HOROVOD_MPI_LOCAL_RANK_ENV",
                          LOCAL_RANK_ENV[impl])
    rdv = worker_env.pop(_RDV_HANDLE)
    full_env = dict(os.environ)
    full_env.update(worker_env)
    cmd = build_mpirun_command(num_proc, hosts, command, env=worker_env,
                               implementation=impl, nics=nics,
                               extra_flags=extra_flags)
    print("mpi_run:", " ".join(shlex.quote(c) for c in cmd),
          file=sys.stderr)
    try:
        return subprocess.run(cmd, env=full_env).returncode
    finally:
        rdv.stop()


_RDV_HANDLE = "__rdv__"


def coordinator_env(num_proc: int, env: Dict[str, str]) -> Dict[str, str]:
    """Start the rendezvous KV on this (launch) host and build the worker
    env, the same bootstrap contract launch_static injects: rendezvous
    address/port, controller tag, HMAC secret, and HOROVOD_SIZE. Without this, workers on each host would
    silently form isolated per-host rings.

    Returns the env dict with the live RendezvousServer under the
    _RDV_HANDLE key; the caller must pop it and stop() it after the run.
    """
    from horovod_tpu_torch.common import config as C
    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.launch import CONTROLLER, _local_ip
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer

    job_secret = secret_mod.make_secret_key()
    rdv = RendezvousServer(secret=job_secret.encode())
    port = rdv.start()
    out = dict(env)
    out.update({
        C.HOROVOD_RENDEZVOUS_ADDR: _local_ip(),
        C.HOROVOD_RENDEZVOUS_PORT: str(port),
        C.HOROVOD_CONTROLLER: CONTROLLER,
        secret_mod.SECRET_ENV: job_secret,
        "HOROVOD_SIZE": str(num_proc),
    })
    out[_RDV_HANDLE] = rdv
    return out
