"""`horovodrun`-equivalent CLI launcher (counterpart of
horovod_tpu/runner/launch.py, after horovod/runner/launch.py and
gloo_run.py).

It takes the JAX launcher's flags (the same 50, with the same `dest`
names), allocates host slots, starts the rendezvous KV, injects the
HOROVOD_* env into one worker process per slot (one per GPU), streams
their rank-prefixed output and propagates the first real failure's exit
code. On one host it also picks the coordinator address
(HOROVOD_COORDINATOR_ADDR) that `hvd.init()` builds the
torch.distributed world on; across hosts rank 0 publishes one through
the KV (core/topology.py).

Usage:
  python -m horovod_tpu_torch.runner.launch -np 4 python train.py
  python -m horovod_tpu_torch.runner.launch -np 8 -H h1:4,h2:4 python train.py

Not ported yet, and refused with a HorovodError naming the ROADMAP item
rather than ignored: elastic mode (--host-discovery-script and its
flags, A10) and the stall inspector (A13). The --autotune flags set the
HOROVOD_AUTOTUNE* knobs that the workers' ParameterManager reads
(core/autotune.py); --timeline-filename and --timeline-mark-cycles set
HOROVOD_TIMELINE and HOROVOD_TIMELINE_MARK_CYCLES, and rank 0 writes
the trace (core/topology.py). At the job's end the launcher writes the
perfscope summaries the workers pushed to its KV into
HOROVOD_FLIGHT_DIR (profiler/perfscope.py). The native KV server and
the job-end persistence of flight-recorder, watch and trace records
(A13) are left out: they serve subsystems the port does not have yet.
The launcher does not narrow CUDA_VISIBLE_DEVICES: each worker takes
`cuda:<local_rank>`.
"""

from __future__ import annotations

import argparse
import os
import re
import signal
import socket
import sys
from typing import Dict, List, Optional

from horovod_tpu_torch.common import config as C
from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.runner import hosts as hosts_mod
from horovod_tpu_torch.runner import safe_exec

PROG = "horovodrun-torch"
# HOROVOD_CONTROLLER as this launcher injects it (the JAX package: "tpu").
CONTROLLER = "torch"


def _version_string() -> str:
    import horovod_tpu_torch
    return f"horovod-tpu-torch {horovod_tpu_torch.__version__}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Launch distributed PyTorch training, one process "
                    "per GPU (reference CLI: horovodrun)")
    p.add_argument("-v", "--version", action="version",
                   version=_version_string())
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="number of worker processes (one per GPU)")
    p.add_argument("-H", "--hosts", default=None,
                   help='host slots, e.g. "h1:4,h2:4" (default: localhost)')
    p.add_argument("-hostfile", "--hostfile", default=None,
                   help="file with one 'host slots=N' or 'host:N' line "
                        "per host")
    p.add_argument("--network-interface", "--network-interfaces",
                   dest="network_interface", default=None,
                   help="comma-separated NIC allowlist for the "
                        "coordinator address")
    p.add_argument("--start-timeout", type=int, default=600,
                   help="seconds for an elastic job's workers to start")
    p.add_argument("--config-file", default=None,
                   help="YAML file of launcher params; explicit CLI flags "
                        "win")
    p.add_argument("--output-filename", default=None,
                   help="directory for per-rank worker logs "
                        "(<dir>/rank.<N>/stdout)")
    p.add_argument("-prefix-timestamp", "--prefix-output-with-timestamp",
                   dest="prefix_timestamp", action="store_true",
                   help="timestamp each prefixed worker output line")
    p.add_argument("-p", "--ssh-port", type=int, default=None,
                   help="SSH port for remote workers")
    p.add_argument("-i", "--ssh-identity-file", default=None,
                   help="SSH identity file for remote workers")
    p.add_argument("--stage-dir", default=None, metavar="DIR",
                   help="stage (rsync) the current working directory to "
                        "DIR on every remote host before launch and run "
                        "workers from there")
    p.add_argument("--disable-cache", action="store_true",
                   help="disable the collective cache (no effect here: "
                        "eager torch.distributed calls build nothing "
                        "to cache)")
    p.add_argument("--fusion-threshold-mb", type=int, default=None,
                   help="gradient fusion bucket size "
                        "(HOROVOD_FUSION_THRESHOLD)")
    p.add_argument("--cycle-time-ms", type=float, default=None,
                   help="no effect here: there is no background cycle")
    p.add_argument("--cache-capacity", type=int, default=None,
                   help="no effect here (see --disable-cache)")
    hier = p.add_mutually_exclusive_group()
    hier.add_argument("--hierarchical-allreduce", dest="hier_allreduce",
                      action="store_true", default=None,
                      help="local x cross hierarchical allreduce "
                           "(HOROVOD_HIERARCHICAL_ALLREDUCE)")
    hier.add_argument("--no-hierarchical-allreduce", dest="hier_allreduce",
                      action="store_false")
    hag = p.add_mutually_exclusive_group()
    hag.add_argument("--hierarchical-allgather", dest="hier_allgather",
                     action="store_true", default=None,
                     help="local then cross allgather "
                          "(HOROVOD_HIERARCHICAL_ALLGATHER)")
    hag.add_argument("--no-hierarchical-allgather", dest="hier_allgather",
                     action="store_false")
    p.add_argument("--timeline-filename", default=None,
                   help="Chrome-trace timeline path, written by rank 0 "
                        "(HOROVOD_TIMELINE)")
    p.add_argument("--timeline-mark-cycles", action="store_true",
                   help="mark the autotuner's sample boundaries on the "
                        "timeline (HOROVOD_TIMELINE_MARK_CYCLES)")
    p.add_argument("--autotune", action="store_true")
    p.add_argument("--autotune-log-file", default=None)
    p.add_argument("--autotune-warmup-samples", type=int, default=None)
    p.add_argument("--autotune-steps-per-sample", type=int, default=None)
    p.add_argument("--autotune-bayes-opt-max-samples", type=int,
                   default=None)
    p.add_argument("--autotune-gaussian-process-noise", type=float,
                   default=None)
    stall = p.add_mutually_exclusive_group()
    stall.add_argument("--no-stall-check", dest="no_stall_check",
                       action="store_true", default=None,
                       help="disable the stall inspector")
    stall.add_argument("--stall-check", dest="no_stall_check",
                       action="store_false",
                       help="not ported yet: ROADMAP A13")
    p.add_argument("--stall-check-warning-time-seconds", type=int,
                   default=None)
    p.add_argument("--stall-check-shutdown-time-seconds", type=int,
                   default=None)
    p.add_argument("--log-level", default=None,
                   choices=["TRACE", "DEBUG", "INFO", "WARNING", "ERROR",
                            "FATAL"])
    lts = p.add_mutually_exclusive_group()
    lts.add_argument("--log-with-timestamp", dest="log_hide_timestamp",
                     action="store_false", default=None)
    lts.add_argument("--log-without-timestamp", "--log-hide-timestamp",
                     dest="log_hide_timestamp", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--check-build", action="store_true",
                   help="show PyTorch, CUDA, NCCL/gloo, the CUDA kernels' "
                        "build and the visible GPUs, and exit")
    p.add_argument("--launcher", default="auto",
                   choices=["auto", "default", "mpi", "jsrun"],
                   help="process placer: 'auto' = built-in SSH launcher, "
                        "jsrun inside an LSF allocation; 'mpi' forces "
                        "mpirun")
    # horovodrun's controller aliases; mutually exclusive, as there.
    ctrl = p.add_mutually_exclusive_group()
    ctrl.add_argument("--gloo", dest="use_gloo", action="store_true",
                      help="alias for --launcher default")
    ctrl.add_argument("--mpi", dest="use_mpi", action="store_true",
                      help="alias for --launcher mpi")
    ctrl.add_argument("--jsrun", dest="use_jsrun", action="store_true",
                      help="alias for --launcher jsrun")
    p.add_argument("--mpi-args", default=None,
                   help="extra args passed through to mpirun")
    # Elastic (not ported yet: ROADMAP A10)
    p.add_argument("--host-discovery-script", default=None,
                   help="elastic mode: script printing 'host:slots' lines")
    p.add_argument("--min-np", "--min-num-proc", dest="min_num_proc",
                   type=int, default=None)
    p.add_argument("--max-np", "--max-num-proc", dest="max_num_proc",
                   type=int, default=None)
    p.add_argument("--slots-per-host", type=int, default=None)
    p.add_argument("--elastic-timeout", type=int, default=600)
    p.add_argument("--reset-limit", type=int, default=None)
    p.add_argument("--blacklist-cooldown-range", type=float, nargs=2,
                   default=None, metavar=("MIN", "MAX"),
                   help="seconds a failed host is excluded before retry")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command")
    return p


def args_to_env(args: argparse.Namespace) -> Dict[str, str]:
    """Flag → HOROVOD_* env (the JAX launcher's mapping, knob for knob)."""
    env: Dict[str, str] = {}
    if args.fusion_threshold_mb is not None:
        env[C.HOROVOD_FUSION_THRESHOLD] = str(
            args.fusion_threshold_mb * 1024 * 1024)
    if args.cycle_time_ms is not None:
        env[C.HOROVOD_CYCLE_TIME] = str(args.cycle_time_ms)
    if args.cache_capacity is not None:
        env[C.HOROVOD_CACHE_CAPACITY] = str(args.cache_capacity)
    if args.disable_cache:
        env[C.HOROVOD_CACHE_CAPACITY] = "0"
    if args.timeline_filename:
        env[C.HOROVOD_TIMELINE] = args.timeline_filename
    if args.timeline_mark_cycles:
        env[C.HOROVOD_TIMELINE_MARK_CYCLES] = "1"
    if args.autotune:
        env[C.HOROVOD_AUTOTUNE] = "1"
    if args.autotune_log_file:
        env[C.HOROVOD_AUTOTUNE_LOG] = args.autotune_log_file
    if args.autotune_warmup_samples is not None:
        env[C.HOROVOD_AUTOTUNE_WARMUP_SAMPLES] = \
            str(args.autotune_warmup_samples)
    if args.autotune_steps_per_sample is not None:
        env[C.HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE] = \
            str(args.autotune_steps_per_sample)
    if args.autotune_bayes_opt_max_samples is not None:
        env[C.HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES] = \
            str(args.autotune_bayes_opt_max_samples)
    if args.autotune_gaussian_process_noise is not None:
        env[C.HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE] = \
            str(args.autotune_gaussian_process_noise)
    if args.hier_allreduce is not None:
        env[C.HOROVOD_HIERARCHICAL_ALLREDUCE] = \
            "1" if args.hier_allreduce else "0"
    if args.hier_allgather is not None:
        env[C.HOROVOD_HIERARCHICAL_ALLGATHER] = \
            "1" if args.hier_allgather else "0"
    if args.no_stall_check is not None:
        env[C.HOROVOD_STALL_CHECK_DISABLE] = \
            "1" if args.no_stall_check else "0"
    if args.stall_check_warning_time_seconds is not None:
        env[C.HOROVOD_STALL_CHECK_TIME_SECONDS] = \
            str(args.stall_check_warning_time_seconds)
    if args.stall_check_shutdown_time_seconds is not None:
        env[C.HOROVOD_STALL_SHUTDOWN_TIME_SECONDS] = \
            str(args.stall_check_shutdown_time_seconds)
    if args.log_level:
        env[C.HOROVOD_LOG_LEVEL] = args.log_level
    if args.log_hide_timestamp is not None:
        env[C.HOROVOD_LOG_HIDE_TIME] = \
            "1" if args.log_hide_timestamp else "0"
    return env


def unported_flags(args: argparse.Namespace) -> List[str]:
    """The flags given whose subsystem the port does not have yet, each
    as "<flag> (ROADMAP <item>)"."""
    given = [
        ("--host-discovery-script", args.host_discovery_script, "A10"),
        ("--min-np", args.min_num_proc is not None, "A10"),
        ("--max-np", args.max_num_proc is not None, "A10"),
        ("--slots-per-host", args.slots_per_host is not None, "A10"),
        ("--reset-limit", args.reset_limit is not None, "A10"),
        ("--blacklist-cooldown-range",
         args.blacklist_cooldown_range is not None, "A10"),
        # elastic-only, with defaults: refused when set to anything else
        ("--elastic-timeout", args.elastic_timeout != 600, "A10"),
        ("--start-timeout", args.start_timeout != 600, "A10"),
        ("--stall-check", args.no_stall_check is False, "A13"),
        ("--stall-check-warning-time-seconds",
         args.stall_check_warning_time_seconds is not None, "A13"),
        ("--stall-check-shutdown-time-seconds",
         args.stall_check_shutdown_time_seconds is not None, "A13"),
    ]
    return [f"{flag} (ROADMAP {item})" for flag, on, item in given if on]


def apply_config_file(path: str, parser: argparse.ArgumentParser,
                      argv: List[str]) -> argparse.Namespace:
    """Re-parse argv with config-file values installed as parser
    defaults, so explicit CLI flags win in every spelling. Config keys
    use any flag spelling (dashes or underscores); a boolean flag's
    `spelling: true` means "as if the flag was passed"."""
    import yaml

    with open(path) as fh:
        data = yaml.safe_load(fh) or {}
    if not isinstance(data, dict):
        raise HorovodError(f"config file {path} must be a mapping")
    # flag spelling -> argparse action (covers dests that differ from the
    # spelling, and negated spellings whose store_false const inverts)
    spell_to_action = {}
    for action in parser._actions:
        for opt in action.option_strings:
            spell_to_action[opt.lstrip("-").replace("-", "_")] = action
    defaults = {}
    for key, value in data.items():
        action = spell_to_action.get(key.replace("-", "_"))
        if action is None:
            raise HorovodError(f"unknown config-file key {key!r}")
        if isinstance(action.const, bool) and action.nargs == 0:
            defaults[action.dest] = action.const if value \
                else (not action.const)
        else:
            defaults[action.dest] = value
    parser.set_defaults(**defaults)
    return parser.parse_args(argv)


def parse_hostfile(path: str) -> str:
    """'host slots=N' / 'host:N' / bare-host lines → 'h1:N,h2:M' spec;
    IPv6 literals bare ('fe80::2 slots=2') or bracketed ('[::1]:4')."""
    spec = []
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            mb = re.match(r"^\[([^\]]+)\](?::(\d+)| +slots=(\d+))?$", line)
            if mb:  # bracketed IPv6: [::1]:4 / [::1] slots=4
                host, c1, c2 = mb.groups()
            elif line.count(":") > 1:
                # bare IPv6 literal: the whole token is the host (a :N
                # suffix would be ambiguous); only ` slots=N` may follow
                m6 = re.match(r"^(\S+)( +slots=(\d+))?$", line)
                if not m6:
                    raise HorovodError(
                        f"malformed hostfile line: {raw!r}")
                host, c1, c2 = m6.group(1), None, m6.group(3)
            else:
                m = re.match(r"^(\S+?)(?::(\d+)| +slots=(\d+))?$", line)
                if not m:
                    raise HorovodError(
                        f"malformed hostfile line: {raw!r}")
                host, c1, c2 = m.groups()
            spec.append(f"{host}:{c1 or c2 or 1}")
    if not spec:
        raise HorovodError(f"hostfile {path} is empty")
    return ",".join(spec)


def _local_ip(interface: Optional[str] = None) -> str:
    if interface:
        try:
            import fcntl
            import struct
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            return socket.inet_ntoa(fcntl.ioctl(
                s.fileno(), 0x8915,  # SIOCGIFADDR
                struct.pack("256s", interface[:15].encode()))[20:24])
        except OSError:
            pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:  # a host name with no address: this host only
        return "127.0.0.1"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _is_local(hostname: str) -> bool:
    return hostname in ("localhost", "127.0.0.1", socket.gethostname(),
                        socket.getfqdn())


def _worker_pythonpath(existing: Optional[str]) -> str:
    """PYTHONPATH that lets workers import the launcher's
    horovod_tpu_torch: its parent directory first. A spawned `python
    train.py` has the script's directory, not the checkout root, as
    sys.path[0]."""
    import horovod_tpu_torch
    pkg_parent = os.path.dirname(
        os.path.dirname(os.path.abspath(horovod_tpu_torch.__file__)))
    parts = [pkg_parent]
    if existing:
        parts += [p for p in existing.split(os.pathsep) if p != pkg_parent]
    return os.pathsep.join(parts)


def _ssh_options(ssh_port: Optional[int] = None,
                 ssh_identity_file: Optional[str] = None) -> List[str]:
    """The one place SSH transport options are assembled (worker exec,
    staging mkdir, and the rsync -e transport all share it)."""
    cmd = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        cmd += ["-p", str(ssh_port)]
    if ssh_identity_file:
        cmd += ["-i", ssh_identity_file]
    return cmd


def ssh_command_prefix(hostname: str,
                       ssh_port: Optional[int] = None,
                       ssh_identity_file: Optional[str] = None) -> List[str]:
    return _ssh_options(ssh_port, ssh_identity_file) + [hostname]


def make_worker_cmd(slot: hosts_mod.SlotInfo, command: List[str],
                    base_env: Dict[str, str],
                    ssh_port: Optional[int] = None,
                    ssh_identity_file: Optional[str] = None,
                    remote_cwd: Optional[str] = None,
                    ) -> (List[str], Dict[str, str]):
    """(argv, env) of one worker: the command itself on this host, or an
    ssh command with the env inlined, shell-quoted, on a remote one."""
    env = dict(os.environ)
    env.update(base_env)
    env.update(slot.to_env())
    env["PYTHONPATH"] = _worker_pythonpath(env.get("PYTHONPATH"))
    if _is_local(slot.hostname):
        return list(command), env
    import shlex
    remote_env = {**base_env, **slot.to_env()}
    remote_env["PYTHONPATH"] = env["PYTHONPATH"]
    cwd = remote_cwd or os.getcwd()
    if remote_cwd:
        # Staged launch (--stage-dir): the staged dir must win imports.
        remote_env["PYTHONPATH"] = \
            remote_cwd + os.pathsep + env["PYTHONPATH"]
    env_str = " ".join(f"{k}={shlex.quote(str(v))}"
                       for k, v in remote_env.items())
    remote = (f"cd {shlex.quote(cwd)} && env {env_str} "
              + " ".join(shlex.quote(c) for c in command))
    return ssh_command_prefix(slot.hostname, ssh_port,
                              ssh_identity_file) + [remote], \
        dict(os.environ)


def stage_to_hosts(remote_hosts: List[str], stage_dir: str,
                   ssh_port: Optional[int] = None,
                   ssh_identity_file: Optional[str] = None,
                   src_dir: Optional[str] = None) -> None:
    """Sync `src_dir` (default: cwd) to `stage_dir` on every remote host,
    over the SSH options the workers use: rsync where available, scp -r
    otherwise. All hosts stage at once; any failure aborts the launch
    with the failing host named.
    """
    import shlex
    import shutil
    import subprocess

    src = os.path.abspath(src_dir or os.getcwd())
    ssh_cmd = _ssh_options(ssh_port, ssh_identity_file)
    use_rsync = shutil.which("rsync") is not None

    def drain(procs, what):
        """Wait on every transfer; on any failure terminate the rest and
        raise with the failing hosts named."""
        failures = []
        try:
            for host, proc in procs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"{host}: {err.strip()}")
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.terminate()
                    proc.communicate()
        if failures:
            raise HorovodError(
                f"--stage-dir {what} failed on " + "; ".join(failures))

    # mkdir -p first: rsync/scp into a missing parent fails with an error
    # naming the transport, not the problem.
    drain([(host, subprocess.Popen(
        ssh_cmd + [host, f"mkdir -p {shlex.quote(stage_dir)}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for host in remote_hosts], f"mkdir -p {stage_dir!r}")

    if not use_rsync:
        print(f"{PROG}: rsync not found; staging with scp -r — files "
              f"deleted locally will NOT be removed from previously staged "
              f"hosts (install rsync for exact re-stages)", file=sys.stderr)
    procs = []
    for host in remote_hosts:
        # '[host]': a bare IPv6 literal's colons would read as rsync
        # daemon-module / scp path syntax
        spec_host = f"[{host}]" if ":" in host else host
        if use_rsync:
            cmd = ["rsync", "-az", "--delete",
                   "-e", " ".join(shlex.quote(c) for c in ssh_cmd),
                   src + "/", f"{spec_host}:{stage_dir}/"]
        else:
            cmd = ["scp", "-o", "StrictHostKeyChecking=no", "-r"]
            if ssh_port:
                cmd += ["-P", str(ssh_port)]
            if ssh_identity_file:
                cmd += ["-i", ssh_identity_file]
            cmd += [src + "/.", f"{spec_host}:{stage_dir}/"]
        procs.append((host, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    drain(procs, "sync")


def _discover_coordinator_ip(remote_hosts: List[str],
                             job_secret: str) -> str:
    """SSH a NIC probe onto each remote host; return the launcher address
    all of them can reach (runner/network.py)."""
    import shlex
    import subprocess

    from horovod_tpu_torch.runner import network as net_mod
    from horovod_tpu_torch.runner import secret as secret_mod

    def ssh_probe(host: str, addrs: List[str], port: int):
        inner = (f"env {secret_mod.SECRET_ENV}={shlex.quote(job_secret)} "
                 f"{shlex.quote(sys.executable)} -m "
                 f"horovod_tpu_torch.runner.network "
                 f"{shlex.quote(','.join(addrs))} {port} "
                 f"{shlex.quote(host)}")
        return subprocess.Popen(["ssh", "-o", "StrictHostKeyChecking=no",
                                 host, inner])

    return net_mod.discover_common_address(
        remote_hosts, ssh_probe, secret=job_secret.encode(), timeout=60)


def launch_static(np: int, host_spec: str, command: List[str],
                  extra_env: Dict[str, str],
                  coordinator_ip: Optional[str] = None,
                  stdout=None,
                  ssh_port: Optional[int] = None,
                  ssh_identity_file: Optional[str] = None,
                  output_dir: Optional[str] = None,
                  prefix_timestamp: bool = False,
                  stage_dir: Optional[str] = None,
                  timeout: Optional[float] = None) -> int:
    """Spawn one worker per slot, wait, propagate failure. Returns 0, or
    the exit code of the failure that started it (a positive code first,
    then a signal death other than our SIGTERM as 128 + signum). With
    `timeout`, workers still running after that many seconds are
    terminated and TimeoutError is raised."""
    host_list = hosts_mod.parse_hosts(host_spec)
    slots = hosts_mod.get_host_assignments(host_list, np)

    # Per-job HMAC secret: control-plane writes are authenticated. A
    # pre-set HOROVOD_SECRET_KEY is honored.
    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.kv_ha import start_control_plane
    job_secret = secret_mod.job_secret_key()
    rdv = start_control_plane(job_secret.encode())
    try:
        ip = coordinator_ip or _local_ip()
        remote_hosts = sorted({s.hostname for s in slots
                               if not _is_local(s.hostname)})
        if stage_dir and remote_hosts:
            stage_to_hosts(remote_hosts, stage_dir, ssh_port=ssh_port,
                           ssh_identity_file=ssh_identity_file)
        if remote_hosts and coordinator_ip is None and \
                os.environ.get("HOROVOD_NIC_DISCOVERY", "1") == "1":
            # Probe which of our addresses every remote host reaches; on
            # failure fall back to the default-route address.
            try:
                ip = _discover_coordinator_ip(remote_hosts, job_secret)
            except Exception as e:
                print(f"{PROG}: NIC discovery failed ({e}); using {ip}",
                      file=sys.stderr)
        base_env = dict(extra_env)
        base_env.update(rdv.worker_env(ip))
        base_env.update({
            C.HOROVOD_CONTROLLER: CONTROLLER,
            secret_mod.SECRET_ENV: job_secret,
        })
        # One host: the launcher picks the torch.distributed coordinator
        # (rank 0 binds it). Across hosts rank 0 picks a port on its own
        # host and publishes it through the KV (core/topology.py).
        if all(_is_local(s.hostname) for s in slots):
            base_env[C.HOROVOD_COORDINATOR_ADDR] = f"{ip}:{_free_port()}"

        workers = []
        codes: List[int] = []
        try:
            for slot in slots:
                cmd, env = make_worker_cmd(
                    slot, command, base_env, ssh_port=ssh_port,
                    ssh_identity_file=ssh_identity_file,
                    remote_cwd=stage_dir)
                logfile = None
                if output_dir:
                    d = os.path.join(output_dir, f"rank.{slot.rank}")
                    os.makedirs(d, exist_ok=True)
                    logfile = os.path.join(d, "stdout")
                workers.append(safe_exec.WorkerProcess(
                    slot.rank, cmd, env, stdout=stdout, logfile=logfile,
                    timestamp=prefix_timestamp))
            codes = safe_exec.wait_all(workers, timeout=timeout)
        finally:
            for w in workers:
                w.terminate()
    finally:
        # The workers' perfscope summaries live only in this KV: write
        # them out before it goes (HOROVOD_FLIGHT_DIR, when set).
        from horovod_tpu_torch.profiler import perfscope
        perfscope.persist_kv_summaries(rdv)
        rdv.stop()
    bad = [(i, c) for i, c in enumerate(codes) if c != 0]
    if bad:
        print(f"{PROG}: workers failed: {bad}", file=sys.stderr)
        # Report the originating failure, not the -SIGTERM of siblings we
        # killed in response.
        real = [c for _, c in bad if c > 0]
        if real:
            return real[0]
        signaled = [c for _, c in bad if c < 0 and c != -signal.SIGTERM]
        if signaled:
            return 128 - signaled[0]
        return 128 + signal.SIGTERM
    return 0


def check_build() -> int:
    """What this installation can do (horovodrun --check-build): PyTorch
    and its CUDA, NCCL and gloo, nvcc and the CUDA kernels built under
    horovod_tpu_torch/_build/, and the visible GPUs by name."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch
    from horovod_tpu_torch import kernels
    from horovod_tpu_torch.common.exceptions import KernelError

    def mark(ok: bool) -> str:
        return "[X]" if ok else "[ ]"

    print(f"horovod-tpu-torch v{horovod_tpu_torch.__version__}:\n")
    print("Available Frontends:")
    print(f"    {mark(True)} PyTorch {torch.__version__} "
          f"(CUDA {torch.version.cuda or 'none'})")
    print("\nAvailable Controllers:")
    print(f"    {mark(True)} torch.distributed + rendezvous KV")
    print("\nAvailable Tensor Operations:")
    print(f"    {mark(dist.is_nccl_available())} NCCL")
    print(f"    {mark(dist.is_gloo_available())} gloo")
    try:
        nvcc = kernels._nvcc()
    except KernelError:
        nvcc = None
    print(f"\nCUDA kernels ({kernels.BUILD_DIR}):")
    print(f"    {mark(nvcc is not None)} nvcc {nvcc or 'not found'}")
    for name in kernels.SOURCES:
        built = os.path.exists(kernels._target(name))
        print(f"    {mark(built)} {name} "
              f"{'built' if built else 'not built'}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    print(f"\nDevices: {n} GPU(s)" + (f": {', '.join(names)}" if n else ""))
    return 0


def run_commandline(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    cli_hosts, cli_hostfile = args.hosts, args.hostfile
    if args.config_file:
        args = apply_config_file(
            args.config_file, parser,
            list(argv) if argv is not None else sys.argv[1:])
        # an explicitly passed host source beats the config file's
        if cli_hosts and not cli_hostfile:
            args.hostfile = None
        elif cli_hostfile and not cli_hosts:
            args.hosts = None
    if args.check_build:
        return check_build()
    unported = unported_flags(args)
    if unported:
        raise HorovodError(
            f"{PROG}: not ported to PyTorch yet: {', '.join(unported)}")
    # controller aliases → --launcher (an alias may not contradict an
    # explicit --launcher)
    alias = ("mpi" if args.use_mpi else "jsrun" if args.use_jsrun
             else "default" if args.use_gloo else None)
    if alias is not None:
        if args.launcher not in ("auto", alias):
            print(f"{PROG}: --launcher {args.launcher} contradicts the "
                  f"--{alias if alias != 'default' else 'gloo'} "
                  f"controller flag", file=sys.stderr)
            return 2
        args.launcher = alias
    if args.hostfile:
        if args.hosts:
            print(f"{PROG}: pass -H or --hostfile, not both",
                  file=sys.stderr)
            return 2
        args.hosts = parse_hostfile(args.hostfile)
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("no training command given", file=sys.stderr)
        return 2

    np = args.num_proc
    hosts = args.hosts
    if hosts is None and np is None and _prefer_jsrun():
        # Inside an LSF allocation with no explicit sizing: the job is the
        # allocation.
        from horovod_tpu_torch.runner.js_run import lsf_hosts
        alloc = lsf_hosts()
        if alloc:
            np = sum(alloc.values())
            hosts = ",".join(f"{h}:{s}" for h, s in sorted(alloc.items()))
    if hosts is None:
        hosts = f"localhost:{np or 1}"
    if np is None:
        np = sum(h.slots for h in hosts_mod.parse_hosts(hosts))

    launcher = args.launcher
    if launcher in ("mpi", "jsrun") or (launcher == "auto"
                                        and args.hosts is None
                                        and _prefer_jsrun()):
        # flags only the built-in launcher implements
        dropped = [f for f, v in (
            ("--output-filename", args.output_filename),
            ("--ssh-port", args.ssh_port),
            ("--ssh-identity-file", args.ssh_identity_file),
            ("--prefix-output-with-timestamp", args.prefix_timestamp),
            ("--stage-dir", args.stage_dir),
        ) if v]
        if dropped:
            print(f"{PROG}: {', '.join(dropped)} only apply to the "
                  f"built-in launcher; ignored under "
                  f"{'mpirun' if launcher == 'mpi' else 'jsrun'} "
                  f"(use the placer's own redirection/ssh options)",
                  file=sys.stderr)
    if launcher == "mpi":
        import shlex

        from horovod_tpu_torch.runner.mpi_run import mpi_run
        nics = [n.strip() for n in args.network_interface.split(",")
                if n.strip()] if args.network_interface else None
        return mpi_run(np, hosts, command, args_to_env(args), nics=nics,
                       extra_flags=shlex.split(args.mpi_args)
                       if args.mpi_args else None)
    # auto picks jsrun only when -H did not pin placement
    if launcher == "jsrun" or (launcher == "auto" and args.hosts is None
                               and _prefer_jsrun()):
        from horovod_tpu_torch.runner.js_run import js_run
        return js_run(np, command, args_to_env(args))
    return launch_static(np, hosts, command, args_to_env(args),
                         coordinator_ip=_local_ip(
                             args.network_interface.split(",")[0].strip())
                         if args.network_interface else None,
                         ssh_port=args.ssh_port,
                         ssh_identity_file=args.ssh_identity_file,
                         output_dir=args.output_filename,
                         prefix_timestamp=args.prefix_timestamp,
                         stage_dir=args.stage_dir)


def _prefer_jsrun() -> bool:
    from horovod_tpu_torch.runner.js_run import is_lsf_env, js_available
    return is_lsf_env() and js_available()


def _exit_on_sigterm(signum, frame):
    # SystemExit unwinds launch_static, whose finally terminates every
    # worker's process group.
    raise SystemExit(128 + signum)


def main() -> None:
    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    try:
        rc = run_commandline()
    except HorovodError as e:
        print(e, file=sys.stderr)
        rc = 2
    sys.exit(rc)


if __name__ == "__main__":
    main()
