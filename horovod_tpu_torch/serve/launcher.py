"""Elastic serving launcher: `python -m horovod_tpu_torch.serve`
(counterpart of horovod_tpu/serve/launcher.py). Each replica is one
process on `cuda:<local_rank>`.

The serving sibling of `elastic/driver.run_elastic`: one process hosts
the rendezvous KV, the ElasticDriver (spawning REPLICA worker
processes from the user's command), and the serving data path
(frontend → continuous batcher → replica pool). Replicas are
data-parallel and independent, so — unlike training — no
torch.distributed world and no RoundPublisher is needed: a round is just
"which replica processes exist", and the pool adopts registrations as
they appear.

    python -m horovod_tpu_torch.serve \
        --host-discovery-script ./discover.sh --slots-per-host 1 \
        -- python my_replica.py

Lifecycle: serve until an authenticated client sends ``shutdown`` to
the frontend; then drain (flush the queue, wait for in-flight batches),
publish ``serve/shutdown`` so replicas exit 0, and let the elastic loop
observe the unanimous clean exit. Replica death mid-load is handled by
the pool (requeue onto survivors) + the driver (blacklist, respawn on
rejoin) — an accepted request is never dropped.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
from typing import Dict, List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve",
        description="Elastic fault-tolerant inference service, one "
                    "replica process per GPU")
    p.add_argument("--host-discovery-script", required=True,
                   help="script printing 'host:slots' lines (the elastic "
                        "replica set)")
    p.add_argument("--slots-per-host", type=int, default=None)
    p.add_argument("--min-np", "--min-num-proc", dest="min_num_proc",
                   type=int, default=None,
                   help="minimum replicas to start serving")
    p.add_argument("--max-np", "--max-num-proc", dest="max_num_proc",
                   type=int, default=None)
    p.add_argument("--elastic-timeout", type=int, default=600)
    p.add_argument("--reset-limit", type=int, default=None)
    p.add_argument("--blacklist-cooldown-range", type=float, nargs=2,
                   default=None, metavar=("MIN", "MAX"))
    p.add_argument("--port", type=int, default=None,
                   help="frontend port (default: HOROVOD_SERVE_PORT or "
                        "OS-assigned; announced via "
                        "HOROVOD_SERVE_PORT_FILE)")
    p.add_argument("--output-filename", default=None,
                   help="directory for per-replica logs")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="replica command (a script calling "
                        "serve_replica)")
    return p


def run_serve(args, command: List[str],
              extra_env: Optional[Dict[str, str]] = None) -> int:
    """Serving main loop (mirrors elastic/driver.run_elastic)."""
    from horovod_tpu_torch.common import config as C
    from horovod_tpu_torch.elastic.discovery import (HostDiscoveryScript,
                                                     HostManager)
    from horovod_tpu_torch.elastic.driver import (ElasticDriver,
                                                  drive_elastic_loop)
    from horovod_tpu_torch.observability import flight, tracing, watch
    from horovod_tpu_torch.profiler import perfscope
    from horovod_tpu_torch.runner import safe_exec
    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.hosts import SlotInfo
    from horovod_tpu_torch.runner.kv_ha import start_control_plane
    from horovod_tpu_torch.runner.launch import _local_ip, make_worker_cmd
    from horovod_tpu_torch.serve.batching import ContinuousBatcher
    from horovod_tpu_torch.serve.frontend import Frontend
    from horovod_tpu_torch.serve.pool import ReplicaPool
    from horovod_tpu_torch.serve.telemetry import preregister_metrics

    extra_env = dict(extra_env or {})
    cooldown = getattr(args, "blacklist_cooldown_range", None)
    hm = HostManager(
        HostDiscoveryScript(args.host_discovery_script,
                            default_slots=args.slots_per_host or 1),
        cooldown_range=tuple(cooldown) if cooldown else None)
    # Honor a pre-set job secret (job_secret_key) so external clients
    # can authenticate against the frontend.
    job_secret = secret_mod.job_secret_key()
    # Plain in-process server, or (HOROVOD_KV_REPLICAS>1) the replicated
    # control plane with epoch-fenced failover (runner/kv_ha.py).
    rdv = start_control_plane(job_secret.encode())
    ip = _local_ip()

    preregister_metrics()
    batcher = ContinuousBatcher()
    frontend = Frontend(batcher, secret=job_secret.encode(),
                        port=getattr(args, "port", None))
    front_port = frontend.start()
    pool = ReplicaPool(rdv, batcher, secret=job_secret.encode())
    pool.start()
    print(f"serve: frontend on :{front_port} "
          f"(max_batch={batcher.max_batch}, "
          f"buckets={list(batcher.buckets)}, "
          f"max_wait={batcher.max_wait_s * 1e3:.0f}ms)", flush=True)
    flight.record("serve", f"launcher: frontend UP port={front_port}")

    def spawn(slot: SlotInfo, round_id: int):
        env = dict(extra_env)
        env.update(rdv.worker_env(ip))
        env.update({
            secret_mod.SECRET_ENV: job_secret,
            "HOROVOD_ELASTIC_ROUND": str(round_id),
        })
        cmd, full_env = make_worker_cmd(slot, command, env)
        logfile = None
        out_dir = getattr(args, "output_filename", None)
        if out_dir:
            d = os.path.join(out_dir, f"rank.{slot.rank}")
            os.makedirs(d, exist_ok=True)
            logfile = os.path.join(d, f"stdout.r{round_id}")
        return safe_exec.WorkerProcess(slot.rank, cmd, full_env,
                                       logfile=logfile)

    driver = ElasticDriver(
        hm, spawn, lambda h: h.terminate(),
        min_num_proc=args.min_num_proc or 1,
        max_num_proc=args.max_num_proc,
        reset_limit=args.reset_limit,
        publish_fn=None)

    # Drain watcher: an authenticated `shutdown` request starts the
    # drain; once the queue and the in-flight batches are empty the
    # replicas are released (they exit 0 and the elastic loop returns).
    def _drain_watcher() -> None:
        frontend.drain_requested.wait()
        flight.record("serve", "launcher: drain requested")
        import time as _t
        while not pool.idle():
            _t.sleep(0.05)
        pool.publish_shutdown()
        flight.record("serve", "launcher: drained; replicas released")

    threading.Thread(target=_drain_watcher, name="hvd-serve-drain",
                     daemon=True).start()

    driver.start()
    rc = 1
    try:
        rc = drive_elastic_loop(driver, args.elastic_timeout)
        return rc
    finally:
        frontend.stop()
        pool.stop()
        # Same exit contract as the training launchers: persist the
        # flight tails + perfscope summaries the replicas pushed before
        # the KV disappears, then point the operator at the doctor.
        tails = flight.persist_kv_tails(rdv)
        perfscope.persist_kv_summaries(rdv)
        watch.persist_kv_records(rdv)
        tracing.persist_kv_spans(rdv)
        flight.dump("serve_exit", push_kv=False)
        tracing.dump("serve_exit", push_kv=False)
        flight_dir = os.environ.get(flight.FLIGHT_DIR_ENV, "")
        if rc != 0 and flight_dir and (
                tails or os.path.isdir(flight_dir)):
            print(f"serve: flight-recorder dumps are in {flight_dir}; "
                  f"merge them with `python -m "
                  f"horovod_tpu_torch.observability.doctor --dir {flight_dir}`",
                  file=sys.stderr)
        rdv.stop()


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("serve: no replica command given", file=sys.stderr)
        return 2
    return run_serve(args, command)


if __name__ == "__main__":
    sys.exit(main())
