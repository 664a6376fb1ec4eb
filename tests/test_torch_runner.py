"""The PyTorch package's launcher against the JAX package's, on the CPU.

Each test takes the same inputs through `horovod_tpu.runner.*` and
`horovod_tpu_torch.runner.*` and requires the same outputs: host
parsing and slot assignment, the flag → env mapping, the parser's flag
set, hostfiles (IPv6 literals included), the config-file merge, the
controller-alias conflicts, the SSH command, --stage-dir staging, the
mpirun and jsrun command shapes, the rank taken from the MPI env, the
HMAC digest, the retry schedule, the NIC probe frames, and the
rendezvous KV in both directions (each package's client against the
other's server, with a secret, and an unsigned write rejected). Then
what the port refuses: the flags whose subsystem is not ported yet, a
replicated control plane, a client given several endpoints.
"""

import os
import threading
import urllib.error
from unittest import mock

import pytest

from horovod_tpu.common import config as JC
from horovod_tpu.common import resilience as jres
from horovod_tpu.common.exceptions import HorovodTpuError
from horovod_tpu.runner import hosts as jhosts
from horovod_tpu.runner import js_run as jjs
from horovod_tpu.runner import launch as jlaunch
from horovod_tpu.runner import mpi_run as jmpi
from horovod_tpu.runner import network as jnet
from horovod_tpu.runner import rendezvous as jrdv
from horovod_tpu.runner import secret as jsecret
from horovod_tpu_torch.common import config as TC
from horovod_tpu_torch.common import hvd_logging as tlog
from horovod_tpu_torch.common import resilience as tres
from horovod_tpu_torch.common.exceptions import (
    CircuitOpenError, HorovodError, RetryError,
)
from horovod_tpu_torch.runner import hosts as thosts
from horovod_tpu_torch.runner import js_run as tjs
from horovod_tpu_torch.runner import kv_ha as tkv_ha
from horovod_tpu_torch.runner import launch as tlaunch
from horovod_tpu_torch.runner import mpi_run as tmpi
from horovod_tpu_torch.runner import network as tnet
from horovod_tpu_torch.runner import rendezvous as trdv
from horovod_tpu_torch.runner import secret as tsecret

# Flags of the JAX launcher that the port's parser leaves out: none.
DEFERRED_DESTS: set = set()

# One argv that sets every flag args_to_env maps.
EVERY_MAPPED = [
    "-np", "2", "--fusion-threshold-mb", "32", "--cycle-time-ms", "3.5",
    "--cache-capacity", "512", "--timeline-filename", "/tmp/tl.json",
    "--timeline-mark-cycles", "--autotune", "--autotune-log-file",
    "/tmp/at.csv", "--autotune-warmup-samples", "4",
    "--autotune-steps-per-sample", "7", "--autotune-bayes-opt-max-samples",
    "11", "--autotune-gaussian-process-noise", "0.3",
    "--hierarchical-allreduce", "--hierarchical-allgather",
    "--no-stall-check", "--stall-check-warning-time-seconds", "9",
    "--stall-check-shutdown-time-seconds", "99", "--log-level", "DEBUG",
    "--log-without-timestamp", "--", "python", "x.py"]


def _slots(mod, spec, np):
    return [(s, s.to_env()) for s in mod.get_host_assignments(
        mod.parse_hosts(spec), np)]


# ----------------------------------------------------------------- hosts

@pytest.mark.parametrize("spec", ["a:4, b:2,c", "h1:4,h2:4", "localhost:2",
                                  "::1:4,fe80::2:2"])
def test_parse_hosts_matches_jax(spec):
    want = [(h.hostname, h.slots) for h in jhosts.parse_hosts(spec)]
    assert [(h.hostname, h.slots) for h in thosts.parse_hosts(spec)] == want


@pytest.mark.parametrize("spec", ["a:zero", "a:0", ""])
def test_parse_hosts_rejects_what_jax_rejects(spec):
    with pytest.raises(HorovodTpuError):
        jhosts.parse_hosts(spec)
    with pytest.raises(HorovodError):
        thosts.parse_hosts(spec)


@pytest.mark.parametrize("spec,np", [("a:2,b:2", 4), ("a:2,b:1", 3),
                                     ("a:4,b:4", 5), ("localhost:1", 1)])
def test_host_assignments_match_jax(spec, np):
    want = [(vars(s), e) for s, e in _slots(jhosts, spec, np)]
    assert [(vars(s), e) for s, e in _slots(thosts, spec, np)] == want


def test_host_assignments_overflow_raises_in_both():
    with pytest.raises(HorovodTpuError):
        jhosts.get_host_assignments(jhosts.parse_hosts("a:2"), 3)
    with pytest.raises(HorovodError):
        thosts.get_host_assignments(thosts.parse_hosts("a:2"), 3)


# ----------------------------------------------------------- flags → env

@pytest.mark.parametrize("argv", [
    EVERY_MAPPED,
    ["-np", "1", "--disable-cache", "x"],
    ["-np", "1", "--no-hierarchical-allreduce",
     "--no-hierarchical-allgather", "--stall-check", "--log-with-timestamp",
     "x"],
    ["-np", "1", "x"],
])
def test_args_to_env_matches_jax(argv):
    want = jlaunch.args_to_env(jlaunch.build_parser().parse_args(argv))
    got = tlaunch.args_to_env(tlaunch.build_parser().parse_args(argv))
    assert got == want
    if argv is EVERY_MAPPED:
        assert len(got) == 18


def test_parser_has_the_jax_flags():
    def flags(parser):
        return {a.dest: tuple(a.option_strings) for a in parser._actions
                if a.dest != "help"}
    want, got = flags(jlaunch.build_parser()), flags(tlaunch.build_parser())
    assert len(want) == 46 and sum(1 for o in want.values() if o) == 45
    assert set(got) == set(want) - DEFERRED_DESTS
    for dest in got:
        assert got[dest] == want[dest], dest
    n_flags = sum(len(a.option_strings) > 0 for a in
                  tlaunch.build_parser()._actions if a.dest != "help")
    assert n_flags + 1 == 50  # 49 flags and the command


def test_hostfile_ipv6_literals_match_jax(tmp_path):
    f = tmp_path / "hosts"
    f.write_text("[::1]:4\n::1\nfe80::2 slots=2\nh1 slots=3\nh2:2\nh3\n"
                 "# comment\n")
    assert tlaunch.parse_hostfile(str(f)) == jlaunch.parse_hostfile(str(f))
    assert tlaunch.parse_hostfile(str(f)).startswith("::1:4,::1:1,fe80::2:2")
    bad = tmp_path / "bad"
    bad.write_text("fe80::2 junk\n")
    with pytest.raises(HorovodTpuError):
        jlaunch.parse_hostfile(str(bad))
    with pytest.raises(HorovodError):
        tlaunch.parse_hostfile(str(bad))


def test_config_file_merge_matches_jax_and_cli_wins(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("fusion-threshold-mb: 8\nlog_level: INFO\n"
                   "stall-check: true\nnum-proc: 3\n")
    argv = ["--config-file", str(cfg), "--fusion-threshold-mb=16", "--",
            "python", "t.py"]
    want = jlaunch.apply_config_file(str(cfg), jlaunch.build_parser(), argv)
    got = tlaunch.apply_config_file(str(cfg), tlaunch.build_parser(), argv)
    assert vars(got) == vars(want)
    assert got.fusion_threshold_mb == 16 and got.num_proc == 3
    assert got.no_stall_check is False and got.log_level == "INFO"


def test_controller_alias_conflicts_as_in_jax():
    for mod in (jlaunch, tlaunch):
        with pytest.raises(SystemExit):
            mod.build_parser().parse_args(["-np", "1", "--mpi", "--gloo",
                                           "x"])
        assert mod.run_commandline(["-np", "1", "--launcher", "mpi",
                                    "--gloo", "--", "true"]) == 2


def test_ssh_command_matches_jax():
    kw = dict(hostname="remotehost", rank=1, size=2, local_rank=0,
              local_size=1, cross_rank=1, cross_size=2)
    base = {"HOROVOD_X": "a b"}
    want, _ = jlaunch.make_worker_cmd(jhosts.SlotInfo(**kw), ["python",
                                                              "t.py"], base,
                                      ssh_port=2222,
                                      ssh_identity_file="/k.pem",
                                      remote_cwd="/scratch/job")
    got, _ = tlaunch.make_worker_cmd(thosts.SlotInfo(**kw), ["python",
                                                             "t.py"], base,
                                     ssh_port=2222,
                                     ssh_identity_file="/k.pem",
                                     remote_cwd="/scratch/job")
    # Both packages live in one checkout, so even PYTHONPATH agrees.
    assert got == want
    assert got[:7] == ["ssh", "-o", "StrictHostKeyChecking=no", "-p",
                       "2222", "-i", "/k.pem"]
    assert "'a b'" in got[-1]


def _stub_bin(tmp_path, name, log):
    """Executable stub that appends its argv to `log` and exits 0."""
    p = tmp_path / "bin" / name
    p.parent.mkdir(exist_ok=True)
    p.write_text(f"#!/bin/sh\necho \"{name} $@\" >> {log}\n")
    p.chmod(0o755)


def test_stage_to_hosts_matches_jax(tmp_path, monkeypatch):
    log = tmp_path / "calls.log"
    for name in ("ssh", "rsync"):
        _stub_bin(tmp_path, name, log)
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    src = tmp_path / "proj"
    src.mkdir()
    calls = []
    for mod in (jlaunch, tlaunch):
        mod.stage_to_hosts(["h1", "h2"], "/scratch/job", ssh_port=2222,
                           ssh_identity_file="/k.pem", src_dir=str(src))
        calls.append(sorted(log.read_text().splitlines()))
        log.unlink()
    assert calls[0] == calls[1]
    assert sum(c.startswith("rsync ") for c in calls[1]) == 2
    assert all("-p 2222" in c for c in calls[1])


# ------------------------------------------------------------ mpi, jsrun

@pytest.mark.parametrize("impl", ["OpenMPI", "SpectrumMPI", "MPICH",
                                  "IntelMPI"])
def test_mpirun_command_matches_jax(impl):
    args = (4, "h1:2,h2:2", ["python", "train.py"])
    kw = dict(env={"HOROVOD_SIZE": "4", "HOROVOD_SECRET_KEY": "s3cret"},
              implementation=impl, nics=["eth0", "eth1"],
              extra_flags=["--map-by", "ppr:4:socket"])
    got = tmpi.build_mpirun_command(*args, **kw)
    assert got == jmpi.build_mpirun_command(*args, **kw)
    assert "s3cret" not in " ".join(got)


@pytest.mark.parametrize("output", ["mpirun (Open MPI) 4.1.4",
                                    "IBM Spectrum MPI 10.3",
                                    "Intel(R) MPI Library 2021",
                                    "MPICH Version: 4.0", "Exotic MPI"])
def test_mpi_flavour_detection_matches_jax(output):
    def fake(env):
        return output, 0
    assert tmpi.detect_mpi_implementation(_exec=fake) == \
        jmpi.detect_mpi_implementation(_exec=fake)


def test_jsrun_command_and_lsf_hosts_match_jax():
    kw = dict(env={"HOROVOD_SIZE": "8"}, gpus_per_rs=1, cpus_per_rs=4)
    assert tjs.build_jsrun_command(8, ["python", "t.py"], **kw) == \
        jjs.build_jsrun_command(8, ["python", "t.py"], **kw)
    for env in ({"LSB_MCPU_HOSTS": "batch1 1 c1 16 c2 16"},
                {"LSB_HOSTS": "c1 c1 c2"}, {}):
        assert tjs.lsf_hosts(env=env) == jjs.lsf_hosts(env=env)


def test_mpi_launcher_exports_the_port_controller(monkeypatch):
    seen = {}

    def fake_run(cmd, env=None):
        seen["cmd"], seen["env"] = cmd, env

        class R:
            returncode = 0
        return R()

    monkeypatch.setattr(tmpi, "detect_mpi_implementation",
                        lambda env=None, _exec=None: tmpi.OMPI)
    monkeypatch.setattr(tmpi.subprocess, "run", fake_run)
    rc = tlaunch.run_commandline(["--launcher", "mpi", "-np", "2", "-H",
                                  "localhost:2", "--", "python", "-c",
                                  "pass"])
    assert rc == 0 and seen["cmd"][0] == "mpirun"
    env = seen["env"]
    assert env[TC.HOROVOD_CONTROLLER] == "torch"
    assert env["HOROVOD_MPI_RANK_ENV"] == "OMPI_COMM_WORLD_RANK"
    assert env["HOROVOD_SIZE"] == "2"
    assert env[TC.HOROVOD_RENDEZVOUS_ADDR] and env["HOROVOD_SECRET_KEY"]
    assert "-x" in seen["cmd"] and env["HOROVOD_SECRET_KEY"] not in \
        " ".join(seen["cmd"])


@pytest.mark.parametrize("env,want", [
    ({"HOROVOD_MPI_RANK_ENV": "OMPI_COMM_WORLD_RANK",
      "OMPI_COMM_WORLD_RANK": "3",
      "HOROVOD_MPI_LOCAL_RANK_ENV": "OMPI_COMM_WORLD_LOCAL_RANK",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1"}, (3, 1)),
    ({"HOROVOD_RANK": "0", "HOROVOD_MPI_RANK_ENV": "PMI_RANK",
      "PMI_RANK": "5"}, (0, None)),
    ({"HOROVOD_MPI_RANK_ENV": "PMI_RANK", "PMI_RANK": "2",
      "HOROVOD_LOCAL_RANK": "0"}, (2, 0)),
])
def test_rank_from_mpi_env_matches_jax(monkeypatch, env, want):
    for k in ("HOROVOD_RANK", "HOROVOD_LOCAL_RANK", "HOROVOD_MPI_RANK_ENV",
              "HOROVOD_MPI_LOCAL_RANK_ENV"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j, t = JC.Config.from_env(), TC.Config.from_env()
    assert (t.rank, t.local_rank) == (j.rank, j.local_rank) == want


# ------------------------------------------------------ secret, retries

@pytest.mark.parametrize("method,path,body", [
    ("PUT", "/scope/key", b"hello"), ("GET", "/torch_coordinator/r0", b""),
    ("DELETE", "/a/b", b""), ("PUT", "/x/y", bytes(range(256)))])
def test_digest_equals_jax_byte_for_byte(method, path, body):
    secret = bytes.fromhex(tsecret.make_secret_key())
    got = tsecret.compute_digest(secret, method, path, body)
    assert got == jsecret.compute_digest(secret, method, path, body)
    assert jsecret.check_digest(secret, method, path, body, got)
    assert not tsecret.check_digest(secret, method, path, body + b"x", got)


def test_retry_schedule_matches_jax():
    import random
    kw = dict(max_attempts=6, base_delay=0.05, max_delay=0.3, jitter=0.5)
    got = list(tres.RetryPolicy(**kw).delays(random.Random(7)))
    assert got == list(jres.RetryPolicy(**kw).delays(random.Random(7)))
    assert len(got) == 5


def test_retry_policy_bounds_and_breaker():
    calls = []

    def flaky():
        calls.append(1)
        raise ConnectionRefusedError("down")

    pol = tres.RetryPolicy(max_attempts=3, base_delay=0.001, jitter=0.0)
    with pytest.raises(RetryError) as ei:
        pol.call(flaky)
    assert len(calls) == 3
    assert isinstance(ei.value.__cause__, ConnectionRefusedError)
    with pytest.raises(ValueError):  # not transient: no retry
        pol.call(lambda: (_ for _ in ()).throw(ValueError("x")))

    now = [0.0]
    br = tres.CircuitBreaker(failure_threshold=2, recovery_timeout=10,
                             clock=lambda: now[0])
    for _ in range(2):
        with pytest.raises(ConnectionError):
            br.call(flaky)
    assert br.state == "open"
    with pytest.raises(CircuitOpenError):
        br.call(flaky)
    now[0] = 11.0
    assert br.call(lambda: 5) == 5 and br.state == "closed"


def test_kv_retry_policy_reads_its_env(monkeypatch):
    monkeypatch.setenv("HOROVOD_KV_RETRY_MAX_ATTEMPTS", "3")
    monkeypatch.setenv("HOROVOD_KV_RETRY_DEADLINE", "0")
    got, want = tres.kv_retry_policy(), jres.kv_retry_policy()
    assert (got.max_attempts, got.deadline, got.max_delay) == \
        (want.max_attempts, want.deadline, want.max_delay) == (3, None, 1.0)


def test_log_lines_carry_the_rank_prefix(monkeypatch, capsys):
    monkeypatch.setenv("HOROVOD_LOG_LEVEL", "info")
    monkeypatch.setenv("HOROVOD_LOG_HIDE_TIME", "1")
    tlog.reset_for_tests()
    try:
        tlog.get_logger().info("hello")
    finally:
        tlog.reset_for_tests()
    assert "[INFO | rank -] hello" in capsys.readouterr().err


# ------------------------------------------------------- NIC probe frames

@pytest.mark.parametrize("svc_mod,probe_mod", [(tnet, jnet), (jnet, tnet)],
                         ids=["jax-probe-to-port", "port-probe-to-jax"])
def test_nic_probe_frames_interoperate(svc_mod, probe_mod):
    secret = bytes.fromhex(tsecret.make_secret_key())
    svc = svc_mod.NicProbeService(expected_hosts=1, secret=secret)
    port = svc.start()
    try:
        t = threading.Thread(target=probe_mod.probe_main,
                             args=(["127.0.0.1"], port),
                             kwargs={"hostname": "h0", "secret": secret,
                                     "timeout": 5})
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert set(svc.wait(timeout=10)) == {"h0"}
        assert svc.common_launcher_addresses(["127.0.0.1", "10.9.9.9"]) == \
            ["127.0.0.1"]
    finally:
        svc.stop()


# ---------------------------------------------------------- rendezvous

@pytest.mark.parametrize("server_mod,client_mod", [(jrdv, trdv),
                                                   (trdv, jrdv)],
                         ids=["port-client-to-jax-server",
                              "jax-client-to-port-server"])
def test_rendezvous_interoperates_with_a_secret(server_mod, client_mod):
    secret = bytes.fromhex(tsecret.make_secret_key())
    srv = server_mod.RendezvousServer(secret=secret)
    port = srv.start()
    try:
        kv = client_mod.KVClient("127.0.0.1", port, secret=secret)
        kv.put("scope", "key", b"hello")
        assert kv.get("scope", "key") == b"hello"
        assert srv.get("scope", "key") == b"hello"
        srv.put("s2", "k2", b"x")
        assert kv.get("s2", "k2") == b"x"
        assert kv.get("nope", "nothing", timeout=0.2) is None
        kv.delete("scope", "key")
        assert srv.get("scope", "key") is None
        for bad in (client_mod.KVClient("127.0.0.1", port, secret=None),
                    client_mod.KVClient("127.0.0.1", port,
                                        secret=b"another key")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                bad.put("scope", "evil", b"x")
            assert ei.value.code == 403
        assert srv.get("scope", "evil") is None
    finally:
        srv.stop()


def test_worker_env_names_match_jax():
    srv = trdv.RendezvousServer()
    srv.start()
    try:
        assert set(srv.worker_env("10.0.0.1")) == {
            JC.HOROVOD_RENDEZVOUS_ADDR, JC.HOROVOD_RENDEZVOUS_PORT}
        assert srv.worker_env("10.0.0.1")[TC.HOROVOD_RENDEZVOUS_PORT] == \
            str(srv.port)
    finally:
        srv.stop()


# ------------------------------------------------------- what is refused

@pytest.mark.parametrize("flags,item", [
    (["--host-discovery-script", "d.sh"], "A10"),
    (["--min-np", "2"], "A10"),
    (["--blacklist-cooldown-range", "1", "5"], "A10"),
    (["--elastic-timeout", "30"], "A10"),
    (["--start-timeout", "30"], "A10"),
    (["--stall-check"], "A13"),
    (["--stall-check-warning-time-seconds", "5"], "A13"),
])
def test_unported_flags_raise_naming_their_item(flags, item):
    """Every flag that once named its unported item is accepted now.
    A13's (the stall inspector) ride a static launch and set the
    workers' HOROVOD_STALL_* knobs as the JAX launcher's args_to_env
    does. A10's (elastic mode): with a discovery script the job goes to
    run_elastic with the flag's value, without one the elastic-only
    flags ride a static launch, as the JAX launcher's do."""
    with mock.patch.object(tlaunch, "launch_static",
                           return_value=0) as ls, \
            mock.patch("horovod_tpu_torch.elastic.driver.run_elastic",
                       return_value=0) as rel:
        if item == "A13":
            assert tlaunch.run_commandline(
                ["-np", "1", *flags, "--", "true"]) == 0
            assert ls.called and not rel.called
            env = ls.call_args[0][3]
            want = jlaunch.args_to_env(jlaunch.build_parser().parse_args(
                ["-np", "1", *flags, "true"]))
            for k in (TC.HOROVOD_STALL_CHECK_DISABLE,
                      TC.HOROVOD_STALL_CHECK_TIME_SECONDS):
                assert env.get(k) == want.get(k), k
            assert any(k.startswith("HOROVOD_STALL") for k in env)
            return
        assert tlaunch.run_commandline(
            ["-np", "1", *flags, "--", "true"]) == 0
        elastic = "--host-discovery-script" in flags
        assert rel.called == elastic and ls.called != elastic
        if elastic:
            args, command, env = rel.call_args[0]
            assert args.host_discovery_script == "d.sh"
            assert command == ["true"]
        with mock.patch.object(jlaunch, "launch_static",
                               return_value=0) as jls, \
                mock.patch("horovod_tpu.elastic.driver.run_elastic",
                           return_value=0) as jrel:
            assert jlaunch.run_commandline(
                ["-np", "1", *flags, "--", "true"]) == 0
        assert (jrel.called, jls.called) == (rel.called, ls.called)
        got = (rel if elastic else ls).call_args
        want = (jrel if elastic else jls).call_args
        tf = vars(got[0][0]) if elastic else got[1]
        jf = vars(want[0][0]) if elastic else want[1]
        for k in ("min_num_proc", "blacklist_cooldown_range",
                  "elastic_timeout", "start_timeout"):
            if k in jf:
                assert tf[k] == jf[k], k


def test_stall_shutdown_flag_bounds_elastic_collectives_only():
    """--stall-check-shutdown-time-seconds reaches the workers'
    HOROVOD_STALL_SHUTDOWN_TIME_SECONDS in elastic mode (their process
    group's timeout) and, now that the stall watchdog is ported, in a
    static launch too, where it bounds every collective wait."""
    flag = ["--stall-check-shutdown-time-seconds", "20"]
    with mock.patch.object(tlaunch, "launch_static",
                           return_value=0) as ls:
        assert tlaunch.run_commandline(
            ["-np", "1", *flag, "--", "true"]) == 0
    assert ls.call_args[0][3][TC.HOROVOD_STALL_SHUTDOWN_TIME_SECONDS] == "20"
    with mock.patch("horovod_tpu_torch.elastic.driver.run_elastic",
                    return_value=0) as rel:
        assert tlaunch.run_commandline(
            ["--host-discovery-script", "d.sh", *flag, "--", "true"]) == 0
    env = rel.call_args[0][2]
    assert env[TC.HOROVOD_STALL_SHUTDOWN_TIME_SECONDS] == "20"
    assert env == jlaunch.args_to_env(jlaunch.build_parser().parse_args(
        ["--host-discovery-script", "d.sh", *flag, "true"]))


@pytest.mark.parametrize("flags,knob,attr,value", [
    (["--autotune"], TC.HOROVOD_AUTOTUNE, "autotune", True),
    (["--autotune-log-file", "/tmp/at.tsv"], TC.HOROVOD_AUTOTUNE_LOG,
     "autotune_log", "/tmp/at.tsv"),
    (["--autotune-warmup-samples", "1"],
     TC.HOROVOD_AUTOTUNE_WARMUP_SAMPLES, "autotune_warmup_samples", 1),
    (["--autotune-steps-per-sample", "2"],
     TC.HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE, "autotune_steps_per_sample", 2),
    (["--autotune-bayes-opt-max-samples", "5"],
     TC.HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES,
     "autotune_bayes_opt_max_samples", 5),
    (["--autotune-gaussian-process-noise", "0.5"],
     TC.HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE,
     "autotune_gaussian_process_noise", 0.5),
])
def test_autotune_flags_set_the_worker_env(flags, knob, attr, value):
    """Each --autotune flag is taken (no longer refused) and reaches the
    workers as its knob, as the JAX launcher maps it; the workers'
    Config reads it back as the JAX package's Config does."""
    seen = {}

    def fake(np, hosts, command, env, **kw):
        seen.update(env=env)
        return 0

    with mock.patch.object(tlaunch, "launch_static", fake):
        assert tlaunch.run_commandline(
            ["-np", "2", *flags, "--", "python", "t.py"]) == 0
    jenv = jlaunch.args_to_env(
        jlaunch.build_parser().parse_args(["-np", "2", *flags, "true"]))
    assert seen["env"][knob] == jenv[knob]
    assert knob == getattr(JC, knob)
    with mock.patch.dict("os.environ", {knob: seen["env"][knob]}):
        got = getattr(TC.Config.from_env(), attr)
        want = getattr(JC.Config.from_env(), attr)
    assert got == want == value


@pytest.mark.parametrize("flags,knob,attr,value", [
    (["--timeline-filename", "/tmp/t.json"], TC.HOROVOD_TIMELINE,
     "timeline_path", "/tmp/t.json"),
    (["--timeline-mark-cycles"], TC.HOROVOD_TIMELINE_MARK_CYCLES,
     "timeline_mark_cycles", True),
])
def test_timeline_flags_set_the_worker_env(flags, knob, attr, value):
    """The two timeline flags are taken (no longer refused) and reach
    the workers as their knobs, as the JAX launcher maps them; the
    workers' Config reads them back as the JAX package's does."""
    seen = {}

    def fake(np, hosts, command, env, **kw):
        seen.update(env=env)
        return 0

    with mock.patch.object(tlaunch, "launch_static", fake):
        assert tlaunch.run_commandline(
            ["-np", "2", *flags, "--", "python", "t.py"]) == 0
    jenv = jlaunch.args_to_env(
        jlaunch.build_parser().parse_args(["-np", "2", *flags, "true"]))
    assert seen["env"][knob] == jenv[knob]
    assert knob == getattr(JC, knob)
    with mock.patch.dict("os.environ", {knob: seen["env"][knob]}):
        got = getattr(TC.Config.from_env(), attr)
        want = getattr(JC.Config.from_env(), attr)
    assert got == want == value


@pytest.mark.parametrize("flag,knob", [
    ("--hierarchical-allreduce", TC.HOROVOD_HIERARCHICAL_ALLREDUCE),
    ("--hierarchical-allgather", TC.HOROVOD_HIERARCHICAL_ALLGATHER),
])
def test_hierarchical_flags_set_the_worker_env(flag, knob):
    """Each hierarchical flag reaches the workers as its knob set to 1,
    as the JAX launcher maps it."""
    seen = {}

    def fake(np, hosts, command, env, **kw):
        seen.update(env=env)
        return 0

    with mock.patch.object(tlaunch, "launch_static", fake):
        assert tlaunch.run_commandline(
            ["-np", "2", flag, "--", "python", "t.py"]) == 0
    assert seen["env"][knob] == "1"
    assert knob == getattr(JC, knob)


def test_ported_flags_reach_launch_static():
    seen = {}

    def fake(np, hosts, command, env, **kw):
        seen.update(np=np, hosts=hosts, command=command, env=env, **kw)
        return 0

    with mock.patch.object(tlaunch, "launch_static", fake):
        rc = tlaunch.run_commandline(
            ["-np", "2", "--fusion-threshold-mb", "8", "--no-stall-check",
             "--no-hierarchical-allreduce", "--cycle-time-ms", "2",
             "--log-level", "INFO", "--output-filename", "/tmp/logs",
             "--", "python", "t.py"])
    assert rc == 0
    assert seen["hosts"] == "localhost:2" and seen["np"] == 2
    assert seen["command"] == ["python", "t.py"]
    assert seen["env"][TC.HOROVOD_FUSION_THRESHOLD] == str(8 << 20)
    assert seen["output_dir"] == "/tmp/logs"


def test_replicated_control_plane_and_failover_are_refused(monkeypatch):
    """Once refused, now ported: HOROVOD_KV_REPLICAS=3 starts the
    replicated control plane (three replica processes, a started
    primary) whose worker env names every replica, a client given more
    than one endpoint fails over to the one that answers, and 1 still
    gives the plain server."""
    monkeypatch.setenv(tkv_ha.HOROVOD_KV_REPLICAS, "3")
    cp = tkv_ha.start_control_plane(b"k")
    try:
        assert isinstance(cp, tkv_ha.HAControlPlane) and cp.port > 0
        env = cp.worker_env("127.0.0.1")
        eps = env[trdv.HOROVOD_RENDEZVOUS_ADDRS].split(",")
        assert len(eps) == 3 and env[TC.HOROVOD_RENDEZVOUS_PORT] == \
            str(cp.port)
        cp.put("s", "k", b"v")
        assert cp.get("s", "k") == b"v"
    finally:
        cp.stop()
    monkeypatch.setenv(tkv_ha.HOROVOD_KV_REPLICAS, "1")
    rdv = tkv_ha.start_control_plane(b"k")
    try:
        assert isinstance(rdv, trdv.RendezvousServer) and rdv.port > 0
        # A dead first endpoint: the client rotates to the live one.
        monkeypatch.setenv(trdv.HOROVOD_RENDEZVOUS_ADDRS,
                           f"127.0.0.1:1,127.0.0.1:{rdv.port}")
        c = trdv.KVClient("127.0.0.1", 1, secret=b"k",
                          retry_policy=tres.RetryPolicy(
                              max_attempts=1))
        assert len(c.endpoints) == 2
        c.put("s", "k", b"v")
        assert rdv.get("s", "k") == b"v" and c.failovers >= 1
    finally:
        rdv.stop()


def test_check_build_reports_the_port(capsys):
    assert tlaunch.run_commandline(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert "horovod-tpu-torch" in out and "PyTorch" in out
    assert "gloo" in out and "NCCL" in out and "nvcc" in out
    from horovod_tpu_torch import kernels
    for name in kernels.SOURCES:
        assert name in out
    assert "Devices:" in out


def test_version_flag(capsys):
    with pytest.raises(SystemExit) as ei:
        tlaunch.run_commandline(["--version"])
    assert ei.value.code == 0
    assert "horovod-tpu-torch" in capsys.readouterr().out
