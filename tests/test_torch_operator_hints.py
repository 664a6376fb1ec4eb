"""The operator-facing hints of the port against the JAX package's (fault
C15): where the flight recorder dumped its ring, and how to merge the
dumps with the doctor.

- the stall watchdog's HorovodInternalError, both packages' watchdogs on
  a wait that never completes, with HOROVOD_FLIGHT_DIR set and unset;
- the launcher's and the elastic driver's line after a failed job
  (`runner/launch.py print_doctor_hint`; the JAX package prints it from
  `horovod_tpu/runner/launch.py` and `horovod_tpu/elastic/driver.py`),
  and one launched job whose worker fails.

Both packages' recorders are re-read from the environment around each
case (`flight.reset_for_tests`), so no case depends on what an earlier
test in the same process left behind.
"""

import os
import subprocess
import sys
import threading

import pytest

from horovod_tpu.common.resilience import PyStallInspector as JInspector
from horovod_tpu.observability import flight as jfl
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.resilience import PyStallInspector
from horovod_tpu_torch.observability import flight as tfl
from horovod_tpu_torch.ops import collectives as tcoll
from horovod_tpu_torch.runner import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DOCTOR = "python -m horovod_tpu_torch.observability.doctor"
JAX_DOCTOR = "python -m horovod_tpu.observability.doctor"


@pytest.fixture(params=[False, True], ids=["no_flight_dir", "flight_dir"])
def flight_dir(request, tmp_path, monkeypatch):
    d = str(tmp_path / "flight") if request.param else None
    if d:
        monkeypatch.setenv("HOROVOD_FLIGHT_DIR", d)
    else:
        monkeypatch.delenv("HOROVOD_FLIGHT_DIR", raising=False)
    for m in (jfl, tfl):
        m.reset_for_tests()
    yield d
    monkeypatch.undo()
    for m in (jfl, tfl):
        m.reset_for_tests()


class NeverDone:
    def is_completed(self):
        return False

    def wait(self):
        return True


def _jax_message(monkeypatch):
    monkeypatch.setattr(jcoll, "_restore_grace_active", lambda *a: False)
    wd = jcoll.StallWatchdog(JInspector(10.0, 0.0), warn_sec=60.0,
                             shutdown_sec=0.1, poll_interval=0.01)
    release = threading.Event()
    try:
        with pytest.raises(Exception) as ei:
            wd.guard("grads", lambda: release.wait(30))
    finally:
        release.set()
    return type(ei.value).__name__, str(ei.value)


def _port_message(monkeypatch):
    monkeypatch.setattr(tcoll, "_restore_grace_active", lambda *a: False)
    monkeypatch.setattr(tcoll, "_abort_world", lambda reason: None)
    wd = tcoll.StallWatchdog(PyStallInspector(10.0, 0.0), warn_sec=60.0,
                             shutdown_sec=0.1, poll_interval=0.01)
    with pytest.raises(HorovodInternalError) as ei:
        wd.guard("grads", NeverDone())
    return type(ei.value).__name__, str(ei.value)


def test_stall_watchdog_message_matches_jax(flight_dir, monkeypatch):
    jname, jmsg = _jax_message(monkeypatch)
    pname, pmsg = _port_message(monkeypatch)
    assert pname == jname == "HorovodInternalError"
    assert pmsg == jmsg.replace(JAX_DOCTOR, PORT_DOCTOR)
    assert pmsg.startswith("collective 'grads' stalled past "
                           "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS=0s")
    if flight_dir:
        assert f"; flight recorder dump: {flight_dir}/" in pmsg
        assert pmsg.endswith(f" (merge with `{PORT_DOCTOR} --dir "
                             f"{flight_dir}`)")
        assert os.path.exists(tfl.get().last_dump_path)
    else:
        assert "flight recorder" not in pmsg


def test_dump_hint_names_the_ports_doctor(flight_dir):
    rec = tfl.get()
    assert rec.dump_hint() == ""
    path = tfl.dump("manual")
    if not flight_dir:
        assert path is None and tfl.dump_hint() == ""
        return
    jfl.dump("manual")
    assert tfl.dump_hint() == jfl.dump_hint().replace(JAX_DOCTOR,
                                                      PORT_DOCTOR)
    assert tfl.dump_hint() == (
        f"; flight recorder dump: {path} (merge with `{PORT_DOCTOR} --dir "
        f"{os.path.dirname(path)}`)")


def test_failed_job_hint(flight_dir, capsys):
    launch.print_doctor_hint("elastic")
    err = capsys.readouterr().err
    if not flight_dir:
        assert err == ""
        return
    # no dump yet and no directory: nothing to merge
    assert err == ""
    launch.print_doctor_hint("elastic", tails=["t.json"])
    assert capsys.readouterr().err == (
        f"elastic: flight-recorder dumps are in {flight_dir}; merge them "
        f"with `{PORT_DOCTOR} --dir {flight_dir}`\n")
    os.makedirs(flight_dir)
    launch.print_doctor_hint(launch.PROG)
    assert f"`{PORT_DOCTOR} --dir {flight_dir}`" in capsys.readouterr().err


def test_launched_job_that_fails_names_the_doctor(tmp_path):
    flight = tmp_path / "flight"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(HOROVOD_FLIGHT_DIR=str(flight), OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "1", sys.executable, "-c",
         "import os; os.makedirs(os.environ['HOROVOD_FLIGHT_DIR'], "
         "exist_ok=True); raise SystemExit(3)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 3, r.stderr
    assert "workers failed: [(0, 3)]" in r.stderr
    assert f"`{PORT_DOCTOR} --dir {flight}`" in r.stderr, r.stderr
