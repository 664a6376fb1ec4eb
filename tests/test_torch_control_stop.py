"""Fault C9 of the launched control-plane job: its two ranks stop at one
step even when they see the test's go-ahead file at different times.

tests/torch_control_worker.py `main` trained until the go file (or its
own deadline) appeared, each rank deciding alone. On a loaded host the
file could appear between the two ranks' checks: one rank left the
loop, the other entered the next step's all-reduce and waited for it
until the consistency check gave up after 60 s ("rank(s) [0] never
issued it"), and the job exited non-zero. The ranks now agree on the
stop by an all-reduce (max) of their flags. Here a rank past
CONTROL_TEST_GO_LAG sees the file 3 checks late, a divergence that the
old loop turned into that hang every time.
"""

import time

from test_torch_control_plane import launches  # noqa: F401 (fixture)
from horovod_tpu_torch.common.resilience import RetryPolicy
from horovod_tpu_torch.runner.rendezvous import KVClient

SECRET = "control-stop-test-secret-0123456789"


def test_ranks_that_see_go_apart_stop_at_one_step(tmp_path,
                                                  launches):  # noqa: F811
    job = launches(tmp_path, {"HOROVOD_SECRET_KEY": SECRET,
                              "CONTROL_TEST_GO_LAG": "3"}, timeout=60)
    host, port = job.endpoints()[0].rsplit(":", 1)
    kv = KVClient(host, int(port), secret=SECRET.encode(),
                  retry_policy=RetryPolicy(max_attempts=3, base_delay=0.05))
    while time.monotonic() < job.end and any(
            kv.get("job", f"r{r}-s1", timeout=0) is None for r in (0, 1)):
        time.sleep(0.1)  # both ranks are in the loop
    seen, _ = job.finish()
    assert seen[0]["steps"] == seen[1]["steps"] >= 2, seen
    assert seen[0]["lost"] == seen[1]["lost"] == [], seen
