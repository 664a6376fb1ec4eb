"""Elastic fault-tolerant inference tier (counterpart of
horovod_tpu/serve/; the engine captures a CUDA graph per bucket where
the JAX engine compiles an XLA program).

The training stack's hard parts — membership (elastic driver +
rendezvous KV), fault detection (stall watchdog / breakers), retry and
backoff (common/resilience.py), postmortems (flight recorder +
hvddoctor) — are exactly what a serving tier needs, so this package
reuses them instead of rebuilding them (ROADMAP item 4):

* ``frontend.py``  — request router: authenticated framed TCP (the
  `data/service.py` wire format) accepting single-example requests into
  a bounded queue; rejects (never silently drops) on overload.
* ``batching.py``  — continuous request batching (Orca, OSDI '22): new
  requests join the next batch under ``HOROVOD_SERVE_MAX_BATCH`` /
  ``HOROVOD_SERVE_MAX_WAIT_MS`` deadlines and are padded to a small set
  of bucketed shapes, so replicas only ever replay captured graphs.
* ``engine.py``    — one captured ``torch.cuda.CUDAGraph`` per bucket,
  replayed under perfscope phase attribution.
* ``replica.py``   — replica-side server: registers in the rendezvous
  KV, serves batches, pushes perfscope/flight telemetry.
* ``pool.py``      — launcher-side replica pool: routes batches to free
  replicas, detects replica death, requeues in-flight requests onto
  survivors (zero accepted requests dropped), adopts rejoined hosts on
  the next elastic round.
* ``launcher.py``  — ``python -m horovod_tpu_torch.serve``: the elastic
  serving launcher (ElasticDriver underneath).
"""

from horovod_tpu_torch.serve.batching import (  # noqa: F401
    Batch, ContinuousBatcher, Request, parse_buckets,
)
from horovod_tpu_torch.serve.engine import InferenceEngine  # noqa: F401
from horovod_tpu_torch.serve.frontend import Frontend, ServeClient  # noqa: F401
from horovod_tpu_torch.serve.pool import ReplicaPool  # noqa: F401
from horovod_tpu_torch.serve.replica import ReplicaServer, serve_replica  # noqa: F401
from horovod_tpu_torch.serve.telemetry import preregister_metrics  # noqa: F401

#: Rendezvous-KV scope serving state lives under (replica registrations,
#: the drain/shutdown flag).
SCOPE = "serve"
