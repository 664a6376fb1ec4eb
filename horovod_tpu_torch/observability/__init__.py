"""Observability of the port (counterpart of horovod_tpu/observability/).

`metrics`: the process-local registry (Counter, Gauge, Histogram; a
no-op shell under HOROVOD_METRICS=0) and Prometheus rendering.
`export`: the background fan-out (the rendezvous KV push the launcher's
`/metrics` route serves, JSON dumps, timeline counter tracks).
`flight`: the always-on flight recorder, dumped on a stall, a
divergence, a fatal error, SIGUSR1 and exit. `tracing`: spans and trace
context, a `train.step` root per step. `watch`: the online anomaly
detectors with triggered capture. `doctor` (offline) and `top` (live)
read what the others record: `python -m
horovod_tpu_torch.observability.doctor --dir D`, `python -m
horovod_tpu_torch.observability.top --addr HOST:PORT`.
"""

from horovod_tpu_torch.observability.metrics import (  # noqa: F401
    COUNT_BUCKETS, MetricsRegistry, NOOP, SIZE_BUCKETS, TIME_BUCKETS,
    enabled, parse_snapshot, registry, render_snapshots, reset_for_tests,
)
from horovod_tpu_torch.observability.export import (  # noqa: F401
    MetricsExporter, start_exporter, stop_exporter,
)
from horovod_tpu_torch.observability.flight import (  # noqa: F401
    FlightRecorder,
)
