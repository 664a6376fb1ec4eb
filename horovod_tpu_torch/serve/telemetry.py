"""Serving metrics, pre-registered (counterpart of
horovod_tpu/serve/telemetry.py).

Every ``horovod_serve_*`` series is created at startup so a healthy
idle service scrapes ZEROS rather than missing series — absent data and
"no traffic yet" must be distinguishable on a dashboard (same rule the
resilience counters follow, observability/metrics.py).

Handles are cached per registry identity so `reset_for_tests()` in the
metrics registry refreshes them automatically.
"""

from __future__ import annotations

#: `status` label values of horovod_serve_requests_total, pre-created.
REQUEST_STATUSES = ("accepted", "rejected", "completed", "failed")

_mx_cache = None


def handles():
    """The serving instrument handles (lazy, registry-identity keyed)."""
    global _mx_cache
    from horovod_tpu_torch.observability import metrics as m
    reg = m.registry()
    if _mx_cache is None or _mx_cache[0] is not reg:
        requests = reg.counter(
            "horovod_serve_requests_total",
            "Inference requests by outcome (accepted/rejected at "
            "admission, completed/failed at reply)",
            labelnames=("status",))
        mx = {
            "requests": requests,
            "request_status": {s: requests.labels(status=s)
                               for s in REQUEST_STATUSES},
            "request_seconds": reg.histogram(
                "horovod_serve_request_seconds",
                "End-to-end request latency (accept to reply)",
                buckets=m.TIME_BUCKETS),
            "queue_depth": reg.gauge(
                "horovod_serve_queue_depth",
                "Requests accepted but not yet dispatched in a batch"),
            "queue_wait": reg.histogram(
                "horovod_serve_queue_wait_seconds",
                "Time a request spent in the batching queue "
                "(t_enqueue to t_dequeue) — the queue share of "
                "request latency, visible without a trace",
                buckets=m.TIME_BUCKETS),
            "batches": reg.counter(
                "horovod_serve_batches_total",
                "Batches dispatched to replicas"),
            "batch_seconds": reg.histogram(
                "horovod_serve_batch_seconds",
                "Replica round-trip time per dispatched batch",
                buckets=m.TIME_BUCKETS),
            "batch_size": reg.histogram(
                "horovod_serve_batch_size",
                "Real (unpadded) requests per dispatched batch",
                buckets=m.COUNT_BUCKETS),
            "padded_items": reg.counter(
                "horovod_serve_padded_items_total",
                "Padding rows added to reach the shape bucket"),
            "inflight": reg.gauge(
                "horovod_serve_inflight_batches",
                "Batches currently executing on replicas"),
            "replicas": reg.gauge(
                "horovod_serve_replicas",
                "Live replicas in the pool"),
            "replica_deaths": reg.counter(
                "horovod_serve_replica_deaths_total",
                "Replicas removed from the pool after a failure"),
            "requeued": reg.counter(
                "horovod_serve_requeued_requests_total",
                "In-flight requests requeued after a replica death"),
            "no_replica": reg.counter(
                "horovod_serve_no_replica_total",
                "Discovery ticks where accepted work waited with no "
                "live replica in the pool (starvation signal)"),
            "replica_batches": reg.counter(
                "horovod_serve_replica_batches_total",
                "Batches served by THIS replica process"),
            "replica_batch_seconds": reg.histogram(
                "horovod_serve_replica_batch_seconds",
                "On-replica inference time per batch",
                buckets=m.TIME_BUCKETS),
            "compiles": reg.counter(
                "horovod_serve_compiles_total",
                "CUDA graphs captured per bucket shape (warmup + "
                "on-demand)"),
            "slo_burn": reg.gauge(
                "horovod_serve_slo_burn_rate",
                "SLO error-budget burn rate over the last watch tick "
                "(1.0 = exactly on budget; hvdwatch alerts at "
                "HOROVOD_WATCH_BURN_RATE — observability/watch.py)"),
        }
        _mx_cache = (reg, mx)
    return _mx_cache[1]


def preregister_metrics() -> None:
    """Create every horovod_serve_* family AND labeled series up front
    (call once at service/replica startup). Idempotent."""
    handles()
