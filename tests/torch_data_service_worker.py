"""Helpers for tests/test_torch_data_service.py: the dataset functions
the workers run (module level, so they pickle by import path), and the
JAX package's DataWorker as a spawned process's target."""

import time

import numpy as np


def range_dataset(shard, num_shards):
    """12 batches in all, dealt round-robin over the shards."""
    for i in range(shard, 12, num_shards):
        yield {"x": np.full((4,), i, np.int32),
               "y": np.arange(3, dtype=np.float32) * i}


def jax_worker(port: int, secret_hex: str) -> None:
    """Run one JAX-package DataWorker against the dispatcher at
    127.0.0.1:`port` until the test kills this process."""
    from horovod_tpu.data.service import DataWorker
    w = DataWorker(("127.0.0.1", port), secret=bytes.fromhex(secret_hex),
                   poll_interval=0.02)
    w.start()
    while True:
        time.sleep(1.0)
