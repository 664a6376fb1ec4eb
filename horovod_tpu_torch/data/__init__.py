"""Data loading helpers (counterpart of horovod_tpu/data)."""

from horovod_tpu_torch.data.data_loader import (  # noqa: F401
    AsyncDataLoaderMixin, BaseDataLoader, DeviceFeed, ShardedDataset,
)
