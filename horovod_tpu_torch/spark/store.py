"""Storage abstraction for the estimator stack (counterpart of
horovod_tpu/spark/store.py).

Reference: horovod/spark/common/store.py — Store / AbstractFilesystemStore
/ FilesystemStore / LocalStore / HDFSStore / DBFSLocalStore (store.py:38,
167, 301, 386, 396, 540). The reference hand-rolls one subclass per
filesystem (pyarrow-HDFS, DBFS path rewriting, local); here a single
`FilesystemStore` rides fsspec, which already speaks local, HDFS, S3, GCS
and DBFS URLs; fsspec is imported only when a store is made. Layout of the
run directory (intermediate data, per-run checkpoints and logs) mirrors
the reference so users find the same artifacts in the same places.
"""

from __future__ import annotations

import os
import posixpath
from typing import Optional


class Store:
    """Abstract artifact store (reference: store.py:38).

    Concrete stores expose paths for intermediate (parquet) train/val
    data and per-run checkpoints/logs, plus small read/write helpers used
    by the estimator to move models between driver and workers.
    """

    def get_train_data_path(self, idx: Optional[int] = None) -> str:
        raise NotImplementedError()

    def get_val_data_path(self, idx: Optional[int] = None) -> str:
        raise NotImplementedError()

    def get_test_data_path(self, idx: Optional[int] = None) -> str:
        raise NotImplementedError()

    def get_run_path(self, run_id: str) -> str:
        raise NotImplementedError()

    def get_checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError()

    def get_logs_path(self, run_id: str) -> str:
        raise NotImplementedError()

    def exists(self, path: str) -> bool:
        raise NotImplementedError()

    def read(self, path: str) -> bytes:
        raise NotImplementedError()

    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError()

    def write_text(self, path: str, text: str) -> None:
        self.write(path, text.encode())

    def makedirs(self, path: str) -> None:
        raise NotImplementedError()

    def is_parquet_dataset(self, path: str) -> bool:
        """True if `path` holds at least one parquet file."""
        raise NotImplementedError()

    @staticmethod
    def create(prefix_path: str, **kwargs) -> "Store":
        """Factory keyed on the URL scheme (reference: store.py:78
        Store.create dispatching to HDFSStore vs FilesystemStore)."""
        return FilesystemStore(prefix_path, **kwargs)


class FilesystemStore(Store):
    """fsspec-backed store: one class for local paths and remote URLs
    (hdfs://, s3://, gs://, ...) — subsumes the reference's
    FilesystemStore/HDFSStore/DBFSLocalStore split (store.py:301,396,540).
    """

    def __init__(self, prefix_path: str,
                 train_path: Optional[str] = None,
                 val_path: Optional[str] = None,
                 test_path: Optional[str] = None,
                 runs_path: Optional[str] = None):
        self.prefix_path = prefix_path.rstrip("/")
        self._train_path = train_path
        self._val_path = val_path
        self._test_path = test_path
        self._runs_path = runs_path or self._join(self.prefix_path, "runs")
        import fsspec

        self._fs, self._root = fsspec.core.url_to_fs(self.prefix_path)

    # -- paths ------------------------------------------------------------
    def _join(self, *parts: str) -> str:
        return posixpath.join(*parts)

    def _data_path(self, base: Optional[str], name: str,
                   idx: Optional[int]) -> str:
        p = base or self._join(self.prefix_path, name)
        return p if idx is None else f"{p}.{idx}"

    def get_train_data_path(self, idx: Optional[int] = None) -> str:
        return self._data_path(self._train_path,
                               "intermediate_train_data", idx)

    def get_val_data_path(self, idx: Optional[int] = None) -> str:
        return self._data_path(self._val_path, "intermediate_val_data", idx)

    def get_test_data_path(self, idx: Optional[int] = None) -> str:
        return self._data_path(self._test_path,
                               "intermediate_test_data", idx)

    def get_run_path(self, run_id: str) -> str:
        return self._join(self._runs_path, run_id)

    def get_checkpoint_path(self, run_id: str) -> str:
        return self._join(self.get_run_path(run_id), "checkpoint")

    def get_logs_path(self, run_id: str) -> str:
        return self._join(self.get_run_path(run_id), "logs")

    # -- IO ---------------------------------------------------------------
    def _strip(self, path: str) -> str:
        # fsspec filesystems want scheme-less paths for local fs; for
        # remote schemes the full URL works with the matching fs.
        return path

    def exists(self, path: str) -> bool:
        return self._fs.exists(self._strip(path))

    def read(self, path: str) -> bytes:
        with self._fs.open(self._strip(path), "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        parent = posixpath.dirname(self._strip(path))
        if parent:
            self._fs.makedirs(parent, exist_ok=True)
        with self._fs.open(self._strip(path), "wb") as f:
            f.write(data)

    def makedirs(self, path: str) -> None:
        self._fs.makedirs(self._strip(path), exist_ok=True)

    def list_files(self, path: str):
        if not self.exists(path):
            return []
        out = []
        for p in sorted(self._fs.ls(self._strip(path), detail=False)):
            if self._fs.isfile(p):
                out.append(p)
        return out

    def is_parquet_dataset(self, path: str) -> bool:
        return any(str(p).endswith(".parquet")
                   for p in self.list_files(path))

    def fs(self):
        return self._fs


class LocalStore(FilesystemStore):
    """Local-filesystem store (reference: store.py:386 — LocalStore is the
    FilesystemStore specialization for plain paths)."""

    def __init__(self, prefix_path: str, **kwargs):
        super().__init__(os.path.abspath(prefix_path), **kwargs)


class HDFSStore(FilesystemStore):
    """HDFS store via fsspec's hdfs/webhdfs drivers (reference:
    store.py:396 HDFSStore over pyarrow.hdfs). Requires an fsspec HDFS
    backend at use time; construction fails with a clear error if the
    driver is unavailable."""

    def __init__(self, prefix_path: str, **kwargs):
        if not prefix_path.startswith(("hdfs://", "webhdfs://")):
            # Keep the leading slash: hdfs:///a/b = path /a/b on the
            # default namenode; hdfs://a/b would make "a" the namenode.
            prefix_path = "hdfs:///" + prefix_path.lstrip("/")
        super().__init__(prefix_path, **kwargs)
