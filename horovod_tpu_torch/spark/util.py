"""Data preparation and parquet IO for the estimator stack (counterpart
of horovod_tpu/spark/util.py: the same files, metadata and shards, so a
dataset prepared by either package trains in the other).

Reference: horovod/spark/common/util.py — prepare_data (DataFrame →
parquet in the Store, util.py:576+), get_simple_meta_from_parquet
(row counts + column metadata), and the Petastorm reader plumbing the
remote trainers use. Petastorm is replaced by pyarrow.dataset: trainers
read their rank's shard of row groups straight into numpy (contiguous
host arrays, no torch/TF reader dependency), which the trainers then
copy to the card.

Accepted inputs: a pandas DataFrame (written to parquet here on the
driver — works with no Spark at all) or a pyspark DataFrame (written by
the cluster via df.write.parquet).
"""

from __future__ import annotations

import json
import posixpath
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np

_META_FILE = "_hvd_tpu_metadata.json"


def _is_pyspark_df(df) -> bool:
    mod = type(df).__module__ or ""
    return mod.startswith("pyspark")


def _cell_array(v) -> np.ndarray:
    """One cell as ndarray; Spark ML Vectors (anything with .toArray)
    are materialized (reference: store.py:617 vector adapters)."""
    return np.asarray(v.toArray() if hasattr(v, "toArray") else v)


def _stack_cells(values) -> np.ndarray:
    return np.stack([_cell_array(v) for v in values])


def _col_meta(arr: np.ndarray) -> Dict:
    """Shape/dtype metadata for one column (reference: util.py metadata
    dict with 'shape'/'intermediate_format' per column)."""
    a = np.asarray(arr)
    elem_shape = a.shape[1:] if a.ndim > 1 else ()
    return {"dtype": str(a.dtype), "shape": list(elem_shape)}


def restore_column(arr, meta: Dict) -> np.ndarray:
    """Restore a column read from parquet to its recorded per-element
    shape and dtype (reference: util.py:200+ metadata-driven reshaping —
    cells are stored flattened; shape/dtype live in the dataset
    metadata). Accepts object arrays of lists/arrays/Vectors or plain
    ndarrays."""
    shape = tuple(meta.get("shape") or ())
    dtype = np.dtype(meta["dtype"])
    a = np.asarray(arr)
    n = len(a)
    if a.dtype == object:
        a = _stack_cells(a) if n else np.zeros((0,) + shape, dtype)
    a = a.reshape((n,) + shape)
    return a.astype(dtype, copy=False)


def _pandas_to_parquet(df, path: str, store, n_shards: int) -> int:
    """Write a pandas DataFrame as n parquet shard files under `path`.

    Object cells (ndarrays / nested lists / Spark ML Vectors) are stored
    FLATTENED as 1-D lists — arrow cannot hold multi-dim cells — with the
    element shape recorded in the dataset metadata and restored by
    `restore_column` on read (reference: util.py:200+ same contract)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    flat = {}
    for c in df.columns:
        vals = df[c].values
        if vals.dtype == object and len(vals) and (
                hasattr(vals[0], "toArray")
                or np.asarray(vals[0]).ndim >= 1):
            flat[c] = [_cell_array(v).ravel().tolist() for v in vals]
        else:
            flat[c] = vals

    store.makedirs(path)
    n = len(df)
    bounds = np.linspace(0, n, n_shards + 1, dtype=int)
    fs = store.fs()
    for i in range(n_shards):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        table = pa.table({c: v[lo:hi] for c, v in flat.items()})
        with fs.open(posixpath.join(path, f"part-{i:05d}.parquet"),
                     "wb") as f:
            pq.write_table(table, f)
    return n


def _split_validation(df, validation):
    """Split off validation rows (reference: util.py _train_val_split —
    float fraction or boolean column name)."""
    if validation is None:
        return df, None
    if isinstance(validation, str):
        val = df[df[validation].astype(bool)]
        train = df[~df[validation].astype(bool)]
        return train.drop(columns=[validation]), \
            val.drop(columns=[validation])
    frac = float(validation)
    if not 0.0 < frac < 1.0:
        raise ValueError(f"validation fraction must be in (0,1): {frac}")
    n_val = int(len(df) * frac)
    return (df.iloc[:-n_val], df.iloc[-n_val:]) if n_val else (df, None)


def _pyspark_to_parquet(df, cols, validation, store,
                        train_path: str, val_path: str, shards: int):
    """Split + write a pyspark DataFrame from the executors."""
    from pyspark.sql import functions as F

    # Spark ML Vector columns -> array<double> so parquet holds plain
    # lists (reference: store.py:617 to_petastorm vector adapters).
    try:
        from pyspark.ml.functions import vector_to_array
        from pyspark.ml.linalg import VectorUDT
        for f in df.schema.fields:
            if f.name in cols and isinstance(f.dataType, VectorUDT):
                df = df.withColumn(f.name, vector_to_array(F.col(f.name)))
    except (ImportError, AttributeError):
        pass  # pyspark without ML (or the test stub)

    if isinstance(validation, str):
        base = df.select(*(cols + [validation]))
        val_df = base.filter(F.col(validation).cast("boolean")) \
                     .drop(validation)
        train_df = base.filter(~F.col(validation).cast("boolean")) \
                       .drop(validation)
    elif validation:
        frac = float(validation)
        train_df, val_df = df.select(*cols).randomSplit(
            [1.0 - frac, frac], seed=97)
    else:
        train_df, val_df = df.select(*cols), None

    train_df.repartition(shards).write.mode("overwrite").parquet(train_path)
    val_rows = 0
    if val_df is not None:
        val_df.repartition(shards).write.mode("overwrite").parquet(val_path)
        val_rows = _parquet_row_count(store, val_path)
    # Count and sample from what was actually WRITTEN — re-evaluating the
    # DataFrame lineage (count(), limit().toPandas()) would launch extra
    # Spark jobs and, under a nondeterministic upstream, could disagree
    # with the files on disk.
    train_rows = _parquet_row_count(store, train_path)
    sample = _parquet_sample(store, train_path, cols, n=64)
    metadata = {
        c: _col_meta(_stack_cells(sample[c]) if sample[c].dtype == object
                     and len(sample[c]) else sample[c])
        for c in cols
    }
    return train_rows, val_rows, metadata


def _parquet_row_count(store, path: str) -> int:
    import pyarrow.parquet as pq

    fs = store.fs()
    total = 0
    for fname in store.list_files(path):
        if not str(fname).endswith(".parquet"):
            continue
        with fs.open(fname, "rb") as f:
            total += pq.ParquetFile(f).metadata.num_rows
    return total


def _parquet_sample(store, path: str, cols, n: int) -> Dict[str, np.ndarray]:
    import pyarrow.parquet as pq

    fs = store.fs()
    for fname in store.list_files(path):
        if not str(fname).endswith(".parquet"):
            continue
        with fs.open(fname, "rb") as f:
            table = pq.read_table(f, columns=list(cols)).slice(0, n)
        if table.num_rows:
            out = {}
            for c in cols:
                col = table.column(c)
                try:
                    out[c] = col.to_numpy(zero_copy_only=False)
                except (pa_import().ArrowInvalid,
                        pa_import().ArrowNotImplementedError):
                    out[c] = np.asarray(col.to_pylist(), dtype=object)
            return out
    return {c: np.zeros((0,)) for c in cols}


def pa_import():
    import pyarrow

    return pyarrow


@contextmanager
def prepare_data(num_processes: int, store, df,
                 label_columns: List[str],
                 feature_columns: List[str],
                 validation=None,
                 sample_weight_col: Optional[str] = None,
                 dataset_idx: Optional[int] = None,
                 verbose: int = 0):
    """Materialize `df` as parquet in the store; yield the dataset index.

    Reference: util.py prepare_data (:576) — a context manager keyed by a
    dataset cache index so repeated fits on the same data skip the write.
    The cache here is intentionally simple: each call gets a fresh idx
    unless the caller pins one.
    """
    if dataset_idx is None:
        idx = 0
        while store.exists(posixpath.join(
                store.get_train_data_path(idx), _META_FILE)):
            idx += 1
    else:
        idx = dataset_idx
    train_path = store.get_train_data_path(idx)
    val_path = store.get_val_data_path(idx)

    cols = list(feature_columns) + list(label_columns)
    if sample_weight_col:
        cols.append(sample_weight_col)

    shards = max(num_processes, 1)
    if _is_pyspark_df(df):
        # Cluster-side write: executors stream straight to the store, the
        # driver never materializes the dataset (reference: util.py
        # prepare_data's df.write through to_parquet helpers).
        train_rows, val_rows, metadata = _pyspark_to_parquet(
            df, cols, validation, store, train_path, val_path, shards)
    else:
        keep = cols + ([validation] if isinstance(validation, str) and
                       validation in getattr(df, "columns", []) else [])
        pdf = df[keep].copy()
        train_df, val_df = _split_validation(pdf, validation)
        train_rows = _pandas_to_parquet(train_df, train_path, store, shards)
        val_rows = (_pandas_to_parquet(val_df, val_path, store, shards)
                    if val_df is not None and len(val_df) else 0)
        metadata = {
            c: _col_meta(_stack_cells(train_df[c].values)
                         if train_df[c].dtype == object
                         and len(train_df) else train_df[c].values)
            for c in cols
        }
    meta = {"train_rows": train_rows, "val_rows": val_rows,
            "metadata": metadata, "feature_columns": list(feature_columns),
            "label_columns": list(label_columns),
            "sample_weight_col": sample_weight_col}
    store.write(posixpath.join(train_path, _META_FILE),
                json.dumps(meta).encode())
    yield idx


def get_simple_meta_from_parquet(store, label_columns=None,
                                 feature_columns=None,
                                 sample_weight_col=None,
                                 dataset_idx: Optional[int] = None
                                 ) -> Tuple[int, int, Dict, float]:
    """(train_rows, val_rows, metadata, avg_row_size_bytes) for a prepared
    dataset (reference: util.py get_simple_meta_from_parquet)."""
    idx = 0 if dataset_idx is None else dataset_idx
    train_path = store.get_train_data_path(idx)
    raw = store.read(posixpath.join(train_path, _META_FILE))
    meta = json.loads(raw)
    md = meta["metadata"]
    row_bytes = float(sum(
        np.dtype(m["dtype"]).itemsize * int(np.prod(m["shape"] or [1]))
        for m in md.values())) or 1.0
    return meta["train_rows"], meta["val_rows"], md, row_bytes


def _shard_files(files: List[str], rank: int, size: int) -> List[str]:
    """Round-robin file sharding. A rank beyond the file count gets NO
    files (an empty shard) — wrapping around would hand the same file to
    two ranks and silently double-weight its rows in every averaged
    gradient. The trainers' MIN-consensus step count turns the empty
    shard into a clear 'dataset too small for num_proc' error instead."""
    return [f for i, f in enumerate(files) if i % size == rank]


def read_shard(store, path: str, rank: int, size: int,
               columns: List[str]) -> Dict[str, np.ndarray]:
    """Read this rank's shard of a parquet dataset into numpy columns.

    Reference analog: the Petastorm `make_batch_reader(cur_shard=rank,
    shard_count=size)` call in spark/keras/remote.py; here a plain
    pyarrow read of the rank's file subset.
    """
    import pyarrow.parquet as pq

    files = [f for f in store.list_files(path)
             if str(f).endswith(".parquet")]
    if not files:
        raise FileNotFoundError(f"no parquet files under {path}")
    fs = store.fs()
    mine = _shard_files(files, rank, size)
    parts = []
    if not mine:
        # empty shard: zero-row table with the right schema so the
        # trainer's step consensus can diagnose it (footer-only read —
        # the shard file itself may be huge)
        import pyarrow as pa

        with fs.open(files[0], "rb") as f:
            schema = pq.ParquetFile(f).schema_arrow
        schema = pa.schema([schema.field(c) for c in columns])
        parts.append(schema.empty_table())
    for fname in mine:
        with fs.open(fname, "rb") as f:
            parts.append(pq.read_table(f, columns=columns))
    import pyarrow as pa

    table = pa.concat_tables(parts)
    out: Dict[str, np.ndarray] = {}
    for c in columns:
        col = table.column(c)
        try:
            out[c] = col.to_numpy(zero_copy_only=False)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            # nested/list cells: fall back to the object path
            out[c] = np.asarray(col.to_pylist(), dtype=object)
    return out


def batch_iter(data: Dict[str, np.ndarray], batch_size: int,
               shuffle: bool, seed: int, epoch: int,
               drop_remainder: bool = True):
    """Yield dict batches; epoch-deterministic shuffle so every rank with
    the same seed sees a different (sharded) but stable order."""
    cols = list(data)
    n = len(data[cols[0]])
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(seed * 100003 + epoch)
        rng.shuffle(order)
    end = n - (n % batch_size) if drop_remainder else n
    if end == 0 and n:
        end = n  # tiny shard: one short batch beats zero batches
    for lo in range(0, end, batch_size):
        sel = order[lo:lo + batch_size]
        yield {c: data[c][sel] for c in cols}
