"""Estimator / Model (Transformer) stack of the port (counterpart of
horovod_tpu/spark/estimator.py).

Reference: horovod/spark/common/estimator.py (HorovodEstimator /
HorovodModel), spark/keras/estimator.py, spark/torch/estimator.py — the
Spark-ML `est.fit(df) -> model; model.transform(df)` workflow: DataFrame
→ parquet in a Store → distributed training job → trained transformer.

  * The training backend is pluggable (backend.py): Spark tasks are one
    placement provider, `LocalBackend` (the port's launcher) is another.
  * `TorchEstimator` and `LightningEstimator` train torch modules on the
    card: each worker calls `hvd.init()` (the card unless
    HOROVOD_WORKER_PLATFORM=cpu asks for the host, backend.worker_device),
    moves the module, every batch and the sample weights to
    `hvd.device()`, and reduces gradients with the port's
    DistributedOptimizer (NCCL); rank 0 stores the trained module on
    the host. `TorchModel.transform` runs it on the card (the host on
    request) and brings the output back with `.cpu()`.
  * `KerasEstimator` trains a Keras model with its gradients reduced
    through the port's TF frontend.
  * The JAX package's JaxEstimator trains JAX models and has no
    counterpart here: the port imports no JAX.
  * Petastorm readers are replaced by pyarrow shard reads (util.py).
  * Payloads pickle with cloudpickle where it is installed, else with the
    standard pickle (module-level functions and classes by import path).

Data contract (reference: spark/common/util.py:200+ metadata-driven
reshaping): per-column element dtype + shape are recorded in the dataset
metadata at prepare time and restored end-to-end —

  * a SINGLE feature column whose elements are >= 2-D (e.g. an 8x8x1
    image) reaches the model as a shaped tensor `X[batch, *shape]` in
    its recorded dtype (float64 as float32);
  * otherwise feature columns are concatenated column-wise into a
    float32 matrix `X[batch, D]` (vector cells flatten into their slot);
  * a single label column keeps its recorded dtype and shape (integer
    class labels stay integers); multiple label columns concatenate to
    float32.

Spark ML Vector columns are accepted (converted to arrays at prepare
time; Vector cells in pandas frames are materialized via .toArray()).
"""

from __future__ import annotations

import pickle
import posixpath
import uuid
from typing import Dict, List, Optional

import numpy as np

# cloudpickle where it is installed, else the standard pickle
from horovod_tpu_torch.runner import _dumps
from horovod_tpu_torch.spark.backend import (Backend, LocalBackend,
                                             SparkBackend, worker_device)
from horovod_tpu_torch.spark.params import EstimatorParams, ModelParams
from horovod_tpu_torch.spark import util as sutil

_CKPT_FILE = "model.pkl"


def _stack_columns(data: Dict[str, np.ndarray], cols: List[str],
                   metadata: Optional[Dict] = None) -> np.ndarray:
    """Concat columns into a 2-D float32 matrix (vector cells flatten)."""
    mats = []
    for c in cols:
        a = np.asarray(data[c])
        if len(a) == 0:
            # Empty shard/frame: take the element width from the dataset
            # metadata when available; a bare object column keeps width 1,
            # which is all the zero-row paths (init probes, empty
            # transform) need. (reshape(0, -1) cannot infer a width from
            # zero elements, so build the 2-D form directly.)
            m = (metadata or {}).get(c)
            width = int(np.prod(m["shape"] or [1])) if m else \
                max(1, int(np.prod(a.shape[1:])))
            mats.append(np.zeros((0, max(1, width)), np.float32))
            continue
        if a.dtype == object:
            a = sutil._stack_cells(a)
        a = a.reshape(len(a), -1)
        mats.append(a.astype(np.float32, copy=False))
    return np.concatenate(mats, axis=1) if len(mats) > 1 else mats[0]


def _features(data: Dict[str, np.ndarray], cols: List[str],
              metadata: Optional[Dict] = None) -> np.ndarray:
    """Model input: a single >=2-D feature column arrives SHAPED in its
    recorded dtype (image-style models); anything else is the flat
    float32 matrix (reference: util.py:200+ reshaping per metadata)."""
    if metadata and len(cols) == 1:
        m = metadata.get(cols[0])
        if m and len(m.get("shape") or ()) >= 2:
            a = sutil.restore_column(data[cols[0]], m)
            if a.dtype.kind == "f" and a.dtype != np.float32:
                # float64 cells (numpy's default) would feed DoubleTensors
                # to float32 torch/keras models; integer dtypes keep
                a = a.astype(np.float32)
            return a
    return _stack_columns(data, cols, metadata)


def _labels(data: Dict[str, np.ndarray], cols: List[str],
            metadata: Optional[Dict] = None) -> np.ndarray:
    if metadata and len(cols) == 1 and cols[0] in metadata:
        # dtype/shape-preserving path: int class labels stay int; float64
        # (numpy/Spark default) normalizes to float32 for f32 models
        y = sutil.restore_column(data[cols[0]], metadata[cols[0]])
        if y.dtype.kind == "f" and y.dtype != np.float32:
            y = y.astype(np.float32)
        return y
    y = _stack_columns(data, cols, metadata)
    return y[:, 0] if y.shape[1] == 1 else y


class HorovodEstimator(EstimatorParams):
    """Backend-agnostic base (reference: estimator.py:25 HorovodEstimator).

    Subclasses supply `_make_trainer_payload` (what ships to workers) and
    `_make_model` (wrap the trained state as a transformer).
    """

    def fit(self, df, params: Optional[dict] = None) -> "HorovodModel":
        if params:
            return self.copy(params).fit(df)
        backend = self._get_or_create_backend()
        store = self.getStore()
        if store is None:
            raise ValueError("estimator requires store=Store.create(...)")
        with sutil.prepare_data(
                backend.num_processes(), store, df,
                label_columns=self.getLabelCols(),
                feature_columns=self.getFeatureCols(),
                validation=self.getValidation(),
                sample_weight_col=self.getSampleWeightCol(),
                verbose=self.getVerbose()) as dataset_idx:
            return self._fit_on_prepared_data(backend, dataset_idx)

    def fit_on_parquet(self, params: Optional[dict] = None,
                       dataset_idx: Optional[int] = None) -> "HorovodModel":
        """Train on already-prepared parquet at the store's train path
        (reference: estimator.py:37 fit_on_parquet)."""
        if params:
            return self.copy(params).fit_on_parquet(dataset_idx=dataset_idx)
        backend = self._get_or_create_backend()
        return self._fit_on_prepared_data(backend, dataset_idx or 0)

    # -- internals --------------------------------------------------------
    def _get_or_create_backend(self) -> Backend:
        backend = self.getBackend()
        if backend is not None:
            if self.getNumProc() is not None:
                raise ValueError(
                    'at most one of "backend" and "num_proc" may be set')
            return backend
        np_ = self.getNumProc()
        try:
            import pyspark  # noqa: F401
            has_spark = (pyspark.SparkContext._active_spark_context
                         is not None)
        except ImportError:
            has_spark = False
        if has_spark:
            return SparkBackend(np_, verbose=self.getVerbose())
        return LocalBackend(np_ or 1)

    def _fit_on_prepared_data(self, backend: Backend,
                              dataset_idx: int) -> "HorovodModel":
        store = self.getStore()
        run_id = self.getRunId() or f"run_{uuid.uuid4().hex[:12]}"
        train_rows, val_rows, metadata, _ = \
            sutil.get_simple_meta_from_parquet(store,
                                               dataset_idx=dataset_idx)
        payload = _dumps(dict(
            kind=self._kind,
            store=store,
            dataset_idx=dataset_idx,
            run_id=run_id,
            train_rows=train_rows,
            val_rows=val_rows,
            metadata=metadata,
            trainer=self._make_trainer_payload(),
            feature_cols=self.getFeatureCols(),
            label_cols=self.getLabelCols(),
            sample_weight_col=self.getSampleWeightCol(),
            batch_size=self.getBatchSize(),
            val_batch_size=self.getValBatchSize() or self.getBatchSize(),
            epochs=self.getEpochs(),
            train_steps_per_epoch=self.getTrainStepsPerEpoch(),
            val_steps_per_epoch=self.getValidationStepsPerEpoch(),
            shuffle=self.getShuffle(),
            seed=self.getRandomSeed(),
            shuffle_seed=(self.getShufflingSeed()
                          if self.getShufflingSeed() is not None
                          else self.getRandomSeed()),
            callbacks=self.getCallbacks(),
            compression=self.getCompression(),
            predivide=self.getGradientPredivideFactor(),
            bpps=self.getBackwardPassesPerStep(),
            use_adasum=self.getUseAdasum(),
            verbose=self.getVerbose(),
        ))
        results = backend.run(_remote_train, args=(payload,))
        history = results[0]
        blob = store.read(posixpath.join(
            store.get_checkpoint_path(run_id), _CKPT_FILE))
        state = pickle.loads(blob)
        return self._make_model(state, metadata, run_id, history)

    _kind = "base"

    def _make_trainer_payload(self) -> dict:
        raise NotImplementedError()

    def _make_model(self, state, metadata, run_id, history):
        raise NotImplementedError()


class HorovodModel(ModelParams):
    """Trained transformer (reference: estimator.py:100 HorovodModel).

    `transform(df)` appends prediction columns. pandas DataFrames are
    handled directly; pyspark DataFrames go through mapInPandas so
    inference runs on the executors (reference: torch/estimator.py
    transform via udf).
    """

    def __init__(self, history: Optional[list] = None, **kwargs):
        super().__init__(**kwargs)
        self.history = history or []

    def _predict_batch(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError()

    def _output_cols(self) -> List[str]:
        out = self.getOutputCols()
        if out:
            return out
        return [f"{c}__output" for c in self.getLabelCols()]

    def _transform_pandas(self, pdf):
        if not len(pdf):
            out = pdf.copy()
            for c in self._output_cols():
                out[c] = np.zeros((0,), np.float32)
            return out
        bs = self.getBatchSize()
        data = {c: pdf[c].values for c in self.getFeatureCols()}
        X = _features(data, self.getFeatureCols(), self.getMetadata())
        preds = np.concatenate(
            [np.asarray(self._predict_batch(X[i:i + bs]))
             for i in range(0, len(X), bs)])
        out = pdf.copy()
        ocols = self._output_cols()
        if preds.ndim > 1 and preds.shape[-1] == 1:
            preds = preds[..., 0]  # (B,1) -> scalar column
        if preds.ndim == 1 and len(ocols) > 1:
            raise ValueError(
                f"model produced 1 output per row but {len(ocols)} "
                f"output columns were requested: {ocols}")
        if preds.ndim == 1 or len(ocols) == 1:
            out[ocols[0]] = list(preds) if preds.ndim > 1 else preds
        else:
            if preds.shape[-1] % len(ocols):
                raise ValueError(
                    f"model output width {preds.shape[-1]} is not "
                    f"divisible across {len(ocols)} output columns")
            per = preds.shape[-1] // len(ocols)
            for j, c in enumerate(ocols):
                cut = preds[..., j * per:(j + 1) * per]
                out[c] = list(cut) if per > 1 else cut[..., 0]
        return out

    def _spark_output_schema(self, df, probe_pdf):
        """Input schema + prediction columns, typed by probing a small
        local predict (the reference derives this from stored metadata;
        probing needs no metadata contract)."""
        from pyspark.sql.types import (ArrayType, DoubleType, StructField,
                                       StructType)

        fields = list(df.schema.fields)
        present = {f.name for f in fields}
        for c in self._output_cols():
            if c in present:
                continue
            cell = probe_pdf[c].iloc[0] if len(probe_pdf) else 0.0
            dt = (ArrayType(DoubleType())
                  if isinstance(cell, (list, np.ndarray)) else DoubleType())
            fields.append(StructField(c, dt, True))
        return StructType(fields)

    def transform(self, df, params: Optional[dict] = None):
        if params:
            return self.copy(params).transform(df)
        if sutil._is_pyspark_df(df):
            blob = _dumps(self)
            probe = self._transform_pandas(df.limit(4).toPandas())
            schema = self._spark_output_schema(df, probe)

            def mapper(it):
                model = pickle.loads(blob)
                for pdf in it:
                    out = model._transform_pandas(pdf)
                    for c in model._output_cols():
                        if out[c].dtype != object:
                            out[c] = out[c].astype(float)
                    yield out
            return df.mapInPandas(mapper, schema)
        return self._transform_pandas(df)


# ======================================================================
# Torch estimator
# ======================================================================

class TorchEstimator(HorovodEstimator):
    """Estimator over a torch.nn.Module via the torch frontend
    (reference: spark/torch/estimator.py TorchEstimator).

    optimizer: factory `(params_iter) -> torch.optim.Optimizer`.
    loss: `loss(preds, y[, sample_weight]) -> scalar` (torch ops; the
        third positional arg is passed iff sampleWeightCol is set).
    """

    _kind = "torch"

    def _make_trainer_payload(self) -> dict:
        if self.getModel() is None or self.getOptimizer() is None \
                or self.getLoss() is None:
            raise ValueError("TorchEstimator requires model=, optimizer=, "
                             "loss=")
        return dict(model=self.getModel(), optimizer=self.getOptimizer(),
                    loss=self.getLoss(), metrics=self.getMetrics())

    def _make_model(self, state, metadata, run_id, history) -> "TorchModel":
        return TorchModel(history=history, model=state,
                          featureCols=self.getFeatureCols(),
                          labelCols=self.getLabelCols(),
                          runId=run_id, metadata=metadata)


class TorchModel(HorovodModel):
    """The trained torch module (on the host). `transform` runs a copy of
    it on the card, `cuda:<current device>`, unless
    HOROVOD_WORKER_PLATFORM=cpu asks for the host; with no card and no
    such request it raises. The copy is built once per process and
    device and is not pickled, so `getModel()` and the pickled
    transformer stay on the host."""

    def _device_model(self):
        """(device, the module's eval-mode copy on it) for this process."""
        import copy

        dev = _inference_device()
        built = getattr(self, "_built", None)
        if built is None or built[0] != dev:
            model = copy.deepcopy(self.getModel()).to(dev)
            model.eval()
            self._built = built = (dev, model)
        return built

    def _predict_batch(self, X: np.ndarray) -> np.ndarray:
        import torch

        dev, model = self._device_model()
        with torch.no_grad():
            x = torch.from_numpy(np.array(X, copy=True)).to(dev)
            return model(x).cpu().numpy()

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_built", None)
        return d


def _inference_device():
    import torch

    if worker_device() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        from horovod_tpu_torch.common.exceptions import HorovodError
        raise HorovodError(
            "TorchModel.transform: no CUDA device is visible; set "
            "HOROVOD_WORKER_PLATFORM=cpu to run it on the host")
    return torch.device("cuda", torch.cuda.current_device())


# ======================================================================
# Remote trainer (runs on every worker under the backend)
# ======================================================================

def _remote_train(payload: bytes):
    spec = pickle.loads(payload)
    if spec["kind"] == "torch":
        return _remote_train_torch(spec)
    if spec["kind"] == "keras":
        return _remote_train_keras(spec)
    if spec["kind"] == "lightning":
        return _remote_train_lightning(spec)
    raise ValueError(f"unknown estimator kind {spec['kind']}")


def _load_shards(spec, rank: int, size: int):
    store = spec["store"]
    cols = list(spec["feature_cols"]) + list(spec["label_cols"])
    if spec["sample_weight_col"]:
        cols.append(spec["sample_weight_col"])
    train = sutil.read_shard(store, store.get_train_data_path(
        spec["dataset_idx"]), rank, size, cols)
    val = None
    if spec["val_rows"]:
        val = sutil.read_shard(store, store.get_val_data_path(
            spec["dataset_idx"]), rank, size, cols)
    return train, val


def _batch_weights(b, spec):
    """The sample-weight column of one batch (reference:
    spark/common/params.py sample_weight_col — weights flow into the
    loss), or None when unconfigured."""
    col = spec.get("sample_weight_col")
    if not col:
        return None
    return np.asarray(b[col], np.float32).reshape(-1)


def _local_batch_count(data, batch_size: int) -> int:
    n = len(next(iter(data.values())))
    full = n // batch_size
    return full if full else (1 if n else 0)


def _agree_steps(hvd_allreduce, data, batch_size: int,
                 limit, allow_zero: bool = False) -> int:
    """Global per-epoch step count = MIN over ranks of local batches.

    Parquet shards are near-equal, not exactly equal, so ranks can hold
    different batch counts; every step runs one collective, so all ranks
    MUST agree on the count or the job deadlocks (the reference never hits
    this: its Petastorm readers cycle infinitely and steps_per_epoch is
    explicit, spark/keras/remote.py). One MIN consensus up front pins it.
    Every rank must call this unconditionally — it is itself a collective.
    """
    local = _local_batch_count(data, batch_size)
    agreed = int(np.asarray(hvd_allreduce(
        np.asarray(local, np.int32), op="min")))
    if limit is not None:
        agreed = min(agreed, int(limit))
    if agreed == 0 and not allow_zero:
        raise ValueError(
            "a worker received zero rows — dataset too small for "
            "num_proc; reduce processes or grow the dataset")
    return agreed


def _metric_dict(metrics) -> dict:
    if isinstance(metrics, dict):
        return dict(metrics)
    return {getattr(m, "__name__", f"metric_{i}"): m
            for i, m in enumerate(metrics or [])}


def _epoch_batches(spec, data, epoch: int, batch_size: int, steps: int):
    it = sutil.batch_iter(data, batch_size, spec["shuffle"],
                          spec["shuffle_seed"], epoch)
    for i, b in enumerate(it):
        if i >= steps:
            break
        yield b


def _run_training(spec, train, val, rank, *, allreduce, train_step,
                  eval_batch, metric_fns, on_train_epoch=None,
                  on_eval=None) -> list:
    """Shared epoch driver for all frontends.

    Framework-specific pieces come in as hooks: `allreduce(np_arr, op)`,
    `train_step(batch) -> loss float`, `eval_batch(batch) -> (loss,
    {metric: value})`. Collective counts per epoch are identical on every
    rank by construction: `steps` train collectives + 1 loss mean +
    (if val) 1 val mean + one per metric.
    """
    steps = _agree_steps(allreduce, train, spec["batch_size"],
                         spec["train_steps_per_epoch"])
    val_steps = 0
    if val is not None:
        val_steps = _agree_steps(allreduce, val, spec["val_batch_size"],
                                 spec["val_steps_per_epoch"],
                                 allow_zero=True)
        if val_steps == 0 and rank == 0:
            import sys
            print("[estimator] WARNING: validation was requested but at "
                  "least one rank's validation shard is empty — "
                  "val_loss/val metrics are DISABLED for this run "
                  "(grow the validation split or reduce num_proc)",
                  file=sys.stderr)

    def mean_all(vals) -> float:
        return float(np.asarray(allreduce(
            np.float32(np.mean(vals)), op="average")))

    history = []
    for epoch in range(spec["epochs"]):
        if on_train_epoch:
            on_train_epoch()
        losses = [train_step(b) for b in _epoch_batches(
            spec, train, epoch, spec["batch_size"], steps)]
        row = {"epoch": epoch, "loss": mean_all(losses)}
        if val_steps:
            if on_eval:
                on_eval()
            vlosses, msums = [], {k: [] for k in metric_fns}
            for i, b in enumerate(sutil.batch_iter(
                    val, spec["val_batch_size"], False, 0, 0)):
                if i >= val_steps:
                    break
                vl, mvals = eval_batch(b)
                vlosses.append(vl)
                for k, v in mvals.items():
                    msums[k].append(v)
            row["val_loss"] = mean_all(vlosses)
            for k in metric_fns:
                row[f"val_{k}"] = mean_all(msums[k])
        history.append(row)
        if rank == 0:
            for cb in spec.get("callbacks") or []:
                cb(epoch, dict(row))
            if spec["verbose"]:
                print(f"[estimator] {row}")
    return history


def _save_model(spec, state, history: list) -> None:
    store = spec["store"]
    ckpt_dir = store.get_checkpoint_path(spec["run_id"])
    store.write(posixpath.join(ckpt_dir, _CKPT_FILE),
                _dumps(state))
    store.write_text(posixpath.join(
        store.get_logs_path(spec["run_id"]), "history.json"),
        __import__("json").dumps(history))


def _wrap_torch_optimizer(spec, hvd, model, opt):
    """Shared torch/lightning plumbing: wrap the base optimizer with the
    frontend's DistributedOptimizer honoring the estimator knobs."""
    comp = spec["compression"] or hvd.Compression.none
    return hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters(),
        compression=comp,
        backward_passes_per_step=spec["bpps"],
        op=hvd.Adasum if spec["use_adasum"] else hvd.Average,
        gradient_predivide_factor=spec["predivide"])


def _torch_np_allreduce(hvd):
    """allreduce of a host array through the port: the array goes to the
    collective's device and the result comes back as numpy."""
    import torch

    def np_allreduce(arr, op):
        x = torch.from_numpy(np.array(arr, copy=True)).to(hvd.device())
        return hvd.allreduce(x, op=op).cpu().numpy()
    return np_allreduce


def _remote_train_torch(spec):
    import torch

    import horovod_tpu_torch.frontends.torch as hvd

    hvd.init(device=worker_device())
    rank, size = hvd.rank(), hvd.size()
    dev = hvd.device()
    train, val = _load_shards(spec, rank, size)
    fcols, lcols = spec["feature_cols"], spec["label_cols"]

    t = spec["trainer"]
    model = t["model"].to(dev)
    loss_fn = t["loss"]
    metric_fns = _metric_dict(t.get("metrics"))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = _wrap_torch_optimizer(spec, hvd, model,
                                t["optimizer"](model.parameters()))
    np_allreduce = _torch_np_allreduce(hvd)

    md = spec["metadata"]

    def tensors(b):
        """(x, y, sample weights or None) of one batch, on the device."""
        wb = _batch_weights(b, spec)
        return (torch.from_numpy(_features(b, fcols, md)).to(dev),
                torch.from_numpy(np.asarray(_labels(b, lcols, md))).to(dev),
                None if wb is None else torch.from_numpy(wb).to(dev))

    def train_step(b) -> float:
        xb, yb, wb = tensors(b)
        loss_args = (model(xb), yb) + ((wb,) if wb is not None else ())
        opt.zero_grad()
        loss = loss_fn(*loss_args)
        loss.backward()
        opt.step()
        return float(loss.detach())

    def eval_batch(b):
        with torch.no_grad():
            xv, yv, wv = tensors(b)
            args = (model(xv), yv) + ((wv,) if wv is not None else ())
            preds = args[0]
            return float(loss_fn(*args)), {
                k: float(fn(preds, yv)) for k, fn in metric_fns.items()}

    history = _run_training(spec, train, val, rank,
                            allreduce=np_allreduce,
                            train_step=train_step, eval_batch=eval_batch,
                            metric_fns=metric_fns,
                            on_train_epoch=model.train,
                            on_eval=model.eval)
    if rank == 0:
        # stored on the host, whatever card trained it
        _save_model(spec, model.cpu(), history)
    hvd.barrier()
    hvd.shutdown()
    return history


# ======================================================================
# Keras (TF) estimator
# ======================================================================

class KerasEstimator(HorovodEstimator):
    """Estimator over a compiled tf.keras model (reference:
    spark/keras/estimator.py KerasEstimator).

    model: a built (not necessarily compiled) tf.keras.Model.
    optimizer: a tf.keras optimizer instance (serialized by config).
    loss: a tf.keras loss instance, name string, or callable.

    The model travels as architecture JSON + weights (keras' own
    serialization — cloudpickling live TF objects is fragile), is rebuilt
    on every worker, and trains with gradients reduced through the TF
    frontend's allreduce — the same collective path as
    DistributedGradientTape.
    """

    _kind = "keras"

    def _make_trainer_payload(self) -> dict:
        model = self.getModel()
        if model is None or self.getOptimizer() is None \
                or self.getLoss() is None:
            raise ValueError("KerasEstimator requires model=, optimizer=, "
                             "loss=")
        import tensorflow as tf

        return dict(model_json=model.to_json(),
                    weights=[np.asarray(w) for w in model.get_weights()],
                    optimizer_cfg=tf.keras.optimizers.serialize(
                        self.getOptimizer()),
                    loss=self.getLoss(), metrics=self.getMetrics())

    def _make_model(self, state, metadata, run_id, history) -> "KerasModel":
        return KerasModel(history=history, model=state,
                          featureCols=self.getFeatureCols(),
                          labelCols=self.getLabelCols(),
                          runId=run_id, metadata=metadata)


class KerasModel(HorovodModel):
    """state = {"model_json": ..., "weights": [...]} — rebuilt lazily per
    process, so the transformer itself stays picklable for mapInPandas."""

    def _keras(self):
        import tensorflow as tf

        if getattr(self, "_built", None) is None:
            st = self.getModel()
            m = tf.keras.models.model_from_json(st["model_json"])
            m.set_weights(st["weights"])
            self._built = m
        return self._built

    def _predict_batch(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(self._keras()(X))

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_built", None)
        return d


def _remote_train_keras(spec):
    import tensorflow as tf

    import horovod_tpu_torch.frontends.tensorflow as hvd

    hvd.init(device=worker_device())
    rank = hvd.rank()
    train, val = _load_shards(spec, rank, hvd.size())
    fcols, lcols = spec["feature_cols"], spec["label_cols"]

    t = spec["trainer"]
    model = tf.keras.models.model_from_json(t["model_json"])
    model.set_weights(t["weights"])  # driver weights == rank-0 broadcast
    opt = tf.keras.optimizers.deserialize(t["optimizer_cfg"])
    loss_obj = t["loss"]
    if isinstance(loss_obj, str):
        loss_obj = tf.keras.losses.get(loss_obj)
    # Loss INSTANCES take sample_weight; plain functions (what a name
    # string resolves to) return per-sample values we weight manually.
    loss_takes_sw = isinstance(loss_obj, tf.keras.losses.Loss)

    def weighted_loss(y, preds, w):
        if w is None:
            return tf.reduce_mean(loss_obj(y, preds))
        wt = tf.constant(w)
        if loss_takes_sw:
            return tf.reduce_mean(loss_obj(y, preds, sample_weight=wt))
        return tf.reduce_mean(wt * loss_obj(y, preds))
    metric_fns = _metric_dict(t.get("metrics"))

    # The frontend's gradient fn handles None grads (variables off the
    # loss path), compression, Adasum, and the predivide split — the
    # same path DistributedGradientTape uses.
    from horovod_tpu_torch.common import types as T
    comp = spec["compression"] or hvd.Compression.none
    reduce_grads = hvd._make_allreduce_grads_fn(
        T.ReduceOp.ADASUM if spec["use_adasum"] else T.ReduceOp.AVERAGE,
        spec["predivide"], comp, None)
    bpps = max(1, int(spec["bpps"]))
    accum = {"grads": None, "count": 0}

    def np_allreduce(arr, op):
        return np.asarray(hvd.allreduce(
            tf.constant(np.asarray(arr)), op=op))

    md = spec["metadata"]

    def train_step(b) -> float:
        xb = tf.constant(_features(b, fcols, md))
        yb = tf.constant(np.asarray(_labels(b, lcols, md)))
        wb = _batch_weights(b, spec)
        with tf.GradientTape() as tape:
            loss = weighted_loss(yb, model(xb, training=True), wb)
        grads = tape.gradient(loss, model.trainable_variables)
        if bpps > 1:  # local aggregation (reference:
            # gradient_aggregation.py LocalGradientAggregationHelper)
            if accum["grads"] is None:
                accum["grads"] = [None if g is None else tf.identity(g)
                                  for g in grads]
            else:
                accum["grads"] = [
                    a if g is None else (g if a is None else a + g)
                    for a, g in zip(accum["grads"], grads)]
            accum["count"] += 1
            if accum["count"] < bpps:
                return float(loss)
            grads = [None if a is None else a / bpps
                     for a in accum["grads"]]
            accum["grads"], accum["count"] = None, 0
        grads = reduce_grads(grads)
        opt.apply_gradients(
            (g, v) for g, v in zip(grads, model.trainable_variables)
            if g is not None)
        return float(loss)

    def eval_batch(b):
        xv = tf.constant(_features(b, fcols, md))
        yv = tf.constant(np.asarray(_labels(b, lcols, md)))
        preds = model(xv, training=False)
        wv = _batch_weights(b, spec)
        return float(weighted_loss(yv, preds, wv)), {
            k: float(fn(preds, yv)) for k, fn in metric_fns.items()}

    history = _run_training(spec, train, val, rank,
                            allreduce=np_allreduce,
                            train_step=train_step, eval_batch=eval_batch,
                            metric_fns=metric_fns)
    if rank == 0:
        _save_model(spec, {"model_json": model.to_json(),
                           "weights": [np.asarray(w)
                                       for w in model.get_weights()]},
                    history)
    hvd.barrier()
    hvd.shutdown()
    return history


# ======================================================================
# Lightning estimator
# ======================================================================

class LightningEstimator(HorovodEstimator):
    """Estimator over a LightningModule-style model (reference:
    spark/lightning/estimator.py).

    The model is DUCK-TYPED to the LightningModule training protocol —
    `training_step(batch, batch_idx) -> loss`, `configure_optimizers()
    -> torch optimizer` (optionally `validation_step(batch, idx) ->
    loss-like`) — so pytorch_lightning itself is not required: any
    torch.nn.Module implementing those two methods trains. Batches
    arrive as `(features, labels)` tensor tuples per the estimator data
    contract. `loss`/`optimizer` params are therefore unused here; the
    module supplies both.
    """

    _kind = "lightning"

    def _make_trainer_payload(self) -> dict:
        model = self.getModel()
        if model is None:
            raise ValueError("LightningEstimator requires model=")
        if self.getSampleWeightCol():
            raise ValueError(
                "sample_weight_col is not supported by LightningEstimator: "
                "batches reach training_step as (features, labels) tuples "
                "per the Lightning contract; fold weights into the module "
                "or use TorchEstimator/KerasEstimator")
        for attr in ("training_step", "configure_optimizers"):
            if not callable(getattr(model, attr, None)):
                raise ValueError(
                    f"model must implement {attr}() (LightningModule "
                    f"training protocol)")
        return dict(model=model, metrics=self.getMetrics())

    def _make_model(self, state, metadata, run_id, history) -> "TorchModel":
        return TorchModel(history=history, model=state,
                          featureCols=self.getFeatureCols(),
                          labelCols=self.getLabelCols(),
                          runId=run_id, metadata=metadata)


def _configured_optimizer(configured):
    """Normalize configure_optimizers() return shapes (reference:
    Lightning accepts an optimizer, [optimizers], ([opts], [scheds]),
    or {"optimizer": ..., "lr_scheduler": ...}). One optimizer is
    supported; multi-optimizer (GAN-style) setups are rejected loudly
    rather than silently training only the first."""
    if isinstance(configured, dict):
        if "optimizer" not in configured:
            raise ValueError("configure_optimizers() dict must contain "
                             "an 'optimizer' key")
        return configured["optimizer"]
    if isinstance(configured, (tuple, list)):
        opts = configured[0] if isinstance(configured[0], (tuple, list)) \
            else list(configured)
        opts = [o for o in opts
                if hasattr(o, "param_groups")] or list(opts)
        if len(opts) != 1:
            raise ValueError(
                f"multi-optimizer configure_optimizers() "
                f"({len(opts)} optimizers) is not supported — parameters "
                f"owned by other optimizers would silently never update")
        return opts[0]
    return configured


def _remote_train_lightning(spec):
    import torch

    import horovod_tpu_torch.frontends.torch as hvd

    hvd.init(device=worker_device())
    rank = hvd.rank()
    dev = hvd.device()
    train, val = _load_shards(spec, rank, hvd.size())
    fcols, lcols = spec["feature_cols"], spec["label_cols"]

    t = spec["trainer"]
    model = t["model"].to(dev)
    metric_fns = _metric_dict(t.get("metrics"))
    # Metrics need predictions, i.e. a real forward override (nn.Module's
    # inherited forward raises NotImplementedError) — fail up front, not
    # on the first validation batch of every rank.
    fwd_overridden = type(model).forward is not torch.nn.Module.forward
    if metric_fns and not fwd_overridden:
        raise ValueError(
            "metrics require the model to override forward() so "
            "predictions can be computed")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = _wrap_torch_optimizer(
        spec, hvd, model, _configured_optimizer(
            model.configure_optimizers()))
    np_allreduce = _torch_np_allreduce(hvd)

    # batch_idx is epoch-local per the Lightning contract; the epoch
    # hook resets it.
    step_counter = {"i": 0}

    def on_train_epoch():
        step_counter["i"] = 0
        model.train()

    md = spec["metadata"]

    def to_batch(b):
        return (torch.from_numpy(_features(b, fcols, md)).to(dev),
                torch.from_numpy(np.asarray(_labels(b, lcols, md))).to(dev))

    def train_step(b) -> float:
        opt.zero_grad()
        loss = model.training_step(to_batch(b), step_counter["i"])
        if isinstance(loss, dict):  # lightning allows {"loss": ...}
            loss = loss["loss"]
        loss.backward()
        opt.step()
        step_counter["i"] += 1
        return float(loss.detach())

    has_val_step = callable(getattr(model, "validation_step", None))
    val_counter = {"i": 0}

    def on_eval():
        val_counter["i"] = 0
        model.eval()

    def eval_batch(b):
        with torch.no_grad():
            xb, yb = to_batch(b)
            idx = val_counter["i"]
            val_counter["i"] += 1
            if has_val_step:
                out = model.validation_step((xb, yb), idx)
                vl = float(out["loss"] if isinstance(out, dict) else out)
            else:
                vl = float(model.training_step((xb, yb), idx))
            if not metric_fns:  # loss already forwarded the batch once
                return vl, {}
            preds = model(xb)
            return vl, {k: float(fn(preds, yb))
                        for k, fn in metric_fns.items()}

    history = _run_training(spec, train, val, rank,
                            allreduce=np_allreduce,
                            train_step=train_step, eval_batch=eval_batch,
                            metric_fns=metric_fns,
                            on_train_epoch=on_train_epoch,
                            on_eval=on_eval)
    if rank == 0:
        # stored on the host, whatever card trained it
        _save_model(spec, model.cpu(), history)
    hvd.barrier()
    hvd.shutdown()
    return history
