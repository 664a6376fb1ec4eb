"""The port's estimator stack (horovod_tpu_torch/spark/: store, params,
util, backend, estimator) held against the JAX package's on the same
seeded data.

* Store, params and prepared parquet: the same paths, accessors, rows,
  shards and metadata; a dataset prepared by either package is read by
  the other.
* TorchEstimator, LightningEstimator and KerasEstimator fit and
  transform in both packages from the same initial weights and data
  order. Both fits run in this process through an in-process backend:
  the JAX package's in its 8-replica world (every replica the same, so
  its averages are the local values), the port's in a gloo world of one
  (HOROVOD_WORKER_PLATFORM=cpu, the CPU request). Weights after training
  must agree within TOL (1e-5 of the largest weight; f32 updates in the
  same order, so the torch fits agree to the bit and the Keras fits to
  an ulp or two of the 8-way average). The JAX package's JaxEstimator
  cases (image features with int labels, sample weights, fit_on_parquet
  reuse, uneven shards, metrics and callbacks) run through
  TorchEstimator.
* Real worlds of two: `LocalBackend(2, use_cpu=True)` workers form one
  gloo ring and train on uneven shards; without the CPU request a
  LocalBackend worker asks for the card and, on a host without one,
  raises in hvd.init naming the missing card. TorchModel.transform
  likewise takes the card unless the CPU is requested, through a copy
  of the module kept out of the pickle: getModel() stays on the host.

Functions shipped to launched workers are closures or lambdas, which
cloudpickle sends by value (the workers cannot import this module).
"""

import concurrent.futures
import copy
import pickle
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch

import horovod_tpu.spark as jspark
from horovod_tpu.spark import util as jutil
from horovod_tpu.spark.backend import Backend as JBackend
from horovod_tpu_torch.common.exceptions import HorovodError
import horovod_tpu_torch.spark as tspark
from horovod_tpu_torch.runner.results import RemoteJobError
from horovod_tpu_torch.spark import util as tutil
from horovod_tpu_torch.spark.backend import Backend as TBackend
from horovod_tpu_torch.spark.params import EstimatorParams, ModelParams
from horovod_tpu_torch.spark.store import LocalStore, Store
from test_estimator import _StubDF, _toy_df, stub_pyspark_sql  # noqa: F401

TOL = 1e-5  # |Δw| over the largest |w| after training, port vs JAX
FEATS = ["f0", "f1", "f2", "f3"]


class _JaxInProcess(JBackend):
    """The JAX package's trainer in this process (its 8-replica world)."""

    def num_processes(self):
        return 1

    def run(self, fn, args=(), env=None):
        return [fn(*args)]


class _PortInProcess(TBackend):
    """The port's trainer in this process (a gloo world of one)."""

    def num_processes(self):
        return 1

    def run(self, fn, args=(), env=None):
        return [fn(*args)]


@pytest.fixture()
def cpu_request(monkeypatch):
    monkeypatch.setenv("HOROVOD_WORKER_PLATFORM", "cpu")


def _fit_both(cls_name, tmp_path, df, model, **kw):
    """(JAX fitted model, port fitted model) of one estimator class from
    the same initial model and data."""
    out = []
    for pkg, backend, tag in ((jspark, _JaxInProcess(), "jax"),
                              (tspark, _PortInProcess(), "port")):
        est = getattr(pkg, cls_name)(
            model=copy.deepcopy(model), backend=backend, verbose=0,
            store=pkg.LocalStore(str(tmp_path / tag)), **kw)
        out.append(est.fit(df))
    return out


def _close_torch(a: torch.nn.Module, b: torch.nn.Module, tol=TOL):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        x, y = sa[k].detach().float(), sb[k].detach().float()
        scale = max(float(x.abs().max()), 1e-6)
        assert float((x - y).abs().max()) <= tol * scale, k


def _mse(preds, y):
    return ((preds.squeeze(-1) - y) ** 2).mean()


def _sgd(lr):
    return lambda ps: torch.optim.SGD(ps, lr=lr)


# ----------------------------------------------------------------------
# Store and params
# ----------------------------------------------------------------------

def test_store_paths_and_io_match_the_jax_store(tmp_path):
    t, j = Store.create(str(tmp_path / "st")), \
        jspark.Store.create(str(tmp_path / "st"))
    assert isinstance(t, LocalStore) or type(t).__name__ == \
        "FilesystemStore"
    for name in ("get_train_data_path", "get_val_data_path",
                 "get_test_data_path"):
        assert getattr(t, name)(3) == getattr(j, name)(3)
    assert t.get_checkpoint_path("r1") == j.get_checkpoint_path("r1")
    assert t.get_logs_path("r1") == j.get_logs_path("r1")
    t.write(t.get_checkpoint_path("r1") + "/m.bin", b"hello")
    assert j.read(j.get_checkpoint_path("r1") + "/m.bin") == b"hello"
    assert t.exists(t.get_checkpoint_path("r1") + "/m.bin")
    assert not t.is_parquet_dataset(t.get_train_data_path(0))


def test_hdfs_store_keeps_absolute_path():
    from horovod_tpu_torch.spark.store import HDFSStore

    # hdfs:///user/me (default namenode), not hdfs://user/me; fsspec's
    # hdfs driver needs libhdfs at run time, so only the URL is checked.
    try:
        assert HDFSStore("/user/me/data").prefix_path.startswith(
            "hdfs:///user")
    except (ImportError, OSError):
        path = "/user/me/data"
        assert ("hdfs:///" + path.lstrip("/")).startswith("hdfs:///user")


def test_params_accessors_and_copy():
    from horovod_tpu.spark.params import EstimatorParams as JParams
    assert EstimatorParams._defaults == JParams._defaults
    p = EstimatorParams(batchSize=16, epochs=3)
    assert p.getBatchSize() == 16
    p.setBatchSize(64).setEpochs(5)
    assert p.getBatchSize() == 64 and p.getEpochs() == 5
    assert p.getNumProc() is None  # snake_case param, camel accessor
    with pytest.raises(ValueError, match="unknown estimator params"):
        EstimatorParams(bogusKnob=1)
    with pytest.raises(AttributeError):
        p.getNoSuchParam()
    q = p.copy({"epochs": 9})
    assert p.getEpochs() == 5 and q.getEpochs() == 9
    with pytest.raises(ValueError, match="unknown params"):
        p.copy({"epoochs": 5})
    assert ModelParams(batchSize=7).getBatchSize() == 7


def test_model_copy_preserves_history():
    from horovod_tpu_torch.spark.estimator import HorovodModel
    m = HorovodModel(history=[{"loss": 1.0}], batchSize=8)
    m2 = m.copy({"batchSize": 64})
    assert m2.history == [{"loss": 1.0}]
    assert m2.getBatchSize() == 64 and m.getBatchSize() == 8


def test_multi_output_split_requires_divisibility():
    from horovod_tpu_torch.spark.estimator import HorovodModel

    class M(HorovodModel):
        def _predict_batch(self, X):
            return np.ones((len(X), 5), np.float32)

    m = M(featureCols=["f0"], labelCols=["a", "b"], batchSize=4)
    with pytest.raises(ValueError, match="not\\s+divisible"):
        m._transform_pandas(pd.DataFrame({"f0": np.ones(3, np.float32)}))


# ----------------------------------------------------------------------
# Prepared parquet: the same files both ways
# ----------------------------------------------------------------------

def _read_all(util, store, idx, n, cols):
    path = store.get_train_data_path(idx)
    return [util.read_shard(store, path, r, n, cols) for r in range(n)]


@pytest.mark.parametrize("preparer", ["port", "jax"])
def test_prepared_parquet_is_the_same_for_both_packages(tmp_path, preparer):
    df = _toy_df(n=50)
    util = tutil if preparer == "port" else jutil
    store = LocalStore(str(tmp_path))
    with util.prepare_data(2, store, df, label_columns=["label"],
                           feature_columns=FEATS, validation=0.2) as idx:
        pass
    got_t = tutil.get_simple_meta_from_parquet(store, dataset_idx=idx)
    got_j = jutil.get_simple_meta_from_parquet(store, dataset_idx=idx)
    assert got_t == got_j
    tr, vr, meta, row_bytes = got_t
    assert (tr, vr) == (40, 10) and row_bytes > 0
    assert meta["label"]["dtype"] == "float32"
    assert store.is_parquet_dataset(store.get_train_data_path(idx))
    a = _read_all(tutil, store, idx, 2, ["label"])
    b = _read_all(jutil, store, idx, 2, ["label"])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["label"], y["label"])
    got = np.sort(np.concatenate([s["label"] for s in a]))
    np.testing.assert_array_equal(got, np.sort(df["label"].values[:40]))


def test_prepare_data_validation_col(tmp_path):
    df = _toy_df(n=30)
    df["is_val"] = ([False] * 24) + ([True] * 6)
    store = LocalStore(str(tmp_path))
    with tutil.prepare_data(1, store, df, label_columns=["label"],
                            feature_columns=FEATS,
                            validation="is_val") as idx:
        tr, vr, _, _ = tutil.get_simple_meta_from_parquet(
            store, dataset_idx=idx)
    assert (tr, vr) == (24, 6)


def test_batch_iter_order_matches_jax():
    data = {"x": np.arange(20)}
    for epoch in (1, 2):
        a = [b["x"].tolist() for b in
             tutil.batch_iter(data, 5, True, seed=7, epoch=epoch)]
        b = [b["x"].tolist() for b in
             jutil.batch_iter(data, 5, True, seed=7, epoch=epoch)]
        assert a == b
        assert sorted(sum(a, [])) == list(range(20))
    assert [b["x"].tolist() for b in tutil.batch_iter(
        data, 5, True, seed=7, epoch=1)] != \
        [b["x"].tolist() for b in tutil.batch_iter(
            data, 5, True, seed=7, epoch=2)]


def test_vector_cells_via_toarray(tmp_path):
    class FakeVector:
        def __init__(self, values):
            self._v = np.asarray(values, np.float64)

        def toArray(self):
            return self._v

    rng = np.random.default_rng(5)
    X = rng.normal(size=(32, 3))
    y = (X @ [1.0, -2.0, 0.5]).astype(np.float32)
    df = pd.DataFrame({"feat": [FakeVector(r) for r in X], "label": y})
    store = LocalStore(str(tmp_path))
    with tutil.prepare_data(2, store, df, label_columns=["label"],
                            feature_columns=["feat"]) as idx:
        rows, _, md, _ = tutil.get_simple_meta_from_parquet(
            store, dataset_idx=idx)
    assert rows == 32 and md["feat"]["shape"] == [3]
    shard = tutil.read_shard(store, store.get_train_data_path(idx), 0, 1,
                             ["feat", "label"])
    restored = tutil.restore_column(shard["feat"], md["feat"])
    assert restored.shape == (32, 3)
    np.testing.assert_array_equal(
        restored, jutil.restore_column(shard["feat"], md["feat"]))
    np.testing.assert_allclose(np.sort(restored[:, 0]), np.sort(X[:, 0]),
                               rtol=1e-6)


def test_read_shard_never_duplicates_files(tmp_path):
    store = LocalStore(str(tmp_path))
    with tutil.prepare_data(2, store, _toy_df(n=12),
                            label_columns=["label"],
                            feature_columns=FEATS) as idx:
        shards = _read_all(tutil, store, idx, 4, ["label"])
    assert len(np.concatenate([s["label"] for s in shards])) == 12
    assert any(len(s["label"]) == 0 for s in shards[2:])
    assert "label" in shards[3]


# ----------------------------------------------------------------------
# pyspark paths under the JAX tests' stub
# ----------------------------------------------------------------------

def test_pyspark_prepare_data_writes_from_cluster(tmp_path,
                                                  stub_pyspark_sql):
    store = LocalStore(str(tmp_path))
    df = _StubDF(_toy_df(n=40), store)
    with tutil.prepare_data(2, store, df, label_columns=["label"],
                            feature_columns=FEATS, validation=0.25) as idx:
        tr, vr, meta, _ = tutil.get_simple_meta_from_parquet(
            store, dataset_idx=idx)
    assert tr == 30 and vr == 10
    assert store.is_parquet_dataset(store.get_train_data_path(idx))
    assert meta["f0"]["dtype"] == "float32"


def test_pyspark_prepare_data_validation_col(tmp_path, stub_pyspark_sql):
    store = LocalStore(str(tmp_path))
    pdf = _toy_df(n=20)
    pdf["isv"] = ([False] * 15) + ([True] * 5)
    with tutil.prepare_data(1, store, _StubDF(pdf, store),
                            label_columns=["label"], feature_columns=FEATS,
                            validation="isv") as idx:
        tr, vr, _, _ = tutil.get_simple_meta_from_parquet(
            store, dataset_idx=idx)
    assert (tr, vr) == (15, 5)


def test_pyspark_transform_builds_schema(tmp_path, stub_pyspark_sql,
                                         cpu_request):
    lin = torch.nn.Linear(4, 1, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor([[1.0, 0.0, 0.0, 0.0]]))
    model = tspark.TorchModel(model=lin, featureCols=FEATS,
                              labelCols=["label"], batchSize=16)
    store = LocalStore(str(tmp_path))
    pdf = model.transform(_StubDF(_toy_df(n=12), store)).toPandas()
    assert "label__output" in pdf.columns
    np.testing.assert_allclose(pdf["label__output"].values,
                               _toy_df(n=12)["f0"].values, rtol=1e-6)


def test_backend_defaults_to_spark_when_session_active(monkeypatch):
    class _SC:
        defaultParallelism = 4
        _active_spark_context = None

    _SC._active_spark_context = _SC()
    mod = types.ModuleType("pyspark")
    mod.SparkContext = _SC
    monkeypatch.setitem(sys.modules, "pyspark", mod)
    backend = tspark.TorchEstimator()._get_or_create_backend()
    assert isinstance(backend, tspark.SparkBackend)
    assert backend.num_processes() == 4


# ----------------------------------------------------------------------
# Fits against the JAX package's
# ----------------------------------------------------------------------

def test_torch_estimator_fit_transform_matches_jax(tmp_path, cpu_request):
    torch.manual_seed(0)
    df = _toy_df()
    jf, tf_ = _fit_both("TorchEstimator", tmp_path, df,
                        torch.nn.Linear(4, 1), optimizer=_sgd(0.1),
                        loss=_mse, featureCols=FEATS, labelCols=["label"],
                        batchSize=16, epochs=8, validation=0.25)
    _close_torch(jf.getModel(), tf_.getModel())
    assert [h["loss"] for h in tf_.history] == pytest.approx(
        [h["loss"] for h in jf.history], rel=TOL)
    assert tf_.history[-1]["loss"] < tf_.history[0]["loss"]
    assert "val_loss" in tf_.history[-1]
    out_t = tf_.transform(df.head(20))
    out_j = jf.transform(df.head(20))
    np.testing.assert_allclose(out_t["label__output"].values,
                               out_j["label__output"].values, rtol=TOL,
                               atol=TOL)
    err = np.mean((out_t["label__output"].values
                   - df["label"].values[:20]) ** 2)
    assert err < 1.0, err


def _image_data(n=64, n_classes=3):
    rng = np.random.default_rng(3)
    labels = rng.integers(0, n_classes, n)
    imgs = [rng.normal(loc=float(c), scale=0.1,
                       size=(8, 8, 1)).astype(np.float32) for c in labels]
    return pd.DataFrame({"img": imgs, "label": labels.astype(np.int64)}), \
        labels


class _ImageNet(torch.nn.Module):
    """A linear classifier that checks the data contract: images arrive
    shaped (B, 8, 8, 1) in f32 and class labels as integers."""

    def __init__(self, n_classes=3):
        super().__init__()
        self.lin = torch.nn.Linear(64, n_classes)

    def forward(self, x):
        assert tuple(x.shape[1:]) == (8, 8, 1), x.shape
        assert x.dtype == torch.float32
        return self.lin(x.reshape(x.shape[0], -1))


def _xent(preds, y):
    assert not y.is_floating_point(), y.dtype
    return torch.nn.functional.cross_entropy(preds, y)


def test_image_features_int_labels_match_jax(tmp_path, cpu_request):
    df, labels = _image_data()
    torch.manual_seed(1)
    jf, tf_ = _fit_both("TorchEstimator", tmp_path, df, _ImageNet(),
                        optimizer=lambda ps: torch.optim.Adam(ps, lr=0.05),
                        loss=_xent, featureCols=["img"],
                        labelCols=["label"], batchSize=16, epochs=12)
    _close_torch(jf.getModel(), tf_.getModel())
    md = tf_.getMetadata()
    assert md == jf.getMetadata()
    assert md["img"]["shape"] == [8, 8, 1]
    assert np.dtype(md["label"]["dtype"]).kind == "i"
    preds = np.stack(tf_.transform(df.head(12))["label__output"].to_list())
    assert preds.shape == (12, 3)
    assert float(np.mean(np.argmax(preds, 1) == labels[:12])) > 0.8


def test_sample_weights_reach_the_loss_as_in_jax(tmp_path, cpu_request):
    rng = np.random.default_rng(11)
    n, d = 96, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = np.array([2.0, -1.0, 0.5], np.float32)
    y = X @ w_true
    w_col = np.ones(n, np.float32)
    bad = rng.choice(n, n // 2, replace=False)
    y[bad] = rng.normal(scale=50.0, size=n // 2)  # garbage, weight 0
    w_col[bad] = 0.0
    df = pd.DataFrame({**{f"f{i}": X[:, i] for i in range(d)},
                       "label": y, "w": w_col})

    def loss(preds, yb, wb):
        return (wb * (preds.squeeze(-1) - yb) ** 2).sum() / \
            wb.sum().clamp_min(1e-6)

    lin = torch.nn.Linear(d, 1, bias=False)
    torch.nn.init.zeros_(lin.weight)
    jf, tf_ = _fit_both("TorchEstimator", tmp_path, df, lin,
                        optimizer=lambda ps: torch.optim.Adam(ps, lr=0.1),
                        loss=loss, featureCols=[f"f{i}" for i in range(d)],
                        labelCols=["label"], sampleWeightCol="w",
                        batchSize=48, epochs=60)
    _close_torch(jf.getModel(), tf_.getModel())
    np.testing.assert_allclose(
        tf_.getModel().weight.detach().numpy()[0], w_true, atol=0.25)


def test_metrics_and_callbacks_reach_history(tmp_path, cpu_request):
    marker = tmp_path / "cb.log"

    def on_epoch(epoch, logs, _p=str(marker)):
        with open(_p, "a") as f:
            f.write(f"{epoch}:{logs['loss']:.4f}\n")

    def mae(preds, y):
        return (preds.squeeze(-1) - y).abs().mean()

    torch.manual_seed(2)
    jf, tf_ = _fit_both(
        "TorchEstimator", tmp_path, _toy_df(n=64), torch.nn.Linear(4, 1),
        optimizer=lambda ps: torch.optim.Adam(ps, lr=0.1), loss=_mse,
        metrics=[mae], featureCols=FEATS, labelCols=["label"],
        batchSize=8, epochs=3, validation=0.25, valBatchSize=4,
        callbacks=[on_epoch])
    _close_torch(jf.getModel(), tf_.getModel())
    assert [h["val_mae"] for h in tf_.history] == pytest.approx(
        [h["val_mae"] for h in jf.history], rel=TOL)
    assert tf_.history[-1]["val_mae"] < tf_.history[0]["val_mae"]
    lines = marker.read_text().strip().splitlines()
    assert len(lines) == 6  # three from each package's rank 0
    assert lines[:3] == lines[3:] and lines[0].startswith("0:")


def test_fit_on_parquet_trains_on_jax_prepared_data(tmp_path, cpu_request):
    store = LocalStore(str(tmp_path))
    with jutil.prepare_data(1, store, _toy_df(n=32),
                            label_columns=["label"], feature_columns=FEATS):
        pass
    est = tspark.TorchEstimator(
        model=torch.nn.Linear(4, 1), optimizer=_sgd(0.05), loss=_mse,
        featureCols=FEATS, labelCols=["label"], store=store, batchSize=8,
        epochs=2, backend=_PortInProcess(), verbose=0)
    assert len(est.fit_on_parquet().history) == 2


class _LinReg(torch.nn.Module):
    """LightningModule protocol, duck-typed on a plain module."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 1)

    def forward(self, x):
        return self.lin(x).squeeze(-1)

    def training_step(self, batch, batch_idx):
        x, y = batch
        return ((self(x) - y) ** 2).mean()

    def validation_step(self, batch, batch_idx):
        x, y = batch
        return {"loss": ((self(x) - y) ** 2).mean()}

    def configure_optimizers(self):
        return torch.optim.SGD(self.parameters(), lr=0.1)


def test_lightning_estimator_matches_jax(tmp_path, cpu_request):
    torch.manual_seed(3)
    df = _toy_df()
    jf, tf_ = _fit_both("LightningEstimator", tmp_path, df, _LinReg(),
                        featureCols=FEATS, labelCols=["label"],
                        batchSize=16, epochs=8, validation=0.25)
    _close_torch(jf.getModel(), tf_.getModel())
    assert tf_.history[-1]["loss"] < tf_.history[0]["loss"]
    assert "val_loss" in tf_.history[-1]
    assert len(tf_.transform(df.head(6))["label__output"]) == 6


def test_lightning_validates_protocol_and_weights(tmp_path):
    est = tspark.LightningEstimator(
        model=object(), featureCols=["f0"], labelCols=["label"],
        store=LocalStore(str(tmp_path)), backend=_PortInProcess())
    with pytest.raises(ValueError, match="training_step"):
        est.fit(_toy_df())

    class M:
        def training_step(self, b, i):
            pass

        def configure_optimizers(self):
            pass

    with pytest.raises(ValueError, match="sample_weight_col"):
        tspark.LightningEstimator(
            model=M(), sampleWeightCol="w", featureCols=["f"],
            labelCols=["y"])._make_trainer_payload()


def test_configured_optimizer_shapes():
    from horovod_tpu_torch.spark.estimator import _configured_optimizer

    lin = torch.nn.Linear(2, 1)
    opt = torch.optim.SGD(lin.parameters(), lr=0.1)
    sched = object()
    assert _configured_optimizer(opt) is opt
    assert _configured_optimizer([opt]) is opt
    assert _configured_optimizer(([opt], [sched])) is opt
    assert _configured_optimizer(
        {"optimizer": opt, "lr_scheduler": sched}) is opt
    with pytest.raises(ValueError, match="multi-optimizer"):
        _configured_optimizer(
            [opt, torch.optim.SGD(lin.parameters(), lr=0.2)])
    with pytest.raises(ValueError, match="'optimizer' key"):
        _configured_optimizer({"lr_scheduler": sched})


def test_estimator_param_validation(tmp_path):
    est = tspark.TorchEstimator(store=LocalStore(str(tmp_path)),
                                featureCols=["f0"], labelCols=["label"],
                                backend=_PortInProcess())
    with pytest.raises(ValueError, match="requires model"):
        est.fit(_toy_df())
    with pytest.raises(ValueError, match="at most one"):
        tspark.TorchEstimator(
            num_proc=2, backend=_PortInProcess())._get_or_create_backend()
    with pytest.raises(ValueError, match="requires store"):
        tspark.TorchEstimator(model=1, optimizer=object(),
                              loss=object()).fit(_toy_df())
    assert not hasattr(tspark, "JaxEstimator")


def test_agree_steps_takes_the_min_and_refuses_zero_rows():
    from horovod_tpu_torch.spark.estimator import _agree_steps

    def fake_allreduce(x, op):
        return x  # a world of one: min == local

    with pytest.raises(ValueError, match="zero rows"):
        _agree_steps(fake_allreduce, {"x": np.zeros((0,))}, 4, None)
    assert _agree_steps(fake_allreduce, {"x": np.zeros((10,))}, 4,
                        None) == 2
    assert _agree_steps(fake_allreduce, {"x": np.zeros((10,))}, 4, 1) == 1
    assert _agree_steps(fake_allreduce, {"x": np.zeros((3,))}, 4,
                        None) == 1


# ----------------------------------------------------------------------
# Keras
# ----------------------------------------------------------------------

def _keras_pair(tmp_path, df, model, **kw):
    jf, tf_ = _fit_both("KerasEstimator", tmp_path, df, model, **kw)
    for a, b in zip(jf.getModel()["weights"], tf_.getModel()["weights"]):
        scale = max(float(np.max(np.abs(a))), 1e-6)
        assert float(np.max(np.abs(a - b))) <= TOL * scale
    return jf, tf_


def test_keras_estimator_fit_transform_matches_jax(tmp_path, cpu_request):
    keras = pytest.importorskip("keras")
    keras.utils.set_random_seed(0)
    model = keras.Sequential([keras.layers.Input(shape=(4,)),
                              keras.layers.Dense(1, use_bias=False)])
    df = _toy_df()
    jf, tf_ = _keras_pair(tmp_path, df, model,
                          optimizer=keras.optimizers.SGD(learning_rate=0.1),
                          loss="mse", featureCols=FEATS,
                          labelCols=["label"], batchSize=16, epochs=8,
                          validation=0.25)
    assert tf_.history[-1]["loss"] < tf_.history[0]["loss"]
    assert "val_loss" in tf_.history[-1]
    out = tf_.transform(df.head(12))
    assert len(out["label__output"]) == 12
    import cloudpickle  # the mapInPandas contract: the model pickles
    clone = cloudpickle.loads(cloudpickle.dumps(tf_))
    np.testing.assert_allclose(
        clone.transform(df.head(5))["label__output"].values,
        out["label__output"].values[:5], rtol=1e-6)


def test_keras_string_loss_with_weights_matches_jax(tmp_path, cpu_request):
    keras = pytest.importorskip("keras")
    keras.utils.set_random_seed(1)
    rng = np.random.default_rng(4)
    n = 48
    X = rng.normal(size=(n, 2)).astype(np.float32)
    y = (X @ [1.0, -1.0]).astype(np.float32)
    w = np.ones(n, np.float32)
    bad = rng.choice(n, n // 2, replace=False)
    y2 = y.copy()
    y2[bad] = 30.0
    w[bad] = 0.0
    df = pd.DataFrame({"f0": X[:, 0], "f1": X[:, 1], "label": y2, "w": w})
    model = keras.Sequential([keras.layers.Input((2,)),
                              keras.layers.Dense(1, use_bias=False)])
    _, tf_ = _keras_pair(tmp_path, df, model,
                         optimizer=keras.optimizers.Adam(0.05), loss="mse",
                         featureCols=["f0", "f1"], labelCols=["label"],
                         sampleWeightCol="w", batchSize=24, epochs=30)
    out = tf_.transform(df.head(8))
    assert np.mean(np.abs(out["label__output"].values - y[:8])) < 1.5


# ----------------------------------------------------------------------
# Launched worlds, the card default and the CPU request
# ----------------------------------------------------------------------

def _ring_probe():
    def probe():
        import torch

        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.spark.backend import worker_device

        hvd.init(device=worker_device())
        try:
            s = int(hvd.allreduce(torch.tensor(hvd.rank() + 1),
                                  op=hvd.Sum).item())
            import torch.distributed as dist
            return hvd.rank(), hvd.size(), s, dist.get_backend()
        finally:
            hvd.shutdown()
    return probe


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """This module's three launched jobs, started together at the first
    test that reads one and run side by side (each is mostly its
    workers' start-up): a LocalBackend(2) ring with the CPU request, a
    LocalBackend(1) worker without it, and the uneven-shards fit. The
    futures by name."""
    est = tspark.TorchEstimator(
        model=torch.nn.Linear(4, 1), optimizer=lambda ps: torch.optim.SGD(
            ps, lr=0.05),
        loss=lambda p, y: ((p.squeeze(-1) - y) ** 2).mean(),
        featureCols=FEATS, labelCols=["label"],
        store=LocalStore(str(tmp_path_factory.mktemp("uneven"))),
        batchSize=4, epochs=2,
        backend=tspark.LocalBackend(2, use_cpu=True), verbose=0)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        yield {
            "ring": pool.submit(tspark.LocalBackend(2, use_cpu=True).run,
                                _ring_probe()),
            "card": pool.submit(tspark.LocalBackend(1).run, _ring_probe()),
            "uneven": pool.submit(est.fit, _toy_df(n=23))}


def test_local_backend_workers_form_one_gloo_ring_on_request(launched):
    got = launched["ring"].result(timeout=120)
    assert got == [(0, 2, 3, "gloo"), (1, 2, 3, "gloo")]


def test_local_backend_workers_ask_for_the_card_by_default(launched):
    with pytest.raises(RemoteJobError,
                       match="no CUDA device is visible") as ei:
        launched["card"].result(timeout=120)
    assert "rank 0 failed" in str(ei.value)


def test_uneven_shards_train_in_a_launched_world(launched):
    """23 rows over 2 ranks: shards of 11 and 12, 2 and 3 local batches
    of 4. The MIN-consensus step count keeps the collectives aligned."""
    m = launched["uneven"].result(timeout=120)
    assert len(m.history) == 2 and np.isfinite(m.history[-1]["loss"])


def test_transform_takes_the_card_unless_asked_for_the_cpu(monkeypatch):
    model = tspark.TorchModel(model=torch.nn.Linear(4, 1),
                              featureCols=FEATS, labelCols=["label"],
                              batchSize=8)
    monkeypatch.delenv("HOROVOD_WORKER_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(HorovodError, match="no CUDA device is visible"):
        model.transform(_toy_df(n=4))
    monkeypatch.setenv("HOROVOD_WORKER_PLATFORM", "cpu")
    assert len(model.transform(_toy_df(n=4))["label__output"]) == 4


def test_transform_leaves_the_stored_module_on_the_host(monkeypatch):
    """transform runs a copy of the module, built once per device and
    left out of the pickle; getModel() stays the same host module, in
    its own training mode."""
    lin = torch.nn.Linear(4, 1)
    model = tspark.TorchModel(model=lin, featureCols=FEATS,
                              labelCols=["label"], batchSize=8)
    monkeypatch.setenv("HOROVOD_WORKER_PLATFORM", "cpu")
    first = model.transform(_toy_df(n=4))["label__output"].values
    dev, copy_ = model._built
    assert model.getModel() is lin and lin.training
    assert copy_ is not lin and not copy_.training
    assert dev == torch.device("cpu")
    model.transform(_toy_df(n=4))
    assert model._built[1] is copy_
    back = pickle.loads(pickle.dumps(model))
    assert "_built" not in back.__dict__
    np.testing.assert_array_equal(
        back.transform(_toy_df(n=4))["label__output"].values, first)
