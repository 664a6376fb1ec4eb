"""horovod_tpu_torch.checkpoint against tests/test_checkpoint.py's seven
cases: round trips through rank 0's save, the params-only restore, the
fail-fast of an uninitialized save with peers in the env, a missing
and a custom key, the elastic state's disk anchor, CheckpointCallback
every N batches, and the anchor of the committed (not the live) state.
Where the JAX module decides the same thing (the peer env, the latest
step, the marker), both decide on the same inputs.
"""

import numpy as np
import pytest
import torch

from horovod_tpu import checkpoint as jckpt
from horovod_tpu.ckpt import manifest as jmf
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.elastic import TorchState


@pytest.fixture
def world(monkeypatch):
    """A world of one on gloo."""
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
              "HOROVOD_LOCAL_SIZE", "HOROVOD_COORDINATOR_ADDR",
              "HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_ELASTIC"):
        monkeypatch.delenv(k, raising=False)
    topology.init(device="cpu")
    yield
    topology.shutdown()


def test_save_restore_roundtrip(world, tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3), "step": np.int64(7)}
    path = str(tmp_path / "ck")
    ckpt.save(path, tree)
    assert jmf.has_done_marker(path)  # the JAX package sees the commit
    got = ckpt.restore(path, like=tree)
    assert torch.equal(got["w"], tree["w"])
    assert torch.equal(got["b"], torch.ones(3))
    assert int(got["step"]) == 7 and isinstance(got["step"], np.int64)


def test_restore_params_only_no_optimizer(tmp_path):
    """A serving replica loads a training checkpoint weights-only, and
    save/restore work without an initialized world."""
    params = {"w": torch.arange(4, dtype=torch.float32),
              "b": np.float32(0.5)}
    opt = {"mu": {"w": torch.ones(4)}, "count": np.int64(7)}
    path = str(tmp_path / "train_ck")
    ckpt.save(path, {"params": params, "opt": opt})
    like = {"w": torch.zeros(4), "b": np.float32(0)}
    got = ckpt.restore_params(path, like=like)
    assert set(got) == {"w", "b"}
    assert torch.equal(got["w"], torch.arange(4, dtype=torch.float32))
    assert float(got["b"]) == 0.5
    assert isinstance(got["b"], np.generic)


def test_save_fails_fast_uninit_with_peer_env(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt.topology, "rank_or_none", lambda: None)
    path = str(tmp_path / "ck")
    tree = {"x": torch.zeros(2)}

    monkeypatch.setenv("HOROVOD_SIZE", "2")
    with pytest.raises(RuntimeError, match="before hvd.init"):
        ckpt.save(path, tree)
    assert ckpt._peer_env() == jckpt._peer_env() is True
    monkeypatch.setenv("HOROVOD_SIZE", "1")
    monkeypatch.setenv("HOROVOD_RANK", "1")
    with pytest.raises(RuntimeError, match="multi-process"):
        ckpt.save(path, tree)
    assert ckpt._peer_env() == jckpt._peer_env() is True
    monkeypatch.setenv("HOROVOD_SIZE", "nonsense")
    monkeypatch.setenv("HOROVOD_RANK", "0")
    with pytest.raises(RuntimeError):  # unparseable: refuse, not race
        ckpt.save(path, tree)
    assert ckpt._peer_env() == jckpt._peer_env() is True

    monkeypatch.setenv("HOROVOD_SIZE", "1")
    ckpt.save(path, tree)
    assert ckpt._peer_env() == jckpt._peer_env() is False
    monkeypatch.delenv("HOROVOD_SIZE")
    monkeypatch.delenv("HOROVOD_RANK")
    ckpt.save(path, tree)
    assert torch.equal(ckpt.restore(path)["x"], torch.zeros(2))


def test_restore_params_missing_and_custom_key(tmp_path):
    path = str(tmp_path / "ck_weights")
    ckpt.save(path, {"weights": {"w": torch.ones(2)}})
    with pytest.raises(KeyError, match="has no 'params' subtree"):
        ckpt.restore_params(path)
    got = ckpt.restore_params(path, key="weights")
    assert torch.equal(got["w"], torch.ones(2))


def test_elastic_state_disk_anchor(world, tmp_path):
    root = str(tmp_path / "run")
    model = torch.nn.Linear(4, 1)
    state = TorchState(model=model, epoch=0)
    with torch.no_grad():
        model.weight.fill_(5.0)
    state.epoch = 3
    state.commit()
    ckpt.save_state(root, state, step=30)
    assert ckpt.latest_step(root) == 30 == jckpt.latest_step(root)

    # A FRESH state (a new process after a crash) restores from disk.
    fresh_model = torch.nn.Linear(4, 1)
    fresh = TorchState(model=fresh_model, epoch=0)
    step = ckpt.restore_state(root, fresh)
    assert step == 30
    assert torch.all(fresh_model.weight == 5.0)
    assert fresh.epoch == 3

    with pytest.raises(FileNotFoundError):
        ckpt.restore_state(str(tmp_path / "nope"), fresh)
    assert jckpt.latest_step(str(tmp_path / "nope")) is None \
        is ckpt.latest_step(str(tmp_path / "nope"))


def test_checkpoint_callback_every_n(world, tmp_path):
    from horovod_tpu_torch.optim.callbacks import CallbackList
    root = str(tmp_path / "cb")
    state = TorchState(model=torch.nn.Linear(2, 2), count=0)
    cbs = CallbackList([ckpt.CheckpointCallback(root, state, every_n=3)])
    cbs.on_train_begin({})  # hooks it does not override are fine
    for i in range(1, 8):
        state.count = i
        cbs.on_batch_end(i, {})
    # Batches 3 and 6 hit disk, carrying the values committed THEN.
    assert ckpt.latest_step(root) == 6
    fresh = TorchState(model=torch.nn.Linear(2, 2), count=0)
    ckpt.restore_state(root, fresh, step=6)
    assert fresh.count == 6


def test_save_state_anchors_committed_not_current(world, tmp_path):
    """save_state writes the last COMMITTED snapshot and moves neither
    the live values nor the in-memory rollback point."""
    root = str(tmp_path / "anchor")
    model = torch.nn.Linear(2, 2)
    state = TorchState(model=model, epoch=1)
    state.commit()
    w1 = model.weight.detach().clone()
    state.epoch = 99           # uncommitted mutations after the commit
    with torch.no_grad():
        model.weight.add_(1.0)
    ckpt.save_state(root, state, step=10)
    assert state.epoch == 99   # anchoring must not move live values...
    state.restore()
    assert state.epoch == 1    # ...nor the in-memory rollback point
    assert torch.equal(model.weight, w1)
    fresh_model = torch.nn.Linear(2, 2)
    fresh = TorchState(model=fresh_model, epoch=0)
    ckpt.restore_state(root, fresh)
    assert fresh.epoch == 1    # disk carries the committed value
    assert torch.equal(fresh_model.weight, w1)
