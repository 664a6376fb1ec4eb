"""Elastic state of the port's frontends (horovod_tpu_torch/frontends/
tensorflow_elastic.py TfKerasState, frontends/torch_elastic.py) held
against the JAX package's (horovod_tpu/frontends/tensorflow_elastic.py,
torch_elastic.py) on the same seeded variables.

Commit, restore and sync of a Keras model's and optimizer's variables
and of plain values, in both packages from the same model, with the
same results (bit for bit: the snapshots are numpy copies and a
broadcast in a world of one, or of identical replicas, is the identity);
the checkpointer's save and resume (`root=`), and the on-disk format
both ways: a TfKerasState of either package resumes from the other's
checkpoint with the same variables and step. The duck-typed variables
of the JAX test keep the checkpoint cases independent of TensorFlow.
"""

import numpy as np
import pytest

import horovod_tpu.frontends.tensorflow_elastic as jtfe
import horovod_tpu.frontends.torch as jtorch
import horovod_tpu_torch.frontends.tensorflow_elastic as ttfe
import horovod_tpu_torch.frontends.torch as ttorch


@pytest.fixture(scope="module")
def port():
    ttorch.init(device="cpu")
    yield ttorch
    ttorch.shutdown()


def _keras_model(seed):
    keras = pytest.importorskip("keras")
    keras.utils.set_random_seed(seed)
    model = keras.Sequential([keras.layers.Input((3,)),
                              keras.layers.Dense(2)])
    opt = keras.optimizers.Adam(0.1)
    opt.build(model.trainable_variables)
    return model, opt


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_tf_keras_state_commit_restore_sync(port, hvd, pkg):
    tfe = ttfe if pkg == "port" else jtfe
    model, opt = _keras_model(0)
    state = tfe.TfKerasState(model=model, optimizer=opt, epoch=0)
    w0 = [v.numpy().copy() for v in state._all_vars()]
    assert len(w0) == len(model.variables) + len(opt.variables)
    state.commit()
    for v in model.variables:
        v.assign(v + 1.0)
    state.epoch = 2
    state.restore()
    for v, w in zip(state._all_vars(), w0):
        np.testing.assert_array_equal(v.numpy(), w)
    assert state.epoch == 0
    state.epoch = 3
    state.sync()  # rank 0's values: the identity here
    assert state.epoch == 3
    for v, w in zip(state._all_vars(), w0):
        np.testing.assert_array_equal(v.numpy(), w)
    assert tfe.TensorFlowKerasState is tfe.TfKerasState


def test_tf_keras_states_agree_step_by_step(port, hvd):
    """The same model in both packages' states through commit, a change,
    restore and sync: every variable equal after each."""
    keras = pytest.importorskip("keras")
    pair = []
    for tfe in (jtfe, ttfe):
        model, opt = _keras_model(1)
        pair.append((model, tfe.TfKerasState(model=model, optimizer=opt,
                                             batch=0)))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 3)).astype(np.float32)
    for model, state in pair:
        model.compile(optimizer=state.optimizer, loss="mse")
        model.train_on_batch(x, np.ones((4, 2), np.float32))
        state.batch = 1
        state.commit()
        model.train_on_batch(x, np.zeros((4, 2), np.float32))
        state.restore()
        state.sync()
    del keras
    (mj, sj), (mt, st) = pair
    assert sj.batch == st.batch == 1
    for a, b in zip(sj._all_vars(), st._all_vars()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


class FakeVar:
    def __init__(self, a):
        self.a = np.asarray(a, dtype=np.float32)

    def numpy(self):
        return self.a

    def assign(self, v):
        self.a = np.asarray(v, dtype=np.float32).copy()


class FakeModel:
    def __init__(self):
        self.variables = [FakeVar([1.0, 2.0]), FakeVar([[3.0]])]


@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("jax", "port"),
                                           ("port", "jax")])
def test_tf_keras_state_checkpoint_resume(port, tmp_path, writer, reader):
    pkgs = {"port": ttfe, "jax": jtfe}
    m = FakeModel()
    state = pkgs[writer].TfKerasState(model=m, step=0, root=str(tmp_path))
    m.variables[0].assign([7.0, 8.0])
    state.step = 4
    state.save()
    assert state.checkpoint(block=True)

    m2 = FakeModel()
    state2 = pkgs[reader].TfKerasState(model=m2, step=0,
                                       root=str(tmp_path))
    assert state2.maybe_resume()
    assert state2.last_resume_source == "checkpoint"
    assert state2.step == 4
    np.testing.assert_array_equal(m2.variables[0].numpy(), [7.0, 8.0])
    np.testing.assert_array_equal(m2.variables[1].numpy(), [[3.0]])


def test_resume_prefers_a_fresher_memory(port, tmp_path):
    m = FakeModel()
    state = ttfe.TfKerasState(model=m, step=2, root=str(tmp_path))
    assert state.checkpoint(block=True)
    state.step = 5
    state.save()
    assert not state.maybe_resume()
    assert state.last_resume_source == "memory"


def test_torch_frontend_reexports_the_elastic_state(port, hvd):
    torch = pytest.importorskip("torch")
    names = {n for n in dir(jtorch.elastic) if not n.startswith("_")
             and type(getattr(jtorch.elastic, n)).__name__ != "module"}
    missing = names - {"Any", "Dict", "Iterator", "List", "Optional",
                       "annotations"} - set(dir(ttorch.elastic))
    assert not missing, sorted(missing)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    state = ttorch.elastic.TorchState(model=model, optimizer=opt, epoch=0)
    w0 = model.weight.detach().clone()
    state.commit()
    with torch.no_grad():
        model.weight += 1.0
    state.epoch = 5
    state.restore()
    assert torch.equal(model.weight, w0) and state.epoch == 0
    assert ttorch.elastic.run is not None
