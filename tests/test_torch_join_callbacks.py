"""join and the training callbacks of the PyTorch package, against the
JAX package's (horovod_tpu/core/join.py, horovod_tpu/optim/callbacks.py).

A 3-rank gloo world (tests/torch_join_worker.py):
- join_steps over local step counts 2, 4, 3 gives 4 on every rank; the
  padded loop's Sum allreduces equal numpy's sums of the ranks that
  still have data; join() returns the highest rank (2), with `joined`
  set only inside it;
- MetricAverageCallback equals numpy's float64 mean, to 1e-15 relative;
- BroadcastGlobalVariablesCallback leaves every rank with rank 0's
  parameters, BatchNorm buffers and momentum buffers, bit for bit
  (ranks 1 and 2 held no optimizer state before);
- LearningRateWarmupCallback in a world of 3: state["lr"] after every
  hook of a 4-epoch, 3-batch schedule equals the JAX callback's with
  the JAX package's world size set to 3, exactly (the same float
  arithmetic), and the optimizer's groups carry it.
In-process: LearningRateScheduleCallback (staircase and not) and the
warm-up in a world of 1 against the JAX callbacks, exactly; the
momentum correction; the commit and batch-state callbacks on any object
with commit(); CallbackList's dispatch.
"""

import numpy as np
import pytest
import torch

import torch_collectives_worker as CW
import torch_join_worker as W
from horovod_tpu.optim import callbacks as jcb
from horovod_tpu_torch.optim import callbacks as tcb

K = 3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return CW.spawn(W.run_join, tmp_path_factory.mktemp("join"), {}, k=K)


def test_join_steps_pads_uneven_loops(world):
    n = max(W.LOCAL_STEPS)
    want = [sum(r + 1 for r in range(K) if s < W.LOCAL_STEPS[r])
            for s in range(n)]
    for r in range(K):
        assert int(world[r]["join_steps"]) == n
        assert world[r]["sums"].tolist() == want


def test_join_returns_the_highest_rank(world):
    for r in range(K):
        assert int(world[r]["join"]) == K - 1
        assert not bool(world[r]["joined_before"])
        assert not bool(world[r]["joined_after"])


def test_metric_average(world):
    want = np.mean([[r / 7.0, 1.5 * r + 0.25] for r in range(K)], 0)
    for r in range(K):
        np.testing.assert_allclose(world[r]["metrics"], want, rtol=1e-15)


def test_broadcast_global_variables(world):
    keys = [k for k in world[0] if k.startswith("bcast/")]
    assert any("running_mean" in k for k in keys)
    assert sum("buf" in k for k in keys) == 4
    for r in range(1, K):
        for k in keys:
            np.testing.assert_array_equal(world[r][k], world[0][k])


def _jax_trace(cb, epochs, steps_per_epoch):
    p = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.SGD([p], lr=0.0)
    return np.asarray(W.lr_trace(jcb.CallbackList([cb]), opt, epochs,
                                 steps_per_epoch))[:, 0]


def _same(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def test_warmup_in_a_world_of_three_matches_jax(world, monkeypatch):
    from horovod_tpu.core import topology as jtopo
    monkeypatch.setattr(jtopo, "is_initialized", lambda: True)
    monkeypatch.setattr(jtopo, "size", lambda: K)
    want = _jax_trace(jcb.LearningRateWarmupCallback(0.1, warmup_epochs=2),
                      **W.SCHEDULE)
    for r in range(K):
        got = world[r]["lr_warmup"]
        _same(got[:, 0], want)
        set_at = ~np.isnan(got[:, 0])
        np.testing.assert_array_equal(got[set_at, 1], got[set_at, 0])
    assert np.nanmax(want) == pytest.approx(0.1 * K)


@pytest.mark.parametrize("staircase", [True, False])
@pytest.mark.parametrize("start,end", [(0, None), (1, 3)])
def test_schedule_matches_jax(staircase, start, end):
    def mult(e):
        return 0.5 ** e

    kw = dict(initial_lr=0.2, multiplier=mult, start_epoch=start,
              end_epoch=end, staircase=staircase)
    p = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.SGD([p], lr=0.0)
    got = np.asarray(W.lr_trace(tcb.CallbackList(
        [tcb.LearningRateScheduleCallback(**kw)]), opt, 4, 3))
    want = _jax_trace(jcb.LearningRateScheduleCallback(**kw), 4, 3)
    _same(got[:, 0], want)
    set_at = ~np.isnan(got[:, 0])
    np.testing.assert_array_equal(got[set_at, 1], got[set_at, 0])


def test_warmup_in_a_world_of_one_matches_jax(monkeypatch):
    from horovod_tpu.core import topology as jtopo
    monkeypatch.setattr(jtopo, "is_initialized", lambda: False)
    p = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.SGD([p], lr=0.0)
    got = np.asarray(W.lr_trace(tcb.CallbackList(
        [tcb.LearningRateWarmupCallback(0.05, warmup_epochs=3)]), opt, 4, 2))
    want = _jax_trace(jcb.LearningRateWarmupCallback(0.05, warmup_epochs=3),
                      4, 2)
    _same(got[:, 0], want)


@pytest.mark.parametrize("correction", [True, False])
def test_momentum_correction(correction):
    """With the correction (torch's SGD form) the buffers stay; without
    it they are rescaled by old/new lr when the lr moves."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.SGD([p], lr=0.1, momentum=0.9)
    p.grad = torch.ones(3)
    opt.step()
    before = opt.state[p]["momentum_buffer"].clone()
    cb = tcb.LearningRateScheduleCallback(0.1, multiplier=2.0,
                                          momentum_correction=correction)
    cb.on_epoch_begin(0, {"opt_state": opt})
    assert opt.param_groups[0]["lr"] == pytest.approx(0.2)
    want = before if correction else before * 0.5
    torch.testing.assert_close(opt.state[p]["momentum_buffer"], want)


class _State:
    def __init__(self):
        self.commits = 0
        self.batch = self.epoch = None

    def commit(self):
        self.commits += 1

    def check_host_updates(self):
        return False


def test_commit_and_batch_state_callbacks_match_jax():
    got, want = _State(), _State()
    lists = [tcb.CallbackList([tcb.CommitStateCallback(got, 2),
                               tcb.UpdateBatchStateCallback(got)]),
             jcb.CallbackList([jcb.CommitStateCallback(want, 2),
                               jcb.UpdateBatchStateCallback(want)])]
    for cbl, s in zip(lists, (got, want)):
        for epoch in range(2):
            for batch in range(5):
                cbl.on_batch_end(batch, {})
            mid = s.batch
            cbl.on_epoch_end(epoch, {})
        s.mid = mid
    assert (got.commits, got.batch, got.epoch, got.mid) == \
        (want.commits, want.batch, want.epoch, want.mid) == (4, 0, 1, 4)
    with pytest.raises(AttributeError):
        lists[0].not_a_hook
