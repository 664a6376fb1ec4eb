"""The online tuners of the PyTorch package (core/autotune.py) against
the JAX package's (horovod_tpu/core/autotune.py, numpy code), and both
tuners driving DistributedOptimizer in a 2-rank gloo world.

- GaussianProcess.predict and BayesianOptimization.next_sample equal the
  JAX package's within 1e-12 for the same seeded samples.
- ParameterManager, both built with the same explicit knobs (the fusion
  threshold and hierarchical allreduce), and OnlineBucketTuner, fed one
  deterministic (bytes, seconds) sequence that depends on the knobs in
  force, return the same value from every update(), apply the same
  settings and freeze at the same call.
- default_knobs is the JAX package's without its cache-capacity knob.
- The world (tests/torch_autotune_worker.py): rank 1's deciding
  functions raise, so it only applies rank 0's broadcast decisions; at
  every step both ranks hold the same threshold and the same bucket
  plan (plan_signature), the plan is rebuilt when the threshold moves,
  and each tuner freezes within 16 steps.
"""

import numpy as np
import pytest

import torch_autotune_worker as W
import torch_collectives_worker as CW
from horovod_tpu.common import config as JC
from horovod_tpu.core import autotune as jat
from horovod_tpu_torch.common import config as TC
from horovod_tpu_torch.core import autotune as tat

MB = 1024 * 1024


@pytest.mark.parametrize("dims,n", [(1, 3), (2, 6), (3, 9)])
def test_gaussian_process_predicts_like_jax(dims, n):
    rng = np.random.default_rng(dims)
    x = rng.uniform(size=(n, dims))
    y = rng.standard_normal(n)
    q = rng.uniform(size=(50, dims))
    got, want = tat.GaussianProcess(0.3, 0.8), jat.GaussianProcess(0.3, 0.8)
    got.fit(x, y)
    want.fit(x, y)
    for a, b in zip(got.predict(q), want.predict(q)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dims", [1, 2])
def test_bayesian_optimization_proposes_like_jax(dims):
    rng = np.random.default_rng(10 + dims)
    got = tat.BayesianOptimization(dims, noise=0.8)
    want = jat.BayesianOptimization(dims, noise=0.8)
    for _ in range(8):
        a, b = got.next_sample(), want.next_sample()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        score = float(rng.uniform(1e8, 1e9))
        got.register(a, score)
        want.register(b, score)


@pytest.mark.parametrize("mesh", ["", "2x2"])
def test_default_knobs_are_jax_without_the_cache(mesh):
    tc, jc = TC.Config(mesh_shape=mesh), JC.Config()
    jc.mesh_shape = mesh
    got = [(k.name, getattr(k, "lo", None), getattr(k, "hi", None))
           for k in tat.default_knobs(tc)]
    want = [(k.name, getattr(k, "lo", None), getattr(k, "hi", None))
            for k in jat.default_knobs(jc) if k.name != "cache_capacity"]
    assert got == want
    assert "cache_capacity" in [k.name for k in jat.default_knobs(jc)]


def _configs(**kw):
    tc, jc = TC.Config(), JC.Config()
    for c in (tc, jc):
        for k, v in kw.items():
            setattr(c, k, v)
    return tc, jc


def _seconds(cfg):
    """A step's reduction time as a function of the knobs in force:
    fastest near 2^21.5 bytes, hierarchical a little slower."""
    t = 1e-3 * (1 + 0.3 * abs(np.log2(cfg.fusion_threshold_bytes) - 21.5))
    return t + (2e-4 if cfg.hierarchical_allreduce else 0.0)


@pytest.mark.parametrize("warmup,steps,max_samples", [(1, 2, 4), (0, 3, 6),
                                                      (2, 1, 3)])
def test_parameter_manager_decides_like_jax(warmup, steps, max_samples):
    tc, jc = _configs(autotune=True, autotune_warmup_samples=warmup,
                      autotune_steps_per_sample=steps,
                      autotune_bayes_opt_max_samples=max_samples,
                      fusion_threshold_bytes=4 * MB)
    got = tat.ParameterManager(tc, knobs=[
        tat._Log2Knob("fusion_threshold", "fusion_threshold_bytes", MB,
                      64 * MB),
        tat._BoolKnob("hierarchical_allreduce", "hierarchical_allreduce")])
    want = jat.ParameterManager(jc, knobs=[
        jat._Log2Knob("fusion_threshold", "fusion_threshold_bytes", MB,
                      64 * MB),
        jat._BoolKnob("hierarchical_allreduce", "hierarchical_allreduce")])
    frozen_at = None
    for call in range(80):
        got.record(8e6, _seconds(tc))
        want.record(8e6, _seconds(jc))
        assert got.update() == want.update(), call
        assert (tc.fusion_threshold_bytes, tc.hierarchical_allreduce) == \
            (jc.fusion_threshold_bytes, jc.hierarchical_allreduce), call
        assert got.frozen == want.frozen, call
        if got.frozen and frozen_at is None:
            frozen_at = call
    assert frozen_at is not None
    assert got.playoff_result == want.playoff_result
    assert len(got.samples) == max_samples + 2


@pytest.mark.parametrize("interval,max_adj", [(1, 4), (3, 2), (2, 0)])
def test_bucket_tuner_decides_like_jax(interval, max_adj):
    tc, jc = _configs(bucket_autotune=True,
                      bucket_autotune_interval=interval,
                      bucket_autotune_max_adjustments=max_adj,
                      bucket_cap_bytes=64 * MB,
                      fusion_threshold_bytes=32 * MB)
    got, want = tat.OnlineBucketTuner(tc), jat.OnlineBucketTuner(jc)
    rng = np.random.default_rng(interval)
    for call in range(60):
        t = tc.fusion_threshold_bytes
        # buckets fill to ~0.9 of the threshold, plus a small tail one;
        # 2 MiB-class buckets move the most bytes a second
        sizes = [int(0.9 * t)] * 6 + [300_000]
        for nb in sizes:
            c = int(np.log2(nb))
            sec = nb / (1e9 * (2.0 if c == 21 else 1.0)) * \
                float(rng.uniform(0.95, 1.05))
            got.record_bucket(nb, sec)
            want.record_bucket(nb, sec)
        assert got.update() == want.update(), call
        assert tc.fusion_threshold_bytes == jc.fusion_threshold_bytes, call
        assert got.frozen == want.frozen, call
        assert got.adjustments == want.adjustments
    assert got.frozen and got.history == want.history
    assert len(got.decisions) == want._windows


def test_tuners_are_built_by_init_exclusively(monkeypatch):
    """init() builds the ParameterManager under HOROVOD_AUTOTUNE, else
    the OnlineBucketTuner under HOROVOD_BUCKET_AUTOTUNE; shutdown drops
    them."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import topology
    for env, pm, bt in ((("HOROVOD_AUTOTUNE", "HOROVOD_BUCKET_AUTOTUNE"),
                         True, False),
                        (("HOROVOD_BUCKET_AUTOTUNE",), False, True),
                        ((), False, False)):
        for k in ("HOROVOD_AUTOTUNE", "HOROVOD_BUCKET_AUTOTUNE"):
            monkeypatch.delenv(k, raising=False)
        for k in env:
            monkeypatch.setenv(k, "1")
        hvd.init(device="cpu")
        try:
            assert (topology.parameter_manager() is not None) == pm
            assert (topology.bucket_tuner() is not None) == bt
        finally:
            hvd.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return CW.spawn(W.run_tuners, tmp_path_factory.mktemp("tune"), {}, k=2,
                    timeout=240)


@pytest.mark.parametrize("tag", ["pm", "bt"])
def test_every_rank_applies_rank_0s_decision(world, tag):
    for r in range(2):
        assert bool(world[r][f"{tag}/exclusive"])
        assert bool(world[r][f"{tag}/frozen"])
    thr = [world[r][f"{tag}/threshold"].tolist() for r in range(2)]
    plans = [world[r][f"{tag}/plan"].tolist() for r in range(2)]
    assert thr[0] == thr[1]
    assert plans[0] == plans[1]
    # the threshold moved, and the plan was rebuilt with it
    assert len(set(thr[0])) > 1
    assert len(set(plans[0])) > 1


def test_pm_world_freezes_after_its_samples(world):
    # warm-up 1, three samples and the two playoff windows
    assert int(world[0]["pm/samples"]) == 5
    assert int(world[1]["pm/samples"]) == 0  # rank 1 never decides
    assert bool(world[0]["pm/dropped"])


def test_bt_world_moves_to_the_fast_class(world):
    """Rank 0's times favour 1 MiB buckets (class 20): it moves the
    threshold to 2 MiB once, then freezes after two no-change windows;
    rank 1 applies the same move."""
    for r in range(2):
        assert world[r]["bt/history"].tolist() == [2 * 1024 * 1024]
        assert world[r]["bt/threshold"][-1] == 2 * 1024 * 1024
        assert int(world[r]["bt/decisions"]) == \
            int(world[0]["bt/decisions"])
    assert int(world[0]["bt/timings"]) > 0
