"""The port's serving tier (horovod_tpu_torch/serve/) against the JAX
package's, on this host's CPU.

* The continuous batcher: every case of tests/test_serve.py's batcher
  suite runs under one fake clock through both packages' batchers, and
  the batches they form (members, order, bucket, padded arrays), the
  queue depths, requeue counts and outcomes must be equal (exact: the
  batcher holds no floats of its own).
* The engine on a small LM (L2 D64 H4 S32 V128, f32, attn="flash"):
  the JAX engine over the JAX forward (`build_forward`, i.e.
  `_forward_local` under shard_map on a 1-device mesh, flash in Pallas
  interpret mode) and the port's engine over `TransformerLM` from the
  same weights (models/convert.transformer_from_jax) give the same
  last-position logits at every bucket within 2e-4 of the largest
  magnitude (f32 through two layers, sums in different orders); a
  padded row never changes a real row. On the CPU the port's engine
  runs the eager forward (there is no graph to capture).
* Params-only restore from the port's checkpoint root and from a
  single checkpoint.
* The replica, pool and frontend over loopback, with a replica's death
  requeued onto the survivor, the drain and overload rejections, the
  pool's heartbeat freshness and die orders, and a JAX client talking
  to the port's frontend (the frames are the same).
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.observability import metrics as jmetrics
from horovod_tpu.serve import batching as jb
from horovod_tpu.serve import telemetry as jtel
from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.observability import metrics as tmetrics
from horovod_tpu_torch.serve import batching as tb
from horovod_tpu_torch.serve import telemetry as ttel
from horovod_tpu_torch.serve.batching import ContinuousBatcher
from horovod_tpu_torch.serve.engine import InferenceEngine


@pytest.fixture(autouse=True)
def _fresh_metrics():
    for m, t in ((jmetrics, jtel), (tmetrics, ttel)):
        m.reset_for_tests()
        t._mx_cache = None
    yield
    for m, t in ((jmetrics, jtel), (tmetrics, ttel)):
        m.reset_for_tests()
        t._mx_cache = None


class FakeClock:
    def __init__(self, t: float = 100.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _item(v, shape=(3,), dtype=np.float32):
    return np.full(shape, v, dtype)


# ------------------------------------------------------ batcher parity

def _batch_view(batch):
    if batch is None:
        return None
    return {"rows": [r.payload.tolist() for r in batch.requests],
            "bucket": batch.bucket, "padding": batch.padding,
            "shape_key": batch.shape_key,
            "stacked": batch.stacked().tolist(),
            "dequeued": [r.t_dequeue for r in batch.requests],
            "requeues": [r.requeues for r in batch.requests]}


def case_no_flush_before_deadline_or_full(B, clock, log):
    b = B.ContinuousBatcher(clock=clock, max_batch=4, max_wait_s=0.010,
                            depth=64)
    b.offer(_item(1))
    b.offer(_item(2))
    log.append(_batch_view(b.poll()))
    clock.advance(0.005)
    log.append(_batch_view(b.poll()))
    assert log == [None, None]


def case_deadline_flush_partial_batch(B, clock, log):
    b = B.ContinuousBatcher(clock=clock, max_batch=4, max_wait_s=0.010,
                            depth=64)
    b.offer(_item(1))
    clock.advance(0.004)
    b.offer(_item(2))
    clock.advance(0.0061)
    batch = b.poll()
    log.append(_batch_view(batch))
    assert [float(r.payload[0]) for r in batch.requests] == [1.0, 2.0]
    assert batch.bucket == 2 and b.depth_now() == 0


def case_max_batch_flush_immediate(B, clock, log):
    b = B.ContinuousBatcher(clock=clock, max_batch=4, max_wait_s=0.010,
                            depth=64)
    for i in range(5):
        b.offer(_item(i))
    batch = b.poll()
    log.append(_batch_view(batch))
    assert len(batch.requests) == 4 and b.depth_now() == 1
    clock.advance(0.011)
    nxt = b.poll()
    log.append(_batch_view(nxt))
    assert len(nxt.requests) == 1 and nxt.bucket == 1


def case_bucket_padding_correctness(B, clock, log):
    b = B.ContinuousBatcher(clock=clock, max_batch=8, max_wait_s=0.010,
                            depth=64)
    for i in range(3):
        b.offer(_item(i + 1))
    clock.advance(0.011)
    batch = b.poll()
    log.append(_batch_view(batch))
    arr = batch.stacked()
    assert batch.bucket == 4 and arr.shape == (4, 3)
    assert arr.dtype == np.float32
    np.testing.assert_array_equal(arr[3], np.zeros((3,)))


def case_shape_groups_never_mix(B, clock, log):
    b = B.ContinuousBatcher(clock=clock, max_batch=4, max_wait_s=0.010,
                            depth=64)
    b.offer(_item(1, shape=(3,)))
    b.offer(_item(2, shape=(5,)))
    b.offer(_item(3, shape=(3,)))
    clock.advance(0.011)
    first, second = b.poll(), b.poll()
    log += [_batch_view(first), _batch_view(second)]
    assert [tuple(r.payload.shape) for r in first.requests] == [(3,)] * 2
    assert [tuple(r.payload.shape) for r in second.requests] == [(5,)]


def case_requeue_preserves_order_ahead_of_new_arrivals(B, clock, log):
    b = B.ContinuousBatcher(clock=clock, max_batch=4, max_wait_s=0.010,
                            depth=64)
    for i in range(4):
        b.offer(_item(i))
    batch = b.poll()
    b.offer(_item(7))
    log.append(b.requeue(batch.requests))
    clock.advance(0.011)
    redo = b.poll()
    log.append(_batch_view(redo))
    assert [float(r.payload[0]) for r in redo.requests] == [0, 1, 2, 3]
    assert all(r.requeues == 1 for r in redo.requests)
    clock.advance(0.011)
    later = b.poll()
    log.append(_batch_view(later))
    assert [float(r.payload[0]) for r in later.requests] == [7]


def case_requeue_limit_fails_request_instead_of_cycling(B, clock, log):
    b = B.ContinuousBatcher(clock=clock, max_batch=4, max_wait_s=0.010,
                            depth=64, requeue_limit=2)
    r = b.offer(_item(1))
    for k in (1, 2, 3):
        b.poll(clock.t + k)
        log.append(b.requeue([r]))
    log.append((r.event.is_set(), r.error, b.depth_now()))
    assert r.event.is_set() and r.error is not None
    assert b.depth_now() == 0


def case_bounded_queue_rejects_but_requeue_is_exempt(B, clock, log):
    b = B.ContinuousBatcher(clock=clock, max_batch=4, max_wait_s=0.010,
                            depth=2)
    assert b.offer(_item(1)) is not None and b.offer(_item(2)) is not None
    assert b.offer(_item(3)) is None
    batch = b.poll(clock.t + 1)
    log.append(b.requeue(batch.requests))
    log.append(b.depth_now())
    assert b.depth_now() == 2


def case_requeue_returns_actual_count(B, clock, log):
    b = B.ContinuousBatcher(clock=clock, max_batch=4, max_wait_s=0.010,
                            depth=64)
    rs = [b.offer(_item(i)) for i in range(3)]
    batch = b.poll(clock.t + 1)
    rs[0].fail("timed out in the frontend")
    log.append(b.requeue(batch.requests))
    assert log[-1] == 2 and b.depth_now() == 2


def case_purge_updates_depth_gauge(B, clock, log):
    tel = jtel if B is jb else ttel
    b = B.ContinuousBatcher(clock=clock, max_batch=4, max_wait_s=0.010,
                            depth=64)
    rs = [b.offer(_item(i)) for i in range(3)]
    log.append(tel.handles()["queue_depth"].value)
    for r in rs:
        r.fail("timed out in the frontend")
    log.append(_batch_view(b.poll()))
    log.append((b.depth_now(), tel.handles()["queue_depth"].value))
    assert log == [3, None, (0, 0)]


def case_multi_group_flush_not_head_of_line_blocked(B, clock, log):
    b = B.ContinuousBatcher(clock=clock, max_batch=4, max_wait_s=0.010,
                            depth=64)
    b.offer(_item(1, shape=(5,)))
    for i in range(4):
        b.offer(_item(i, shape=(3,)))
    batch = b.poll()
    log.append(_batch_view(batch))
    assert [tuple(r.payload.shape) for r in batch.requests] == [(3,)] * 4
    assert b.depth_now() == 1 and b.poll() is None
    clock.advance(0.011)
    log.append(_batch_view(b.poll()))


def case_quiesced_tracks_handed_out_batches(B, clock, log):
    b = B.ContinuousBatcher(clock=clock, max_batch=4, max_wait_s=0.010,
                            depth=64)
    log.append(b.quiesced())
    b.offer(_item(1))
    log.append(b.quiesced())
    batch = b.poll(clock.t + 1)
    log.append((batch is not None, b.depth_now(), b.quiesced()))
    b.task_done()
    log.append(b.quiesced())
    assert log == [True, False, (True, 0, False), True]


def case_drain_flushes_and_closes_admission(B, clock, log):
    b = B.ContinuousBatcher(clock=clock, max_batch=4, max_wait_s=0.010,
                            depth=64)
    b.offer(_item(1))
    assert b.poll() is None
    b.set_drain(True)
    log.append(b.offer(_item(2)))
    batch = b.poll()
    log.append(_batch_view(batch))
    assert log[0] is None and len(batch.requests) == 1
    b.close()
    log.append(b.offer(_item(3)))
    log.append(b.next_batch(timeout=0.1))
    assert log[-2:] == [None, None]


def case_status_counters_and_histograms(B, clock, log):
    tel = jtel if B is jb else ttel
    b = B.ContinuousBatcher(clock=clock, max_batch=2, max_wait_s=0.010,
                            depth=3)
    for i in range(4):
        b.offer(_item(i))
    clock.advance(0.02)
    batch = b.poll()
    b.requeue(batch.requests)
    clock.advance(0.02)
    b.poll()
    b.poll()
    mx = tel.handles()
    log.append({s: mx["request_status"][s].value
                for s in tel.REQUEST_STATUSES})
    log.append(mx["requeued"].value)
    log.append(mx["padded_items"].value)
    for name in ("batch_size", "queue_wait"):
        h = mx[name].labels()
        log.append((name, h.count, h.sum))


BATCHER_CASES = {f.__name__[5:]: f for f in (
    case_no_flush_before_deadline_or_full,
    case_deadline_flush_partial_batch,
    case_max_batch_flush_immediate,
    case_bucket_padding_correctness,
    case_shape_groups_never_mix,
    case_requeue_preserves_order_ahead_of_new_arrivals,
    case_requeue_limit_fails_request_instead_of_cycling,
    case_bounded_queue_rejects_but_requeue_is_exempt,
    case_requeue_returns_actual_count,
    case_purge_updates_depth_gauge,
    case_multi_group_flush_not_head_of_line_blocked,
    case_quiesced_tracks_handed_out_batches,
    case_drain_flushes_and_closes_admission,
    case_status_counters_and_histograms,
)}


@pytest.mark.parametrize("name", sorted(BATCHER_CASES))
def test_batcher_case_equal_in_both_packages(name):
    logs = {}
    for B in (jb, tb):
        logs[B.__name__] = log = []
        BATCHER_CASES[name](B, FakeClock(), log)
    assert logs[tb.__name__] == logs[jb.__name__]


@pytest.mark.parametrize("spec,max_batch", [
    (None, 8), ("", 6), (None, 1), ("2,16", 8), ("4,64", 8), ("1,2", 8),
    ("8", 8)])
def test_parse_buckets_equal(spec, max_batch):
    assert tb.parse_buckets(spec, max_batch) == \
        jb.parse_buckets(spec, max_batch)


@pytest.mark.parametrize("spec", ["0,4", "a,b"])
def test_parse_buckets_validation(spec):
    with pytest.raises(ValueError):
        tb.parse_buckets(spec, 8)


def test_constructor_buckets_normalized_like_env_path(monkeypatch):
    b = ContinuousBatcher(max_batch=8, max_wait_s=0.01, depth=8,
                          buckets=[4, 64])
    assert b.buckets == (4, 8, 64) and b.max_batch == 8
    with pytest.raises(ValueError):
        ContinuousBatcher(max_batch=8, buckets=[0, 4])
    monkeypatch.setenv("HOROVOD_SERVE_MAX_BATCH", "6")
    monkeypatch.setenv("HOROVOD_SERVE_MAX_WAIT_MS", "7")
    monkeypatch.setenv("HOROVOD_SERVE_BUCKETS", "3")
    t, j = ContinuousBatcher(), jb.ContinuousBatcher()
    assert (t.max_batch, t.max_wait_s, t.depth, t.buckets,
            t.requeue_limit) == (j.max_batch, j.max_wait_s, j.depth,
                                 j.buckets, j.requeue_limit)


def test_request_outcome_decided_exactly_once_under_race():
    b = ContinuousBatcher(clock=FakeClock(), max_batch=4, depth=8)
    r = b.offer(_item(1))
    wins = []
    barrier = threading.Barrier(8)

    def decider(i):
        barrier.wait()
        won = r.complete(i) if i % 2 else r.fail(f"e{i}")
        if won:
            wins.append(i)

    threads = [threading.Thread(target=decider, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(wins) == 1
    assert (r.result is None) != (r.error is None)


def test_next_batch_blocking_wakes_on_offer():
    b = ContinuousBatcher(max_batch=2, max_wait_s=5.0, depth=8)
    out = []
    t = threading.Thread(
        target=lambda: out.append(b.next_batch(timeout=5.0)), daemon=True)
    t.start()
    time.sleep(0.05)
    b.offer(_item(1))
    b.offer(_item(2))
    t.join(timeout=3.0)
    assert not t.is_alive()
    assert out and out[0] is not None and len(out[0].requests) == 2


def test_serve_metrics_preregistered_scrape_zeros():
    ttel.preregister_metrics()
    jtel.preregister_metrics()
    text = tmetrics.registry().render()
    jnames = set(jtel.handles())
    assert set(ttel.handles()) == jnames
    for name in ("horovod_serve_requests_total",
                 "horovod_serve_request_seconds",
                 "horovod_serve_queue_depth",
                 "horovod_serve_batches_total",
                 "horovod_serve_replica_batches_total",
                 "horovod_serve_compiles_total",
                 "horovod_serve_slo_burn_rate"):
        assert name in text, f"{name} missing from idle scrape"
    for status in ("accepted", "rejected", "completed", "failed"):
        assert f'status="{status}"' in text, text


# --------------------------------------------------------------- engine

class Linear(torch.nn.Module):
    def __init__(self, features=3):
        super().__init__()
        self.w = torch.nn.Parameter(torch.arange(features,
                                                 dtype=torch.float32))
        self.b = torch.nn.Parameter(torch.tensor(0.0))


def _lin_infer(model, x):
    return x @ model.w + model.b


def _mlp_engine(features=3):
    return InferenceEngine(_lin_infer, Linear(features), device="cpu")


def test_engine_on_cpu_runs_eager_and_padding_safe():
    eng = _mlp_engine()
    eng.warmup((3,), np.float32, (1, 2, 4))
    assert eng.compiles == 0 and eng.capture_seconds() == {}
    batch = np.stack([np.full((3,), 2.0, np.float32),
                      np.zeros((3,), np.float32)])
    out = eng.infer(batch)
    assert isinstance(out, np.ndarray) and out.shape == (2,)
    np.testing.assert_allclose(out[0], 2.0 * (0 + 1 + 2))
    assert eng.infer(np.zeros((4, 3), np.float32)).shape == (4,)
    assert eng.compile_for((4, 3), np.float32) is None


def _lm_infer_jax(p, tok):
    h = p["emb"][tok]
    h = h + jnp.tanh(h @ p["wi"]) @ p["wo"]
    return h @ p["emb"].T


def _lm_infer_torch(m, tok):
    h = m.emb[tok]
    h = h + torch.tanh(h @ m.wi) @ m.wo
    return h @ m.emb.T


def _small_lm():
    rng = np.random.default_rng(0)
    V, D, F = 256, 64, 128
    arrs = {"emb": rng.standard_normal((V, D)).astype(np.float32) * 0.02,
            "wi": rng.standard_normal((D, F)).astype(np.float32) * 0.02,
            "wo": rng.standard_normal((F, D)).astype(np.float32) * 0.02}
    model = torch.nn.Module()
    for k, v in arrs.items():
        model.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v)))
    return arrs, model


@pytest.mark.parametrize("lane", [True, False], ids=["jax-lane", "h100-lane"])
def test_engine_hlo_lint_stamps_each_bucket_as_the_jax_engine(
        monkeypatch, lane):
    """Each warmed bucket's program is recorded and linted; on a small LM
    the stamp's rule sets equal the JAX engine's (at the JAX lane, 128,
    the D = 64 contractions pad; at the port's, 64, nothing does)."""
    from horovod_tpu.serve.engine import InferenceEngine as JaxEngine
    if lane:
        from horovod_tpu_torch.analysis import hlo_rules
        monkeypatch.setattr(hlo_rules, "LANE", 128)
    arrs, model = _small_lm()
    buckets = (1, 2, 4)
    jeng = JaxEngine(_lm_infer_jax, {k: jnp.asarray(v)
                                     for k, v in arrs.items()})
    jeng.warmup((16,), np.int32, buckets)
    teng = InferenceEngine(_lm_infer_torch, model, device="cpu")
    teng.warmup((16,), np.int64, buckets)
    js, ts = jeng.hlo_lint(), teng.hlo_lint()
    assert ts["programs"] == js["programs"] == len(buckets)
    assert "error" not in ts
    if lane:
        assert js.get("rules") and set(ts["rules"]) == set(js["rules"])
    else:
        assert "rules" not in ts
    assert ts["clean"] == (not ts.get("rules"))
    assert sorted(teng.lint_programs()) == list(buckets)
    out = teng.infer(np.zeros((2, 16), np.int64))
    assert out.shape == (2, 16, 256)


def test_engine_hlo_lint_failure_never_takes_the_replica_down(monkeypatch):
    from horovod_tpu_torch.analysis import graph

    def broken(*a, **k):
        raise RuntimeError("recorder down")

    monkeypatch.setattr(graph, "record", broken)
    eng = _mlp_engine()
    eng.warmup((3,), np.float32, (1, 2))
    stamp = eng.hlo_lint()
    assert stamp["programs"] == 2 and "recorder down" in stamp["error"]
    assert eng.infer(np.ones((2, 3), np.float32)).shape == (2,)
    monkeypatch.undo()
    monkeypatch.setenv("HOROVOD_HLO_LINT", "0")
    eng = _mlp_engine()
    eng.warmup((3,), np.float32, (1,))
    assert eng.hlo_lint() == {"count": 0, "clean": True, "programs": 1}


def test_engine_default_device_is_the_local_rank_card(monkeypatch):
    from horovod_tpu_torch.serve import engine as eng_mod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(HorovodError, match="device='cpu'"):
        eng_mod.serve_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "1")
    assert eng_mod.serve_device() == torch.device("cuda", 1)
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "2")
    with pytest.raises(HorovodError, match="local rank 2 has no GPU"):
        eng_mod.serve_device()
    assert eng_mod.serve_device("cpu") == torch.device("cpu")


def test_engine_key_normalizes_dtypes():
    k = InferenceEngine._key
    assert k((2, 3), np.float32) == k((2, 3), np.dtype("float32")) \
        == k((2, 3), "float32") == k((2, 3), torch.float32)
    assert k((2, 3), np.int32) != k((2, 3), np.int64)


SMALL_LM = dict(vocab=128, d_model=64, n_heads=4, d_ff=128, n_layers=2,
                max_seq=32)
LM_TOL = 2e-4


@pytest.fixture(scope="module")
def small_lm():
    from horovod_tpu.models import transformer as jtfm
    from horovod_tpu.parallel import MeshSpec, build_mesh
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import transformer as ttfm
    jcfg = jtfm.TransformerConfig(**SMALL_LM, attn="flash",
                                  dtype=jnp.float32)
    params = jtfm.init(jax.random.PRNGKey(0), jcfg)
    mesh = build_mesh(MeshSpec(), jax.devices()[:1])
    fwd = jtfm.build_forward(jcfg, mesh)
    model = ttfm.TransformerLM(ttfm.TransformerConfig(
        **SMALL_LM, attn="flash", dtype=torch.float32), seed=1)
    convert.load_jax_transformer(model, jax.tree_util.tree_map(
        np.asarray, params))
    tokens = np.random.default_rng(0).integers(
        0, SMALL_LM["vocab"], (4, SMALL_LM["max_seq"])).astype(np.int32)
    return params, fwd, model, tokens


def _lm_infer(model, tokens):
    return model(tokens.long())[:, -1, :].float()


def _close(a, b, tol=LM_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= tol * np.max(np.abs(a)), \
        (np.max(np.abs(a - b)), np.max(np.abs(a)))


def test_lm_engine_matches_the_jax_engine_per_bucket(small_lm):
    from horovod_tpu.serve.engine import InferenceEngine as JEngine
    params, fwd, model, tokens = small_lm
    jeng = JEngine(lambda p, x: fwd(p, x)[:, -1, :].astype(jnp.float32),
                   params)
    teng = InferenceEngine(_lm_infer, model, name="lm", device="cpu")
    buckets = (1, 2, 4)
    jeng.warmup((SMALL_LM["max_seq"],), np.int32, buckets)
    teng.warmup((SMALL_LM["max_seq"],), np.int32, buckets)
    assert jeng.compiles == 3
    for b in buckets:
        got = teng.infer(tokens[:b])
        assert got.shape == (b, SMALL_LM["vocab"]) and got.dtype == np.float32
        _close(jeng.infer(tokens[:b]), got)


def test_lm_padding_rows_never_change_a_real_row(small_lm):
    _, _, model, tokens = small_lm
    eng = InferenceEngine(_lm_infer, model, device="cpu")
    alone = eng.infer(tokens[:1])
    padded = np.concatenate([tokens[:1], np.zeros((3, tokens.shape[1]),
                                                  np.int32)])
    _close(alone[0], eng.infer(padded)[0], tol=1e-6)
    full = eng.infer(tokens)
    for i in range(4):
        _close(eng.infer(tokens[i:i + 1])[0], full[i], tol=1e-6)


def test_from_checkpoint_root_params_only(tmp_path, small_lm):
    """An AsyncCheckpointer root of {"params": state_dict, "opt": ...}:
    the engine reads the newest committed generation's params into a
    fresh model (another seed) and serves what the saved model serves."""
    from horovod_tpu_torch import ckpt
    from horovod_tpu_torch.models import transformer as ttfm
    _, _, model, tokens = small_lm

    class FakeKV:
        def __init__(self):
            self.store = {}

        def put(self, scope, key, value):
            self.store[f"{scope}/{key}"] = value

        def get(self, scope, key, timeout=0.0):
            return self.store.get(f"{scope}/{key}")

    saver = ckpt.AsyncCheckpointer(str(tmp_path / "root"), kv=FakeKV())
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = {"mu": {k: torch.ones_like(v) for k, v in state.items()},
           "count": np.int64(7)}
    assert saver.save(3, {"params": state, "opt": opt}, block=True)
    saver.close()
    fresh = ttfm.TransformerLM(model.cfg, seed=99)
    eng = InferenceEngine.from_checkpoint(str(tmp_path / "root"),
                                          _lm_infer, fresh, device="cpu")
    want = InferenceEngine(_lm_infer, model, device="cpu").infer(tokens)
    np.testing.assert_array_equal(eng.infer(tokens), want)


def test_from_single_checkpoint_params_only(tmp_path):
    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.common.exceptions import CheckpointCorruptError
    path = str(tmp_path / "train_ck")
    checkpoint.save(path, {"params": {"w": torch.full((3,), 2.0),
                                      "b": torch.tensor(0.5)},
                           "opt": {"momentum": torch.ones(3)}})
    eng = InferenceEngine.from_checkpoint(path, _lin_infer, Linear(),
                                          device="cpu")
    np.testing.assert_allclose(eng.infer(np.ones((1, 3), np.float32)),
                               [6.5])
    with pytest.raises(CheckpointCorruptError):
        InferenceEngine.from_checkpoint(str(tmp_path / "absent"),
                                        _lin_infer, Linear(), device="cpu")


# ------------------------------------------------ loopback stack + pool

@pytest.fixture()
def serving_stack(monkeypatch):
    """The port's rendezvous server + N loopback replicas (CPU engines)
    + pool + frontend."""
    from horovod_tpu_torch.runner import secret as secret_mod
    from horovod_tpu_torch.runner.rendezvous import (KVClient,
                                                     RendezvousServer)
    from horovod_tpu_torch.serve.frontend import Frontend, ServeClient
    from horovod_tpu_torch.serve.pool import ReplicaPool
    from horovod_tpu_torch.serve.replica import ReplicaServer

    secret_hex = secret_mod.make_secret_key()
    monkeypatch.setenv(secret_mod.SECRET_ENV, secret_hex)
    secret = secret_hex.encode()
    rdv = RendezvousServer(secret=secret)
    port = rdv.start()
    made = {"replicas": [], "clients": [], "stops": [], "secret": secret}

    def add_replica(rank=0):
        monkeypatch.setenv("HOROVOD_RANK", str(rank))
        monkeypatch.setenv("HOROVOD_LOCAL_RANK", str(rank))
        monkeypatch.setenv("HOROVOD_HOSTNAME", f"host{rank}")
        rep = ReplicaServer(_mlp_engine(),
                            kv=KVClient("127.0.0.1", port, secret=secret))
        rep.start()
        made["replicas"].append(rep)
        return rep

    def build(batcher, n_replicas=1, replica_timeout=5.0):
        for r in range(n_replicas):
            add_replica(r)
        pool = ReplicaPool(rdv, batcher, secret=secret,
                           replica_timeout=replica_timeout,
                           discovery_interval=0.05)
        pool.start()
        pool.wait_for_replicas(n_replicas, timeout=15)
        fe = Frontend(batcher, secret=secret, port=0)
        fp = fe.start()
        made["stops"] += [fe.stop, pool.stop]
        client = ServeClient(("127.0.0.1", fp), secret=secret)
        made["clients"].append(client)
        return pool, fe, client

    yield build, add_replica, made
    for c in made["clients"]:
        c.close()
    for s in made["stops"]:
        s()
    for rep in made["replicas"]:
        rep.stop()
    rdv.stop()


def test_loopback_roundtrip_and_stats(serving_stack):
    build, _, _ = serving_stack
    b = ContinuousBatcher(max_batch=4, max_wait_s=0.005, depth=64)
    pool, fe, client = build(b, n_replicas=1)
    for i in range(6):
        out = client.infer(np.full((3,), float(i), np.float32))
        assert abs(float(out) - i * 3.0) < 1e-5
    st = client.stats()
    assert st["accepted"] == st["completed"] == 6
    assert st["failed"] == st["rejected"] == 0


def test_jax_client_talks_to_the_port_frontend(serving_stack):
    from horovod_tpu.serve.frontend import ServeClient as JClient
    build, _, made = serving_stack
    b = ContinuousBatcher(max_batch=4, max_wait_s=0.005, depth=64)
    pool, fe, client = build(b, n_replicas=1)
    jc = JClient(client.addr, secret=made["secret"])
    try:
        assert abs(float(jc.infer(np.full((3,), 2.0, np.float32))) - 6.0) \
            < 1e-5
        assert jc.stats()["completed"] == 1
    finally:
        jc.close()


def test_replica_death_requeues_onto_survivor(serving_stack):
    """Kill one of two replicas mid-stream: every accepted request still
    completes (zero dropped) and the doctor names the dead replica."""
    from horovod_tpu_torch.observability import doctor, flight
    from horovod_tpu_torch.serve.frontend import (ServeClient,
                                                  ServeRequestError)
    flight.reset_for_tests()
    build, _, made = serving_stack
    b = ContinuousBatcher(max_batch=2, max_wait_s=0.002, depth=256)
    pool, fe, client = build(b, n_replicas=2, replica_timeout=3.0)
    results, errors = [], []

    def worker(tid):
        c = ServeClient(client.addr)
        try:
            for i in range(20):
                v = tid * 100 + i
                try:
                    out = c.infer(np.full((3,), float(v), np.float32))
                    results.append((v, float(out)))
                except ServeRequestError as e:
                    errors.append((v, str(e)))
        finally:
            c.close()

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    victim = made["replicas"][0]
    victim._srv.shutdown()
    victim._srv.server_close()
    victim._srv = None
    victim._stop.set()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 80
    for v, out in results:
        assert abs(out - v * 3.0) < 1e-4, (v, out)
    dump = flight.get().payload("test")
    rd = doctor.RankDump(dump, "<mem>", tail_only=False)
    serve = doctor.analyze_serve([rd])
    if pool.deaths:  # the killed replica had a batch in flight
        assert serve is not None and serve["deaths"], dump["events"]
        assert serve["deaths"][0]["pid"] == victim.ident["pid"]
        assert "SERVE REPLICA DEATH" in doctor.render(doctor.merge([rd]))
    flight.reset_for_tests()


def test_frontend_rejects_new_requests_once_drain_requested(
        serving_stack):
    build, _, _ = serving_stack
    b = ContinuousBatcher(max_batch=4, max_wait_s=0.005, depth=64)
    pool, fe, client = build(b, n_replicas=1)
    assert abs(float(client.infer(_item(2))) - 6.0) < 1e-5
    client.shutdown()
    assert client.infer_raw(_item(3)) == ("rejected", "service draining")
    stats = client.stats()
    assert stats["accepted"] == 1 and stats["rejected"] == 1


def test_frontend_rejects_on_full_queue(serving_stack):
    from horovod_tpu_torch.serve.frontend import (ServeClient,
                                                  ServeRequestError)
    build, _, _ = serving_stack
    b = ContinuousBatcher(max_batch=4, max_wait_s=30.0, depth=2)
    pool, fe, client = build(b, n_replicas=0)
    fe.request_timeout = 0.5

    def fire_and_forget():
        c = ServeClient(client.addr)
        try:
            c.infer_raw(_item(1))
        except Exception:
            pass
        finally:
            c.close()

    ts = [threading.Thread(target=fire_and_forget, daemon=True)
          for _ in range(2)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 5
    while b.depth_now() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert b.depth_now() == 2
    assert client.infer_raw(_item(2))[0] == "rejected"
    with pytest.raises(ServeRequestError):
        client.infer(_item(3))
    for t in ts:
        t.join(timeout=5)
    assert ttel.handles()["request_seconds"].labels().count >= 2


class FakeStore:
    def __init__(self):
        self.data = {}

    def scope_items(self, scope):
        pfx = scope + "/"
        return {k[len(pfx):]: v for k, v in self.data.items()
                if k.startswith(pfx)}

    def put(self, scope, key, val):
        self.data[f"{scope}/{key}"] = val


def _registration(hb, pid=4321):
    return json.dumps({
        "hostname": "hostX", "local_rank": 0, "rank": 0, "round": 0,
        "pid": pid, "addr": "127.0.0.1", "port": 1, "hb": hb}).encode()


def test_pool_skew_immune_freshness_stale_eviction_and_die_order(
        monkeypatch):
    from horovod_tpu_torch.serve import pool as pool_mod
    monkeypatch.setattr(pool_mod, "STALE_HEARTBEAT_S", 0.3)
    store = FakeStore()
    store.put("serve", "replica/hostX/0", _registration(hb=5.0))
    p = pool_mod.ReplicaPool(store, ContinuousBatcher(max_batch=2),
                             secret=b"s" * 32, discovery_interval=0.02)
    p.start()
    try:
        p.wait_for_replicas(1, timeout=5)
        deadline = time.monotonic() + 0.6
        hb = 5.0
        while time.monotonic() < deadline:
            hb += 1.0
            store.put("serve", "replica/hostX/0", _registration(hb=hb))
            assert p.replica_count() == 1
            time.sleep(0.02)
        deadline = time.monotonic() + 5
        while p.replica_count() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert p.replica_count() == 0 and p.deaths == 1
        assert store.data.get("serve/die/hostX/0") == b"4321"
        time.sleep(0.1)
        assert p.replica_count() == 0
    finally:
        p.stop()


def test_pool_retires_replica_whose_registration_vanished():
    from horovod_tpu_torch.serve import pool as pool_mod
    store = FakeStore()
    store.put("serve", "replica/hostX/0", _registration(hb=1.0, pid=111))
    p = pool_mod.ReplicaPool(store, ContinuousBatcher(max_batch=2),
                             secret=b"s" * 32, discovery_interval=0.02)
    p.start()
    try:
        p.wait_for_replicas(1, timeout=5)
        store.put("serve", "replica/hostX/0", _registration(hb=2.0,
                                                            pid=222))
        deadline = time.monotonic() + 5
        pids = []
        while time.monotonic() < deadline:
            with p._lock:
                pids = sorted(r.pid for r in p._replicas.values())
            if pids == [222]:
                break
            time.sleep(0.02)
        assert pids == [222], pids
        assert p.deaths == 1
        assert store.data.get("serve/die/hostX/0") == b"111"
    finally:
        p.stop()


def test_replica_wait_for_shutdown_honors_pid_pinned_die_order(
        monkeypatch):
    from horovod_tpu_torch.serve.replica import ReplicaServer

    class FakeKV:
        def __init__(self):
            self.data = {}

        def get(self, scope, key, timeout=0.0):
            return self.data.get(f"{scope}/{key}")

    monkeypatch.setenv("HOROVOD_HOSTNAME", "hostY")
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "0")
    kv = FakeKV()
    rep = ReplicaServer(_mlp_engine(), kv=kv, secret=b"s" * 32)
    kv.data["serve/die/hostY/0"] = b"999999999"
    out = []
    t = threading.Thread(
        target=lambda: out.append(rep.wait_for_shutdown(poll=0.01)),
        daemon=True)
    t.start()
    time.sleep(0.1)
    assert t.is_alive(), "stale (other-pid) die order killed the replica"
    kv.data["serve/die/hostY/0"] = str(rep.ident["pid"]).encode()
    t.join(timeout=5)
    assert not t.is_alive() and out == [1]
    kv.data["serve/shutdown"] = b"1"
    rep2 = ReplicaServer(_mlp_engine(), kv=kv, secret=b"s" * 32)
    assert rep2.wait_for_shutdown(poll=0.01) == 0


def test_replica_requires_the_launcher_kv(monkeypatch):
    from horovod_tpu_torch.serve.replica import ReplicaServer
    for var in ("HOROVOD_GLOO_RENDEZVOUS_ADDR",
                "HOROVOD_GLOO_RENDEZVOUS_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="horovod_tpu_torch.serve"):
        ReplicaServer(_mlp_engine(), secret=b"s" * 32)


def test_serve_launcher_cli():
    from horovod_tpu_torch.serve import launcher
    assert launcher.main(["--host-discovery-script", "x"]) == 2
    args = launcher.build_parser().parse_args(
        ["--host-discovery-script", "d.sh", "--slots-per-host", "2",
         "--min-np", "1", "--", "python", "r.py"])
    assert args.slots_per_host == 2 and args.min_num_proc == 1
    assert args.command == ["--", "python", "r.py"]
