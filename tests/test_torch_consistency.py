"""The port's call agreement (core/consistency.py), its fingerprint
verifier (analysis/verifier.py) and the collectives' descriptors
(ops/collectives.py `describe_*`) against the JAX package's, on this
host's CPU.

- Descriptors: every eager collective's descriptor equals the text the
  JAX package's `_consistency` choke point receives for the same call
  (captured from a JAX run on its 8-device CPU mesh, k = 8; the port's
  built for a set of 8), the bucketed one with its threshold and plan
  signature; the hook path's step descriptor is the bucketed one of the
  optimizer's gradients.
- Fingerprints: the same descriptor sequences through both verifiers
  publish the same fingerprints and windows, and a skipped call raises
  CollectiveDivergenceError with the same message.
- The checker, on the FakeKV of tests/test_consistency.py and on the
  port's native KV server: agreement, a mismatch raising
  CollectiveMismatchError (a TensorShapeMismatchError as in the JAX
  package, and a CollectiveDivergenceError) naming both ranks' calls, a
  missing rank, sub-set sequences, the GC of old rounds, and the version
  handshake raising VersionMismatchError.
Tolerance: exact.
"""

import hashlib
import threading
import time
import types

import numpy as np
import pytest
import torch

from horovod_tpu.analysis import verifier as jver
from horovod_tpu.core import consistency as jcc
from horovod_tpu_torch.analysis import verifier as tver
from horovod_tpu_torch.common import types as T
from horovod_tpu_torch.common.exceptions import (CollectiveDivergenceError,
                                                 CollectiveMismatchError,
                                                 HorovodError,
                                                 TensorShapeMismatchError,
                                                 VersionMismatchError)
from horovod_tpu_torch.core import consistency as tcc
from horovod_tpu_torch.ops import collectives as tcoll
from horovod_tpu_torch.ops import fusion
from torch_threads import leftover, snapshot

@pytest.fixture(scope="module", autouse=True)
def threads_at_start():
    return snapshot()


K = 8
PS = types.SimpleNamespace(size=lambda: K, process_set_id=0, ranks=None)


# ------------------------------------------------------------ descriptors

@pytest.fixture(scope="module")
def jax_descs():
    """The JAX package's descriptors for one call of each collective."""
    import horovod_tpu as jhvd
    from horovod_tpu.ops import collectives as jcoll
    seen = []
    real = jcoll._consistency
    jcoll._consistency = lambda desc, ps, name=None: seen.append(
        (desc, name))
    jhvd.init()
    try:
        assert jhvd.size() == K
        x = np.ones((3, 4), np.float32)
        r = np.random.default_rng(0)
        jhvd.allreduce(x)
        jhvd.allreduce(x, op=jhvd.Sum, name="g")
        jhvd.grouped_allreduce([x, np.ones((5,), np.float64)])
        jhvd.bucketed_allreduce([r.random((K, 3, 4)).astype(np.float32),
                                 r.random((K, 5)).astype(np.float32),
                                 r.random((K, 700, 2)).astype(np.float32)])
        jhvd.broadcast(x, root_rank=3)
        jhvd.allgather(x)
        jhvd.grouped_allgather([x, np.ones((2,), np.int32)])
        jhvd.reducescatter(np.ones((16, 4), np.float32))
        jhvd.grouped_reducescatter([np.ones((16, 4), np.float32)])
        jhvd.alltoall(np.ones((16, 2), np.float32))
        jhvd.barrier()
    finally:
        jcoll._consistency = real
        jhvd.shutdown()
    return seen


def _port_descs():
    x = torch.ones(3, 4)
    cfg = types.SimpleNamespace(fusion_threshold_bytes=4 * 1024 * 1024,
                                bucket_cap_bytes=4 * 1024 * 1024)
    shapes = [(3, 4), (5,), (700, 2)]
    plan = fusion.plan_buckets([(s, "float32") for s in shapes],
                               fusion.effective_threshold(
                                   cfg.fusion_threshold_bytes,
                                   cfg.bucket_cap_bytes), reverse=True)
    return [
        (tcoll.describe_allreduce(x, T.Average, PS), "allreduce"),
        (tcoll.describe_allreduce(x, T.Sum, PS), "g"),
        (tcoll.describe_grouped([x, torch.ones(5, dtype=torch.float64)],
                                T.Average, PS), "grouped_allreduce"),
        (tcoll.describe_bucketed(shapes, T.Average, 4 * 1024 * 1024, plan,
                                 PS), "bucketed_allreduce"),
        (tcoll.describe_broadcast(x, 3, PS), "broadcast"),
        (tcoll.describe_allgather(x, PS), "allgather"),
        (tcoll.describe_grouped_allgather(
            [x, torch.ones(2, dtype=torch.int32)], PS),
         "grouped_allgather"),
        (tcoll.describe_reducescatter(torch.ones(16, 4), T.Average, PS),
         "reducescatter"),
        (tcoll.describe_grouped([torch.ones(16, 4)], T.Average, PS,
                                "grouped_reducescatter"),
         "grouped_reducescatter"),
        (tcoll.describe_allgather(torch.ones(16, 2), PS, "alltoall"),
         "alltoall"),
        (tcoll.describe_barrier(PS), None),
    ]


def test_every_descriptor_matches_jax(jax_descs):
    assert _port_descs() == jax_descs


def test_eager_calls_dispatch_their_descriptors(tmp_path, monkeypatch):
    """A world of one: what each call hands the choke point."""
    import horovod_tpu_torch as hvd
    seen = []
    monkeypatch.setattr(tcoll, "dispatch",
                        lambda desc, ps, name="": seen.append((desc, name)))
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        ps = hvd.global_process_set
        x = torch.ones(3, 4)
        hvd.allreduce(x, name="a")
        hvd.broadcast(x, 0)
        hvd.allgather(x)
        hvd.grouped_allreduce([x, torch.ones(5)])
        hvd.bucketed_allreduce([x, torch.ones(5)])
        hvd.reducescatter(torch.ones(4, 2))
        hvd.alltoall(torch.ones(2, 2))
        hvd.barrier()
        plan = fusion.plan_buckets([((3, 4), "float32"), ((5,), "float32")],
                                   4 * 1024 * 1024, reverse=True)
        want = [
            (tcoll.describe_allreduce(x, T.Average, ps), "a"),
            (tcoll.describe_broadcast(x, 0, ps), "broadcast"),
            (tcoll.describe_allgather(x, ps), "allgather"),
            (tcoll.describe_grouped([x, torch.ones(5)], T.Average, ps),
             "grouped_allreduce"),
            (tcoll.describe_bucketed([(3, 4), (5,)], T.Average, 4 * 1024 * 1024,
                                     plan, ps), "bucketed_allreduce"),
            (tcoll.describe_reducescatter(torch.ones(4, 2), T.Average, ps),
             "reducescatter"),
            (tcoll.describe_allgather(torch.ones(2, 2), ps, "alltoall"),
             "alltoall"),
            (tcoll.describe_barrier(ps), "")]
    finally:
        hvd.shutdown()
    assert seen == want
    assert seen[0][0] == "allreduce(shape=(1, 3, 4),dtype=float32,op=0,ps=0)"


def test_hook_path_dispatches_once_a_step_with_the_plan(tmp_path,
                                                        monkeypatch):
    import horovod_tpu_torch as hvd
    seen = []
    monkeypatch.setattr(tcoll, "dispatch",
                        lambda desc, ps, name="": seen.append((desc, name)))
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        monkeypatch.setattr(hvd.core.topology.config(),
                            "fusion_threshold_bytes", 64)
        model = torch.nn.Sequential(torch.nn.Linear(8, 4),
                                    torch.nn.Linear(4, 2))
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        for _ in range(3):
            opt.zero_grad()
            model(torch.randn(2, 8)).sum().backward()
            opt.step()
        shapes = [tuple(p.shape) for p in model.parameters()]
        plan = fusion.plan_buckets([(s, "float32") for s in shapes], 64,
                                   reverse=True)
        want = tcoll.describe_bucketed(shapes, T.Average, 64, plan,
                                       hvd.global_process_set)
    finally:
        hvd.shutdown()
    assert len(opt.plan) > 1
    assert seen == [(want, "bucketed_allreduce")] * 3


# ------------------------------------------------------------ fingerprints

class VerifierKV:
    """Dict-backed stand-in for runner.rendezvous.KVClient."""

    def __init__(self, store):
        self.store = store

    def put(self, scope, key, value):
        self.store[f"{scope}/{key}"] = value

    def get(self, scope, key, timeout=0.0):
        return self.store.get(f"{scope}/{key}")

    def delete(self, scope, key):
        self.store.pop(f"{scope}/{key}", None)


def _seq(n):
    d = _port_descs()
    return [f"{d[i % len(d)][0]}|name=t{i}" for i in range(n)]


@pytest.mark.parametrize("interval", [1, 3, 10])
def test_fingerprints_match_jax(interval):
    stores = {}
    for name, mod in (("jax", jver), ("port", tver)):
        store = stores[name] = {}
        vs = [mod.FingerprintVerifier(VerifierKV(store), r, 2, "e1",
                                      interval=interval) for r in (0, 1)]
        for desc in _seq(31):
            for v in vs:
                v.record(desc)
    assert stores["port"] == stores["jax"] and stores["port"]
    want = hashlib.sha256()
    for desc in _seq(30)[:interval * (30 // interval)]:
        want.update(desc.encode() + b"\x00")
    last = interval * (30 // interval)
    assert stores["port"][f"{tver.SCOPE}/e1/world/fp/0/{last}"] == \
        want.hexdigest().encode()


@pytest.fixture()
def flight_env(request, tmp_path, monkeypatch):
    """HOROVOD_FLIGHT_DIR set to a fresh directory or unset, and both
    packages' flight recorders re-read from it (and again afterwards), so
    the divergence message does not depend on what an earlier test left
    behind. Yields the directory or None."""
    from horovod_tpu.observability import flight as jfl
    from horovod_tpu_torch.observability import flight as tfl
    d = str(tmp_path / "flight") if request.param else None
    if d:
        monkeypatch.setenv("HOROVOD_FLIGHT_DIR", d)
    else:
        monkeypatch.delenv("HOROVOD_FLIGHT_DIR", raising=False)
    for m in (jfl, tfl):
        m.reset_for_tests()
    yield d
    monkeypatch.undo()
    for m in (jfl, tfl):
        m.reset_for_tests()


@pytest.mark.parametrize("flight_env", [False, True], indirect=True,
                         ids=["no_flight_dir", "flight_dir"])
def test_skipped_call_raises_the_same_divergence_as_jax(flight_env):
    msgs = {}
    for name, mod in (("jax", jver), ("port", tver)):
        store = {}
        v0, v1 = (mod.FingerprintVerifier(VerifierKV(store), r, 2, "e1",
                                          interval=2) for r in (0, 1))
        with pytest.raises(Exception) as ei:
            for i in range(8):
                v0.record(f"allreduce|name=t{i}")
                if i != 2:
                    v1.record(f"allreduce|name=t{i}")
        msgs[name] = (type(ei.value).__name__, str(ei.value))
    assert msgs["port"][0] == "CollectiveDivergenceError"
    # the same diagnosis, naming each package's static analyzer
    assert msgs["port"][0] == msgs["jax"][0]
    assert msgs["port"][1] == msgs["jax"][1].replace(
        "python -m horovod_tpu.analysis",
        "python -m horovod_tpu_torch.analysis").replace(
        "python -m horovod_tpu.observability.doctor",
        "python -m horovod_tpu_torch.observability.doctor")
    assert "first divergent call #2" in msgs["port"][1]
    if flight_env:
        # the dump's path, then how to merge the dumps (fault C15)
        assert msgs["port"][1].endswith(
            f" (merge with `python -m horovod_tpu_torch.observability.doctor"
            f" --dir {flight_env}`)")
        assert f"; flight recorder dump: {flight_env}/" in msgs["port"][1]
    else:
        assert "flight recorder dump" not in msgs["port"][1]


# ---------------------------------------------------------------- checker

class FakeKV:
    """In-memory stand-in for NativeKVClient (tests/test_consistency.py)."""

    def __init__(self):
        self.store, self.counts = {}, {}
        self.cv = threading.Condition()

    def put(self, key, val):
        with self.cv:
            self.store[key] = val
            self.counts[key] = self.counts.get(key, 0) + 1
            self.cv.notify_all()

    def get(self, key, maxlen=1 << 20):
        with self.cv:
            return self.store.get(key)

    def bitwise(self, key, bits, op="and"):
        with self.cv:
            cur = self.store.get(key)
            new = bits if cur is None else bytes(
                (a & b) if op == "and" else (a | b)
                for a, b in zip(cur, bits))
            self.store[key] = new
            self.counts[key] = self.counts.get(key, 0) + 1
            self.cv.notify_all()
            return self.counts[key]

    def get_when(self, key, expected, timeout=60.0, maxlen=1 << 20):
        deadline = time.monotonic() + timeout
        with self.cv:
            while self.counts.get(key, 0) < expected:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self.cv.wait(remaining)
            return self.store.get(key)

    def delete(self, key):
        with self.cv:
            self.store.pop(key, None)
            self.counts.pop(key, None)

    def close(self):
        pass


def _run(checkers, descs, method="check", **kw):
    errs = [None] * len(checkers)

    def go(i):
        try:
            getattr(checkers[i], method)(descs[i], **kw)
        except Exception as e:  # noqa: BLE001 - collected for the asserts
            errs[i] = e

    ts = [threading.Thread(target=go, args=(i,))
          for i in range(len(checkers))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return errs


def _pair(mod, kv=None, timeout=5.0):
    kv = kv or FakeKV()
    return [mod.ConsistencyChecker(kv, r, 2, "t", timeout) for r in (0, 1)]


def test_agreement_and_kv_keys_match_jax():
    kvs = {}
    for name, mod in (("jax", jcc), ("port", tcc)):
        kv = kvs[name] = FakeKV()
        pair = _pair(mod, kv)
        for i in range(12):
            assert _run(pair, [f"allreduce(#{i})"] * 2) == [None, None]
    assert kvs["port"].store == kvs["jax"].store
    assert kvs["port"].counts == kvs["jax"].counts
    assert tcc._GC_LAG == jcc._GC_LAG


def test_mismatch_names_both_ranks_and_is_both_error_types():
    c0, c1 = _pair(tcc)
    errs = _run([c0, c1], ["allreduce(shape=(4,))", "allreduce(shape=(8,))"])
    for e in errs:
        assert isinstance(e, CollectiveMismatchError)
        assert isinstance(e, TensorShapeMismatchError)
        assert isinstance(e, CollectiveDivergenceError)
        assert "rank 0: allreduce(shape=(4,))" in str(e)
        assert "rank 1: allreduce(shape=(8,))" in str(e)
        assert "collective #0" in str(e)


def test_missing_rank_and_lagging_ranks():
    c0, _c1 = _pair(tcc, timeout=0.3)
    with pytest.raises(HorovodError) as ei:
        c0.check("allreduce(x)")
    assert "rank(s) [1] never issued it" in str(ei.value)
    assert not isinstance(ei.value, TensorShapeMismatchError)
    assert c0.lagging_ranks() == [1]


def test_subset_group_keeps_its_own_sequence():
    kv = FakeKV()
    c0, c1 = _pair(tcc, kv)
    assert _run([c0, c1], ["a"] * 2) == [None, None]
    assert _run([c0, c1], ["sub"] * 2, ranks=[0, 1],
                group="ps1-x") == [None, None]
    assert c0._seq == {"world": 1, "ps1-x": 1} and c0.rounds == 2


def test_version_handshake_raises_version_mismatch():
    kv = FakeKV()
    c0, c1 = _pair(tcc, kv)
    errs = _run([c0, c1], [tcc.version_string(), "horovod_tpu_torch=9.9,"
                           "protocol=1"], method="handshake")
    for e in errs:
        assert isinstance(e, VersionMismatchError)
        assert "9.9" in str(e)
    kv2 = FakeKV()
    kv2.put(tcc.LAUNCHER_VERSION_KEY, b"horovod_tpu_torch=0.0.1,protocol=0")
    with pytest.raises(VersionMismatchError, match="its launcher runs"):
        _pair(tcc, kv2)[0].handshake()
    kv3 = FakeKV()
    kv3.put(tcc.LAUNCHER_VERSION_KEY, tcc.version_string().encode())
    assert _run(_pair(tcc, kv3), [None, None],
                method="handshake") == [None, None]


def test_checker_over_the_native_kv_server():
    from horovod_tpu_torch import native
    if not native.available():
        pytest.skip("no C++ toolchain on this host")
    srv = native.NativeKVServer()
    clients = [native.NativeKVClient("127.0.0.1", srv.port)
               for _ in range(2)]
    try:
        pair = [tcc.ConsistencyChecker(c, r, 2, "n", 5.0)
                for r, c in enumerate(clients)]
        assert _run(pair, [None, None], method="handshake") == [None, None]
        for i in range(10):
            assert _run(pair, [f"allreduce(#{i})"] * 2) == [None, None]
        errs = _run(pair, ["x", "y"])
        assert all(isinstance(e, CollectiveMismatchError) for e in errs)
    finally:
        for c in clients:
            c.close()
        srv.stop()


def test_maybe_init_is_off_at_size_one_and_without_native_kv(monkeypatch):
    from horovod_tpu_torch.common.config import Config
    monkeypatch.delenv("HOROVOD_NATIVE_KV_ADDR", raising=False)
    assert Config.from_env().consistency_check is False
    monkeypatch.setenv("HOROVOD_NATIVE_KV_ADDR", "127.0.0.1")
    assert Config.from_env().consistency_check is True
    monkeypatch.setenv("HOROVOD_CONSISTENCY_CHECK", "0")
    assert Config.from_env().consistency_check is False
    assert tcc.maybe_init(Config.from_env(), 0, 1) is None
    monkeypatch.delenv("HOROVOD_NATIVE_KV_ADDR")
    assert tcc.maybe_init(Config.from_env(), 0, 2) is None
    assert tcc.get() is None


def test_no_thread_left_behind(threads_at_start):
    assert not leftover(threads_at_start), leftover(threads_at_start)
