"""horovod_tpu_torch.ckpt against horovod_tpu.ckpt, case by case with
tests/test_ckpt.py: the manifest and commit protocol, snapshot and
assemble with offset-named fragments, the two-phase AsyncCheckpointer
(back-pressure, generations, gc, quarantine fallback, the KV pointer,
multi-writer merge and abort), TrainLoopState's resume, the restore
signal, and checkpoint.py's marker contract. Where both packages have
the function, the same inputs go through both and the results must be
equal.

The on-disk format is shared: a generation the JAX package commits is
read by the port (a mini ResNet's params and batch stats, made from a
numpy seed, give the JAX logits through models/convert within 1e-4 of
the largest, the tolerance of tests/test_torch_resnet.py), and one the
port commits is read back by the JAX package bit for bit. A bf16 leaf
is the same bytes from both writers; the JAX reader's verdict on the
port's bf16 generation equals its verdict on its own (on this install
it raises ValueError "No cast function available": horovod_tpu's
assemble_leaf assigns the '<V2' shard into an ml_dtypes array), and the
bytes decode to the JAX array bit for bit.

Not here, with their owners: serving from a checkpoint root (A12),
hvddoctor's [ckpt] section (A13 part 2), and re-sharding onto a mesh
(A11; the port's `reshard` raises naming it). The stall watchdog's
restore grace is held in tests/test_torch_control_plane.py.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu import ckpt as jckpt
from horovod_tpu.ckpt import manifest as jmf
from horovod_tpu.ckpt import resume as jresume
from horovod_tpu.ckpt import sharded as jsharded
from horovod_tpu.models import resnet as jresnet
from horovod_tpu_torch import checkpoint as tcheckpoint
from horovod_tpu_torch import ckpt
from horovod_tpu_torch.ckpt import async_ckpt, manifest as mf, resume, sharded
from horovod_tpu_torch.common.exceptions import (CheckpointCorruptError,
                                                 HorovodError)
from horovod_tpu_torch.elastic import TrainLoopState
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as tresnet


class FakeKV:
    def __init__(self):
        self.store = {}
        self.puts = []

    def put(self, scope, key, value):
        self.puts.append((scope, key))
        self.store[f"{scope}/{key}"] = value

    def get(self, scope, key, timeout=0.0):
        return self.store.get(f"{scope}/{key}")


def small_tree():
    return {"params": {"w": torch.arange(8, dtype=torch.float32),
                       "b": torch.tensor(0.5)},
            "opt_state": {"mu": {"w": torch.ones(8)}}}


# ----------------------------------------------------------- manifest

@pytest.mark.parametrize("m", [mf, jmf], ids=["torch", "jax"])
def test_marker_protocol_and_latest_committed(tmp_path, m):
    root = str(tmp_path)
    assert m.latest_committed(root) is None
    # a dir WITHOUT a marker does not exist as a checkpoint
    os.makedirs(os.path.join(root, m.dirname_for(10)))
    assert m.latest_committed(root) is None
    m.write_marker(root, 10, generation=1)
    assert m.latest_committed(root) == (1, 10)
    # generations order commits even when steps regress
    os.makedirs(os.path.join(root, m.dirname_for(4)))
    m.write_marker(root, 4, generation=2)
    assert m.latest_committed(root) == (2, 4)
    # each package reads the other's markers the same way
    assert mf.committed(root) == jmf.committed(root)
    # a marker whose dir vanished is skipped
    os.rmdir(os.path.join(root, m.dirname_for(4)))
    assert m.latest_committed(root) == (1, 10)


def test_sweep_quarantines_only_stale_uncommitted(tmp_path):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, mf.dirname_for(5)))
    mf.write_marker(root, 5, generation=1)
    # older, marker-less: a writer died mid-save — quarantined
    os.makedirs(os.path.join(root, mf.dirname_for(3)))
    # NEWER marker-less: may be an in-flight save — left alone
    os.makedirs(os.path.join(root, mf.dirname_for(8)))
    swept = mf.sweep_stale(root)
    assert swept == [3]
    assert not os.path.isdir(os.path.join(root, mf.dirname_for(3)))
    assert os.path.isdir(os.path.join(root, mf.dirname_for(8)))
    qdir = os.path.join(root, mf.QUARANTINE_DIR)
    assert len(os.listdir(qdir)) == 1
    assert jmf.sweep_stale(root) == []  # the JAX sweep agrees: done


def test_gc_removes_marker_before_dir(tmp_path):
    root = str(tmp_path)
    for step, gen in ((1, 1), (2, 2), (3, 3)):
        os.makedirs(os.path.join(root, mf.dirname_for(step)))
        mf.write_marker(root, step, generation=gen)
    dropped = mf.gc(root, keep=2)
    assert dropped == [1]
    assert mf.committed(root) == [(2, 2), (3, 3)] == jmf.committed(root)
    assert not os.path.exists(mf.marker_path(root, 1))


# ------------------------------------------------------------ sharded

def test_fragments_write_offset_named_shards(tmp_path):
    """Four writers each give one (8, 8) fragment of a (32, 8) leaf:
    exactly 4 offset-named files, one copy of the data, and a replicated
    leaf is written only by the writer that keeps replicated leaves."""
    full = torch.arange(32 * 8, dtype=torch.float32).reshape(32, 8)
    d = str(tmp_path)
    entries = None
    nbytes = 0
    for w in range(4):
        snaps, n = sharded.snapshot_tree(
            {"emb": sharded.Fragment(full[8 * w:8 * w + 8], (8 * w, 0),
                                     (32, 8)),
             "bias": torch.ones(3)}, keep_replicated=(w == 0))
        nbytes += n
        sharded.write_snapshots(d, snaps)
        if entries is None:
            entries = [s.entry for s in snaps]
        else:
            for e, s in zip(entries, snaps):
                e.files.extend(f for f in s.entry.files
                               if f not in e.files)
    assert nbytes == full.numel() * 4 + 3 * 4  # no replica written twice
    files = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    assert files == ["leaf-00000.npy", "leaf-00001.o0-0.npy",
                     "leaf-00001.o16-0.npy", "leaf-00001.o24-0.npy",
                     "leaf-00001.o8-0.npy"]
    by_path = {e.path: e for e in entries}
    assert torch.equal(sharded.assemble_leaf(d, by_path["['emb']"]), full)
    # the JAX package assembles the same files to the same array
    got = jsharded.assemble_leaf(d, jmf.LeafEntry.from_json(
        by_path["['emb']"].to_json()))
    np.testing.assert_array_equal(got, full.numpy())


def test_assemble_detects_missing_and_truncated_shards(tmp_path):
    snaps = []
    for w in range(4):
        s, _ = sharded.snapshot_tree({"x": sharded.Fragment(
            torch.ones(4, 4), (4 * w, 0), (16, 4))})
        snaps.append(s[0])
    d = str(tmp_path)
    sharded.write_snapshots(d, snaps)
    entry = mf.LeafEntry(path="['x']", shape=(16, 4), dtype="float32",
                         files=[f for s in snaps for f in s.entry.files])
    victim = os.path.join(d, entry.files[1]["file"])
    os.remove(victim)
    with pytest.raises(CheckpointCorruptError, match="unreadable"):
        sharded.assemble_leaf(d, entry)
    # wrong-shape shard (truncated rewrite) is typed too
    np.save(victim, np.ones((1, 1), np.float32), allow_pickle=False)
    with pytest.raises(CheckpointCorruptError, match="shape"):
        sharded.assemble_leaf(d, entry)


def test_restore_tree_without_like_rebuilds_dicts(tmp_path):
    tree = {"a": {"b": np.arange(3, dtype=np.float64)}, "c": np.float32(2)}
    snaps, _ = sharded.snapshot_tree(tree)
    jsnaps, _ = jsharded.snapshot_tree(tree)
    # same keypaths, order, shapes and dtypes as the JAX package's
    assert [s.entry.to_json() for s in snaps] == \
        [s.entry.to_json() for s in jsnaps]
    d = str(tmp_path)
    sharded.write_snapshots(d, snaps)
    out = sharded.restore_tree(d, [s.entry for s in snaps])
    np.testing.assert_array_equal(out["a"]["b"].numpy(), np.arange(3))
    assert float(out["c"]) == 2.0
    like = sharded.restore_tree(d, [s.entry for s in snaps], like=tree)
    assert isinstance(like["c"], np.float32) and like["c"] == 2.0
    assert isinstance(like["a"]["b"], np.ndarray)


def test_spec_json_roundtrip():
    from jax.sharding import PartitionSpec as P
    for spec in (("tp", None), (("dp", "tp"),), (), None):
        j = sharded.spec_to_json(spec)
        assert j == jsharded.spec_to_json(
            None if spec is None else P(*spec))
        back = sharded.spec_from_json(j)
        assert back == (None if spec is None else tuple(spec))


def test_reshard_names_its_roadmap_item():
    """ROADMAP A11's reshard (it raised naming the item until A11 part 2):
    each rank gets its block of every assembled leaf under the specs of
    a mesh, replicated leaves and scalars whole, and a dim that does not
    split over its axes is refused."""
    spec = tmesh.MeshSpec(dp=2, tp=2)
    mesh = tmesh.Mesh(spec, np.arange(4).reshape(spec.sizes()))
    tree = {"emb": torch.arange(8.).view(4, 2), "b": torch.ones(2),
            "n": 3, "opt": {"step": torch.tensor(5.)}}
    specs = {"emb": ("tp", None), "b": (), "n": (), "opt": {"step": ()}}
    for rank, rows in ((0, [0, 1]), (1, [2, 3]), (2, [0, 1]), (3, [2, 3])):
        got = sharded.reshard(tree, mesh, specs, rank)
        assert torch.equal(got["emb"], tree["emb"][rows])
        assert torch.equal(got["b"], tree["b"]) and got["n"] == 3
        assert torch.equal(got["opt"]["step"], torch.tensor(5.))
    from horovod_tpu_torch.parallel.mesh import shard_of
    with pytest.raises(HorovodError, match="does not split"):
        shard_of(torch.ones(3), ("tp",), mesh, 0)


def test_snapshot_is_a_copy():
    """A later in-place update must not reach the snapshot."""
    w = torch.zeros(4)
    snaps, _ = sharded.snapshot_tree({"w": w})
    w.add_(1.0)
    assert torch.equal(snaps[0].shards[0][2], torch.zeros(4))


# ---------------------------------------------------- AsyncCheckpointer

def test_async_save_restore_roundtrip_with_objects(tmp_path):
    tree = small_tree()
    s = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV())
    assert s.save(7, tree, objects={"step": 7, "cursor": 3,
                                    "rng": np.uint32(5)})
    assert s.wait(20)
    assert s.last_committed == (1, 7)
    got = s.restore_latest(like=tree)
    assert got.step == 7 and got.generation == 1
    assert got.objects["cursor"] == 3 and got.objects["rng"] == 5
    assert torch.equal(got.tree["params"]["w"], torch.arange(8.0))
    assert set(s.last_phase_seconds) == {"snapshot", "persist", "commit"}
    (rec,) = s.history
    assert (rec["step"], rec["generation"], rec["bytes"]) == (7, 1, 68)
    assert set(rec) == {"step", "generation", "bytes", "snapshot_s",
                        "persist_s", "commit_s"}


def test_async_save_never_blocks_and_skips_under_backpressure(
        tmp_path, monkeypatch):
    """With one save in flight, another save() returns at once as a SKIP
    (counted): it never stalls the step, never queues a second payload."""
    s = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV(), queue_depth=1)
    release = threading.Event()
    real_persist = s._persist

    def slow_persist(job):
        release.wait(20)
        real_persist(job)

    monkeypatch.setattr(s, "_persist", slow_persist)
    tree = {"w": torch.ones(1024)}
    t0 = time.perf_counter()
    assert s.save(1, tree) is True
    dt_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert s.save(2, tree) is False   # writer busy: skip-and-count
    assert s.save(3, tree) is False
    dt_skip = time.perf_counter() - t0
    assert dt_skip < 1.0 and dt_first < 5.0  # nobody waited on disk
    assert s.skipped == 2
    release.set()
    assert s.wait(20)
    assert s.last_committed == (1, 1)  # only the accepted save
    assert s.close()


def test_generation_numbering_continues_across_instances(tmp_path):
    tree = {"w": torch.zeros(2)}
    s1 = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV())
    s1.save(1, tree, block=True)
    s1.save(2, tree, block=True)
    assert s1.last_committed == (2, 2)
    # a new process continues the numbering, and so does the JAX
    # package's checkpointer on the same root
    s2 = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV())
    s2.save(9, tree, block=True)
    assert s2.last_committed == (3, 9)
    j = jckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV())
    j.save(10, {"w": np.zeros(2, np.float32)}, block=True)
    assert j.last_committed == (4, 10)


def test_keep_gc_bounds_committed_generations(tmp_path):
    tree = {"w": torch.zeros(2)}
    s = ckpt.AsyncCheckpointer(str(tmp_path), keep=2, kv=FakeKV())
    for step in (1, 2, 3, 4):
        s.save(step, tree, block=True)
    assert [st for _, st in mf.committed(str(tmp_path))] == [3, 4]


def test_restore_quarantines_corrupt_and_falls_back(tmp_path):
    tree = small_tree()
    s = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV())
    s.save(1, tree, objects={"step": 1}, block=True)
    s.save(2, tree, objects={"step": 2}, block=True)
    d2 = os.path.join(str(tmp_path), mf.dirname_for(2))
    victims = [f for f in os.listdir(d2) if f.endswith(".npy")]
    os.remove(os.path.join(d2, victims[0]))
    got = s.restore_latest(like=tree)
    assert got is not None and got.step == 1  # fell back one generation
    qdir = os.path.join(str(tmp_path), mf.QUARANTINE_DIR)
    assert any(mf.dirname_for(2) in n for n in os.listdir(qdir))
    d1 = os.path.join(str(tmp_path), mf.dirname_for(1))
    with open(os.path.join(d1, mf.MANIFEST_NAME), "w") as f:
        f.write("not json")
    assert s.restore_latest(like=tree) is None


def test_commit_publishes_kv_latest_pointer(tmp_path):
    kv = FakeKV()
    s = ckpt.AsyncCheckpointer(str(tmp_path), kv=kv)
    s.save(5, {"w": torch.zeros(2)}, block=True)
    raw = kv.store.get(f"{async_ckpt.KV_SCOPE}/{async_ckpt.KV_LATEST_KEY}")
    body = json.loads(raw.decode())
    assert body["step"] == 5 and body["generation"] == 1
    assert body["root"] == str(tmp_path)
    assert resume.latest_pointer(kv)["generation"] == 1
    assert jresume.latest_pointer(kv) == resume.latest_pointer(kv)


def _frag_snaps(lo, hi, val):
    return [sharded.LeafSnapshot(
        mf.LeafEntry(path="['w']", shape=(8,), dtype="float32",
                     spec=[["tp"]]),
        [((lo,), (hi,), torch.full((hi - lo,), val))])]


def test_multi_writer_fragments_merge_before_commit(tmp_path, monkeypatch):
    """Both writers through the real _persist into one directory:
    offset-derived names never clobber, the peer publishes its fragment
    keyed by STEP, and the primary's merged manifest covers the leaf."""
    kv = FakeKV()
    root = str(tmp_path)
    peer = ckpt.AsyncCheckpointer(root, writers=2, kv=kv)
    monkeypatch.setattr(peer, "_rank", lambda: 1)
    peer._persist(async_ckpt._Job(3, 1, _frag_snaps(4, 8, 2.0), 16, {},
                                  0.0))
    assert mf.latest_committed(root) is None  # the peer never commits
    primary = ckpt.AsyncCheckpointer(root, writers=2, kv=kv)
    monkeypatch.setattr(primary, "_rank", lambda: 0)
    primary._persist(async_ckpt._Job(3, 1, _frag_snaps(0, 4, 1.0), 16, {},
                                     0.0))
    assert mf.latest_committed(root) == (1, 3)
    d = os.path.join(root, mf.dirname_for(3))
    man = mf.read_manifest(d)
    assert len(man.leaves) == 1 and len(man.leaves[0].files) == 2
    assert len({f["file"] for f in man.leaves[0].files}) == 2
    full = sharded.assemble_leaf(d, man.leaves[0])
    assert full.tolist() == [1, 1, 1, 1, 2, 2, 2, 2]
    # the JAX package restores the merged generation to the same array
    got = jresume.restore_latest(root, kv=FakeKV())
    np.testing.assert_array_equal(got.tree["w"], full.numpy())


def test_multi_writer_commit_aborts_without_fragments(tmp_path):
    primary = ckpt.AsyncCheckpointer(str(tmp_path), writers=2, kv=FakeKV())
    primary.commit_timeout = 0.2
    snaps, _ = sharded.snapshot_tree({"w": torch.zeros(4)})
    primary._persist(async_ckpt._Job(1, 1, snaps, 16, {}, 0.0))
    assert mf.latest_committed(str(tmp_path)) is None  # no commit
    assert "fragments missing" in primary.last_error


def test_save_failure_releases_inflight_slot(tmp_path, monkeypatch):
    """A snapshot exception gives the reserved queue slot back."""
    s = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV())
    boom = {"on": True}
    real = sharded.snapshot_tree

    def maybe_boom(tree, **kw):
        if boom["on"]:
            raise RuntimeError("buffer deleted")
        return real(tree, **kw)

    monkeypatch.setattr(sharded, "snapshot_tree", maybe_boom)
    with pytest.raises(RuntimeError, match="buffer deleted"):
        s.save(1, {"w": torch.zeros(2)})
    boom["on"] = False
    assert s.save(2, {"w": torch.zeros(2)}, block=True) is True
    assert s.last_committed == (2, 2)  # generation 1 is a harmless gap


def test_single_writer_incomplete_coverage_aborts_commit(tmp_path):
    s = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV())
    s._persist(async_ckpt._Job(1, 1, _frag_snaps(0, 4, 1.0), 16, {}, 0.0))
    assert mf.latest_committed(str(tmp_path)) is None
    assert "writers=" in (s.last_error or "")


def test_concurrent_inflight_saves_get_distinct_generations(
        tmp_path, monkeypatch):
    s = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV(), queue_depth=2)
    release = threading.Event()
    real_persist = s._persist

    def slow_persist(job):
        release.wait(20)
        real_persist(job)

    monkeypatch.setattr(s, "_persist", slow_persist)
    tree = {"w": torch.zeros(4)}
    assert s.save(1, tree) and s.save(2, tree)  # both in flight
    release.set()
    assert s.wait(20)
    assert [g for g, _ in mf.committed(str(tmp_path))] == [1, 2]


def test_failed_blocking_save_is_a_loud_false(tmp_path, monkeypatch):
    """block=True returns whether THIS save committed: a persist that
    fails (disk full) is False, never a silent success."""
    s = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV())

    def disk_full(dirpath, snaps):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(sharded, "write_snapshots", disk_full)
    assert s.save(1, {"w": torch.zeros(2)}, block=True) is False
    assert "No space left" in s.last_error
    assert mf.latest_committed(str(tmp_path)) is None


def test_restore_signal_staleness_scales_with_heartbeat(monkeypatch):
    assert resume.stale_seconds() == resume.STALE_SECONDS
    monkeypatch.setenv("HOROVOD_CKPT_RESTORE_HEARTBEAT", "30")
    assert resume.stale_seconds() == 90.0 == jresume.stale_seconds()
    kv = FakeKV()
    kv.put("ckpt", "restoring", json.dumps(
        {"ts": time.time() - 60}).encode())  # 60s old, heartbeat 30
    assert resume.peer_restore_active(kv=kv)
    monkeypatch.setenv("HOROVOD_CKPT_RESTORE_HEARTBEAT", "1")
    assert not resume.peer_restore_active(kv=kv)
    monkeypatch.setenv("HOROVOD_CKPT_RESTORE_GRACE_MAX", "7.5")
    assert resume.grace_max_seconds() == 7.5 == jresume.grace_max_seconds()


def test_snapshot_attributed_to_perfscope_checkpoint_phase(tmp_path):
    from horovod_tpu_torch.profiler import perfscope as pscope

    assert "checkpoint" in pscope.PHASES
    scope = pscope.PerfScope(window=16)
    s = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV(), scope=scope)
    with scope.step():
        s.save(1, {"w": torch.ones(4)})
    s.wait(20)
    summ = scope.summary()
    assert "checkpoint" in summ["phases_s"]
    assert summ["phases_s"]["checkpoint"] >= 0.0


# ------------------------------------------------------ TrainLoopState

def _model():
    torch.manual_seed(0)
    return torch.nn.Linear(4, 2)


def test_trainloopstate_resume_roundtrip(tmp_path):
    m = _model()
    opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
    st = TrainLoopState(model=m, optimizer=opt, step=0,
                        checkpointer=ckpt.AsyncCheckpointer(
                            str(tmp_path), kv=FakeKV()))
    for _ in range(3):
        opt.zero_grad()
        m(torch.ones(2, 4)).sum().backward()
        opt.step()
        st.step += 1
        st.record_batch(4)
        st.commit()
    assert st.checkpoint(block=True)
    want = {k: v.clone() for k, v in m.state_dict().items()}
    want_mom = [opt.state[p]["momentum_buffer"].clone()
                for p in m.parameters()]
    m2 = torch.nn.Linear(4, 2)
    opt2 = torch.optim.SGD(m2.parameters(), lr=0.1, momentum=0.9)
    fresh = TrainLoopState(model=m2, optimizer=opt2, step=0,
                           checkpointer=ckpt.AsyncCheckpointer(
                               str(tmp_path), kv=FakeKV()))
    assert fresh.maybe_resume() is True
    assert fresh.last_resume_source == "checkpoint"
    assert fresh.step == 3 and fresh.cursor == 12
    for k, v in want.items():
        assert torch.equal(m2.state_dict()[k], v), k
    for p, mom in zip(m2.parameters(), want_mom):
        assert torch.equal(opt2.state[p]["momentum_buffer"], mom)
    # the model's leaves keep their state_dict names on disk
    got = ckpt.load_params(str(tmp_path), key="model")
    assert set(got) == set(want)
    # and the JAX package reads the same generation's leaves
    jgot = jresume.load_params(str(tmp_path), key="model")
    for k in want:
        np.testing.assert_array_equal(jgot[k], want[k].numpy())


def test_trainloopstate_survivor_memory_wins(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV())
    st = TrainLoopState(model=_model(), step=0, checkpointer=saver)
    st.step = 5
    st.commit()
    st.checkpoint(block=True)
    st.step = 9  # memory moved past the newest commit (survivor)
    st.commit()
    assert st.maybe_resume() is False
    assert st.last_resume_source == "memory"
    assert st.step == 9  # untouched


def test_trainloopstate_checkpoint_saves_committed_not_live(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV())
    m = _model()
    st = TrainLoopState(model=m, step=4, checkpointer=saver)
    st.commit()
    committed_w = m.weight.detach().clone()
    st.step = 99  # uncommitted live mutations
    with torch.no_grad():
        m.weight.add_(1.0)
    assert st.checkpoint(block=True)
    assert saver.last_committed[1] == 4  # the COMMITTED step
    got = ckpt.load_params(str(tmp_path), key="model")
    assert torch.equal(got["weight"], committed_w)


def test_trainloopstate_every_n_gate(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_CKPT_EVERY", "3")
    st = TrainLoopState(model=_model(), step=0,
                        checkpointer=ckpt.AsyncCheckpointer(
                            str(tmp_path), kv=FakeKV()))
    saved = []
    monkeypatch.setattr(st, "checkpoint", lambda **kw: saved.append(
        st.step) or True)
    for i in range(1, 8):
        st.step = i
        st.commit()
        st.maybe_checkpoint()
    assert saved == [3, 6]


def test_trainloopstate_resume_disabled_by_env(tmp_path, monkeypatch):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV())
    saver.save(5, {"trees": {"model": {"weight": torch.ones(2, 4)}}},
               objects={"step": 5}, block=True)
    monkeypatch.setenv("HOROVOD_CKPT_RESUME", "0")
    st = TrainLoopState(model=_model(), step=0, checkpointer=saver)
    assert st.maybe_resume() is False and st.step == 0


def test_sharded_dataset_skip_to():
    from horovod_tpu.data.data_loader import ShardedDataset as JShardedDataset
    from horovod_tpu_torch.data.data_loader import ShardedDataset

    ds = ShardedDataset(list(range(40)), rank=0, size=2, batch_size=2,
                        shuffle=False)
    first = [b for b in ds]
    ds.skip_to(4)
    rest = [b for b in ds]
    assert rest == first[2:]
    jds = JShardedDataset(list(range(40)), rank=0, size=2, batch_size=2,
                          shuffle=False)
    jds.skip_to(4)
    assert [list(b) for b in jds] == [list(b) for b in rest]


# -------------------------------------------------------- restore signal

def test_restore_signal_heartbeats_and_clears():
    kv = FakeKV()
    with resume.signal_restore(kv=kv):
        assert resume.peer_restore_active(kv=kv)
        assert jresume.peer_restore_active(kv=kv)
        raw = json.loads(kv.store["ckpt/restoring"].decode())
        assert raw["ts"] > 0
    assert not resume.peer_restore_active(kv=kv)  # explicitly stale
    kv.put("ckpt", "restoring", json.dumps(
        {"ts": time.time() - 2 * resume.STALE_SECONDS}).encode())
    assert not resume.peer_restore_active(kv=kv)


# ------------------------------------------------- checkpoint.py marker

def test_restore_params_requires_commit_marker(tmp_path, monkeypatch):
    path = str(tmp_path / "ck")
    tcheckpoint.save(path, {"params": {"w": torch.ones(2)}})
    assert mf.has_done_marker(path) and jmf.has_done_marker(path)
    got = tcheckpoint.restore_params(path)
    assert torch.equal(got["w"], torch.ones(2))
    os.remove(path + mf.DONE_SUFFIX)
    with pytest.raises(CheckpointCorruptError, match="commit marker"):
        tcheckpoint.restore_params(path)
    monkeypatch.setenv("HOROVOD_CKPT_REQUIRE_MARKER", "0")
    got = tcheckpoint.restore_params(path)
    assert torch.equal(got["w"], torch.ones(2))


def test_restore_params_types_partial_dir_errors(tmp_path):
    import shutil

    path = str(tmp_path / "ck")
    tcheckpoint.save(path, {"params": {"w": torch.ones(2)}})
    for name in os.listdir(path):
        full = os.path.join(path, name)
        shutil.rmtree(full) if os.path.isdir(full) else os.remove(full)
    with pytest.raises(CheckpointCorruptError):
        tcheckpoint.restore_params(path)


# --------------------------------------------- the format, both ways

@pytest.fixture
def mini_depth():
    jresnet.STAGE_BLOCKS[8] = (1, 1)
    tresnet.STAGE_BLOCKS[8] = (1, 1)
    try:
        yield 8
    finally:
        jresnet.STAGE_BLOCKS.pop(8, None)
        tresnet.STAGE_BLOCKS.pop(8, None)


def test_jax_generation_loads_into_the_ports_resnet(tmp_path, mini_depth):
    """The JAX checkpointer commits a mini ResNet's params and batch
    stats (numpy, seed 5); the port's restore_latest reads them, the
    converter loads them, and the logits equal the JAX apply's."""
    params, stats = jresnet.init(jax.random.PRNGKey(0), depth=mini_depth,
                                 num_classes=10, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    stats = jax.tree_util.tree_map(
        lambda a: (0.5 + rng.random(a.shape)).astype(np.float32), stats)
    j = jckpt.AsyncCheckpointer(str(tmp_path), kv=FakeKV())
    assert j.save(11, {"params": params, "batch_stats": stats},
                  objects={"step": 11}, block=True)
    got = ckpt.restore_latest(str(tmp_path), kv=FakeKV())
    assert (got.step, got.generation, got.objects) == (11, 1, {"step": 11})
    model = tresnet.ResNet(depth=mini_depth, num_classes=10)
    convert.load_jax(model, got.tree["params"], got.tree["batch_stats"])
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    lj, _ = jresnet.apply(params, stats, jnp.asarray(x), depth=mini_depth,
                          train=False)
    with torch.no_grad():
        lt, _ = tresnet.apply(model, torch.tensor(x), train=False)
    lj = np.asarray(lj, np.float64)
    err = np.max(np.abs(lj - lt.numpy().astype(np.float64)))
    assert err <= 1e-4 * np.max(np.abs(lj)), err


def _jax_read(root):
    try:
        return "ok", jresume.restore_latest(root, kv=FakeKV())
    except ValueError as e:
        return "error", str(e)


def test_port_generation_reads_back_in_jax_bit_for_bit(tmp_path):
    rng = np.random.default_rng(6)
    a = rng.standard_normal((5, 3)).astype(np.float32)
    tree = {"f32": torch.from_numpy(a), "i64": torch.arange(-3, 4),
            "mask": torch.tensor([True, False, True]),
            "half": torch.from_numpy(a).half()}
    port_root = str(tmp_path / "port")
    assert ckpt.AsyncCheckpointer(port_root, kv=FakeKV()).save(
        2, tree, objects={"step": 2}, block=True)
    got = jresume.restore_latest(port_root, kv=FakeKV())
    assert got.step == 2 and got.objects == {"step": 2}
    for k, v in tree.items():
        np.testing.assert_array_equal(got.tree[k], v.numpy())
        assert got.tree[k].dtype == v.numpy().dtype, k

    # bf16: the same bytes from both writers, the JAX reader's verdict
    # the same on both, and the bits decode to the JAX array
    jb = jnp.asarray(a, jnp.bfloat16)
    tb = torch.from_numpy(a).to(torch.bfloat16)
    jax_root = str(tmp_path / "jax")
    assert ckpt.AsyncCheckpointer(port_root, kv=FakeKV()).save(
        3, {"w": tb}, block=True)
    assert jckpt.AsyncCheckpointer(jax_root, kv=FakeKV()).save(
        3, {"w": jb}, block=True)
    name = mf.dirname_for(3)
    for d in (port_root, jax_root):
        assert mf.read_manifest(os.path.join(d, name)).leaves[0].dtype \
            == "bfloat16"
    pf = os.path.join(port_root, name, "leaf-00000.npy")
    jf = os.path.join(jax_root, name, "leaf-00000.npy")
    with open(pf, "rb") as f1, open(jf, "rb") as f2:
        assert f1.read() == f2.read()
    np.testing.assert_array_equal(
        np.load(pf).view(ml_dtypes.bfloat16).view(np.uint16),
        np.asarray(jb).view(np.uint16))
    port_v, jax_v = _jax_read(port_root), _jax_read(jax_root)
    assert port_v[0] == jax_v[0]
    if port_v[0] == "ok":
        np.testing.assert_array_equal(
            np.asarray(port_v[1].tree["w"]).view(np.uint16),
            np.asarray(jax_v[1].tree["w"]).view(np.uint16))
    else:
        assert port_v[1] == jax_v[1]
    # and the port reads both generations bit for bit
    for d in (port_root, jax_root):
        back = ckpt.restore_latest(d, kv=FakeKV()).tree["w"]
        assert back.dtype == torch.bfloat16
        assert torch.equal(back.view(torch.int16), tb.view(torch.int16))
