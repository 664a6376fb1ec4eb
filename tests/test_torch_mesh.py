"""The named-axis mesh of the PyTorch package (parallel/mesh.py, init
under HOROVOD_MESH, hvd.axis_process_set) against the JAX package's
parallel/mesh.py, with no spawned process.

MeshSpec.parse, infer, describe, axis_groups, group_of and slice_groups
go over a grid of specs, `auto` and -1 and the error cases included:
both give the same value, or both raise, the JAX package
HorovodTpuError and the port HorovodError, with the same message. The
rest runs a world of one in this process (gloo): init parses
HOROVOD_MESH before it joins, mesh_spec() and hybrid_mesh() answer as
the JAX ones do, build_mesh refuses a world of the wrong size with the
JAX message, and the launcher carries HOROVOD_MESH to remote workers.
"""

import jax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.common.exceptions import HorovodTpuError
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.parallel import mesh as tmesh


def _both(fn):
    """(kind, value) of fn(jmesh) and fn(tmesh): ("ok", result) or
    ("err", message)."""
    out = []
    for mod, err in ((jmesh, HorovodTpuError), (tmesh, HorovodError)):
        try:
            v = fn(mod)
            out.append(("ok", v.sizes() if hasattr(v, "sizes") else v))
        except err as e:
            out.append(("err", str(e)))
    return out


TEXTS = ["dp=2,tp=4", "tp=4", "sp=2", "dp=auto,sp=2", "sp=-1", "dp=2,sp=2",
         " dp = 2 , sp=4 ", "pp=2,ep=2,sp=2", "tp=auto", "dp=1", "sp=1",
         "dp=2,,sp=2", "dp=2,dp=2", "xx=2", "dp2", "", " , ",
         "dp=auto,tp=auto", "tp=3", "dp=2,tp=2", "dp=0", "sp=auto,dp=2"]


@pytest.mark.parametrize("n", [None, 1, 4, 8, 16])
@pytest.mark.parametrize("text", TEXTS)
def test_parse_matches_jax(text, n):
    j, t = _both(lambda m: m.MeshSpec.parse(text, n))
    assert j == t


@pytest.mark.parametrize("n,kw", [
    (8, {}), (8, dict(tp=2)), (8, dict(sp=4)), (8, dict(tp=2, sp=2)),
    (16, dict(pp=2, ep=2, sp=2, tp=2)), (8, dict(tp=3)), (0, {}),
    (4, dict(sp=8)), (1, {}), (6, dict(sp=3))])
def test_infer_matches_jax(n, kw):
    j, t = _both(lambda m: m.MeshSpec.infer(n, **kw))
    assert j == t


@pytest.mark.parametrize("kw", [dict(dp=0), dict(sp=-1), dict(tp=0, dp=2)])
def test_bad_axis_size_matches_jax(kw):
    j, t = _both(lambda m: m.MeshSpec(**kw))
    assert j == t and j[0] == "err"


SPECS = [dict(), dict(dp=2, tp=4), dict(dp=2, sp=2), dict(sp=4),
         dict(pp=2, ep=2, sp=2), dict(dp=2, pp=2, ep=1, sp=2, tp=2)]
AXES = ["dp", "pp", "ep", "sp", "tp", ("dp", "sp"), ["tp", "sp"],
        ("dp", "pp", "ep", "sp", "tp"), "zz", ("dp", "qq")]


@pytest.mark.parametrize("kw", SPECS)
def test_describe_total_and_sizes_match_jax(kw):
    j, t = jmesh.MeshSpec(**kw), tmesh.MeshSpec(**kw)
    assert t.describe() == j.describe()
    assert t.total == j.total and t.sizes() == j.sizes()
    assert tmesh.MeshSpec.parse(t.describe(), t.total) == t  # round trip


@pytest.mark.parametrize("axes", AXES, ids=str)
@pytest.mark.parametrize("kw", SPECS, ids=str)
def test_axis_groups_match_jax(kw, axes):
    j, t = _both(lambda m: m.MeshSpec(**kw).axis_groups(axes))
    assert j == t


@pytest.mark.parametrize("kw", SPECS, ids=str)
def test_group_of_matches_jax(kw):
    j, t = jmesh.MeshSpec(**kw), tmesh.MeshSpec(**kw)
    for axis in jmesh.AXIS_ORDER:
        for r in range(j.total):
            assert t.group_of(axis, r) == j.group_of(axis, r)
    bad = _both(lambda m: m.MeshSpec(**kw).group_of("dp", j.total))
    assert bad[0] == bad[1] and bad[0][0] == "err"


@pytest.mark.parametrize("n,slices", [(8, 2), (8, 1), (8, 8), (8, 3),
                                      (8, 0), (4, -1), (12, 4)])
def test_slice_groups_match_jax(n, slices):
    j, t = _both(lambda m: m.slice_groups(n, slices))
    assert j == t


@pytest.mark.parametrize("text", [None, "", "  ", "dp=2,sp=4", "sp=auto"])
def test_spec_from_env_matches_jax(monkeypatch, text):
    if text is None:
        monkeypatch.delenv("HOROVOD_MESH", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_MESH", text)
    j, t = _both(lambda m: m.spec_from_env(8))
    assert j == t


def test_axis_order_is_jax_and_exported():
    import horovod_tpu_torch.parallel as tpar
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    for name in ("AXIS_ORDER", "MeshSpec", "build_mesh", "mesh_axis_sizes",
                 "spec_from_env", "ring_attention", "ulysses_attention",
                 "blockwise_attention_reference"):
        assert hasattr(tpar, name), name


# ------------------------------------------------- a world of one here

@pytest.fixture
def world(monkeypatch):
    """init(device="cpu") in this process under the given HOROVOD_MESH;
    shut down after."""
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_MESH"):
        monkeypatch.delenv(k, raising=False)

    def start(mesh=None):
        if mesh is not None:
            monkeypatch.setenv("HOROVOD_MESH", mesh)
        hvd.init(device="cpu")

    yield start
    hvd.shutdown()


def test_init_builds_the_mesh(world):
    world("sp=1")
    spec = hvd.mesh_spec()
    assert spec == tmesh.MeshSpec() and spec.describe() == "dp=1"
    mesh = hvd.hybrid_mesh()
    assert mesh.axis_names == jmesh.AXIS_ORDER
    assert tmesh.mesh_axis_sizes(mesh) == dict.fromkeys(jmesh.AXIS_ORDER, 1)
    assert mesh.devices.tolist() == [[[[[0]]]]]
    for axis in jmesh.AXIS_ORDER:
        ps = hvd.axis_process_set(axis)
        assert ps.ranks == [0] and ps.mesh_axis == axis
        assert ps.process_set_id is not None and ps.group is not None
        assert hvd.allreduce(torch.ones(3), op=hvd.Sum,
                             process_set=ps).tolist() == [1.0] * 3
    # one registered set for the five identical rank lists
    assert len({hvd.axis_process_set(a).process_set_id
                for a in jmesh.AXIS_ORDER}) == 1


def test_pure_data_parallel_world_has_no_mesh(world):
    world()
    assert hvd.mesh_spec() is None and hvd.hybrid_mesh() is None
    with pytest.raises(HorovodError) as t_err:
        hvd.axis_process_set("sp")
    assert str(t_err.value) == (
        "axis_process_set requires a hybrid mesh: set HOROVOD_MESH "
        "(e.g. \"dp=2,tp=4\") before hvd.init()")


def test_build_mesh_refuses_the_wrong_world_size_like_jax(world):
    world()
    spec = tmesh.MeshSpec(sp=2)
    with pytest.raises(HorovodError) as t_err:
        tmesh.build_mesh(spec)
    with pytest.raises(HorovodTpuError) as j_err:
        jmesh.build_mesh(jmesh.MeshSpec(sp=2), jax.devices()[:1])
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("text", ["dp=3", "zz=1", "sp=2,sp=2"])
def test_bad_mesh_is_refused_before_joining(monkeypatch, text):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_MESH", text)
    with pytest.raises(HorovodError) as t_err:
        hvd.init(device="cpu")
    assert not hvd.is_initialized()
    j, _ = _both(lambda m: m.MeshSpec.parse(text, 1))
    assert j == ("err", str(t_err.value))


def test_launcher_carries_the_mesh_to_remote_workers(monkeypatch):
    """A remote worker's env is the launcher's base env only; HOROVOD_MESH
    from the launcher's own env is in it."""
    from horovod_tpu_torch.runner import launch, safe_exec
    seen = []

    class Worker:
        def __init__(self, index, cmd, env, **kw):
            seen.append(cmd)

        def terminate(self):
            pass

    monkeypatch.setenv("HOROVOD_MESH", "dp=2,sp=2")
    monkeypatch.setenv("HOROVOD_NIC_DISCOVERY", "0")
    monkeypatch.setattr(safe_exec, "WorkerProcess", Worker)
    monkeypatch.setattr(safe_exec, "wait_all",
                        lambda workers, timeout=None: [0] * len(workers))
    assert launch.launch_static(2, "otherhost:2", ["python", "t.py"], {},
                                coordinator_ip="127.0.0.1") == 0
    assert len(seen) == 2
    for cmd in seen:
        assert cmd[0] == "ssh" and "HOROVOD_MESH=dp=2,sp=2" in cmd[-1]
