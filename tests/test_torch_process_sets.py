"""The PyTorch package's process sets over a 4-rank gloo world, against
the JAX package's ProcessSetTable on the same sequence of adds and
removes.

One spawned world (tests/torch_collectives_worker.py run_sets) passes
the sets [0, 1] and [3, 2] to hvd.init(process_sets=...), meets the
HOROVOD_DYNAMIC_PROCESS_SETS gate, runs collectives over its sets, then
adds and removes sets with the gate open: identical rank lists dedupe
to one id, freed ids are reused, ranks out of range, removing the global
set and an unknown id raise, and a rank outside a set raises instead of
joining it. The reference is horovod_tpu.core.process_sets
ProcessSetTable over 4 CPU devices, fed the same sequence; the contract
is tests/test_basics.py::test_process_set_registration and
::test_dynamic_process_sets_gate. Sums are of float32 rows of small
integers, exact in any order.
"""

import types

import jax
import numpy as np
import pytest

import torch_collectives_worker as W
from horovod_tpu.common.exceptions import HorovodTpuError
from horovod_tpu.core import process_sets as jps

K = 4


def _x():
    rng = np.random.default_rng(11)
    return rng.integers(-8, 9, (K, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.spawn(W.run_sets, tmp_path_factory.mktemp("sets"), {"x": _x()})


@pytest.fixture
def jax_table():
    """The JAX package's table over 4 CPU devices; its module-level
    global set is restored afterwards."""
    g = jps.global_process_set
    saved = (g.process_set_id, g.ranks, g.mesh)
    devs = jax.devices()[:K]
    state = types.SimpleNamespace(size=K, devices=devs, mesh=None)
    try:
        yield jps.ProcessSetTable(state)
    finally:
        g.process_set_id, g.ranks, g.mesh = saved


def _reference_sequence(table):
    """run_sets' sequence on the JAX table: (ids, table ids, errors)."""
    early = [jps.ProcessSet([0, 1]), jps.ProcessSet([3, 2])]
    init_ids = [table.register(ps) for ps in early]
    ids = []
    a = jps.ProcessSet([0, 1, 2, 3])
    ids.append(table.register(a))
    ids.append(table.register(jps.ProcessSet([3, 2, 1, 0])))
    b = jps.ProcessSet([1, 3])
    ids.append(table.register(b))
    size_index = [a.size(), a.rank_index(2), b.rank_index(3)]
    table.remove(a)
    c = jps.ProcessSet([0, 2])
    ids.append(table.register(c))
    table.remove(b)
    table.remove(early[0])
    d = jps.ProcessSet([2, 1, 1])
    ids.append(table.register(d))
    ids.append(table.register(jps.ProcessSet([0, 1, 3])))
    errors = {}
    for key, fn in (("out_of_range",
                     lambda: table.register(jps.ProcessSet([0, 5]))),
                    ("remove_global",
                     lambda: table.remove(jps.global_process_set)),
                    ("get_unknown", lambda: table.get(99))):
        with pytest.raises(HorovodTpuError):
            fn()
        errors[key] = True
    return dict(init_ids=init_ids, ids=ids, table=table.ids(),
                size_index=size_index, d_ranks=d.ranks,
                get_c=table.get(c.process_set_id).ranks, errors=errors)


def test_table_matches_jax_sequence(world, jax_table):
    ref = _reference_sequence(jax_table)
    assert ref["ids"] == [3, 3, 4, 3, 1, 4]  # dedupe, then free-list reuse
    for r in range(K):
        got = world[r]
        np.testing.assert_array_equal(got["init_ids"], ref["init_ids"])
        np.testing.assert_array_equal(got["ids"], ref["ids"])
        np.testing.assert_array_equal(got["table"], ref["table"])
        np.testing.assert_array_equal(got["size_index"], ref["size_index"])
        np.testing.assert_array_equal(got["d_ranks"], ref["d_ranks"])
        np.testing.assert_array_equal(got["get_c"], ref["get_c"])


@pytest.mark.parametrize("key", ["out_of_range", "remove_global",
                                 "get_unknown", "removed_set", "axis"])
def test_refusals(world, key):
    """Each raises HorovodError on every rank (the JAX package raises
    HorovodTpuError for the first three); an op on a removed set, and
    axis_process_set without HOROVOD_MESH (ROADMAP A11), too."""
    for r in range(K):
        assert str(world[r][f"err:{key}"]) == "HorovodError"


def test_dynamic_gate_before_the_knob(world):
    for r in range(K):
        assert str(world[r]["err:gate_add"]) == "HorovodError"
        assert str(world[r]["err:gate_remove"]) == "HorovodError"


def test_init_process_sets_and_membership(world):
    """Each rank sums over the init set it belongs to; the other set, or
    a broadcast root outside its own set, raises rather than hangs."""
    x = _x()
    for r in range(K):
        mine = [0, 1] if r < 2 else [2, 3]
        np.testing.assert_array_equal(world[r]["init_sum"],
                                      x[mine].sum(axis=0))
        assert str(world[r]["err:outside"]) == "HorovodError"
        assert str(world[r]["err:outside_bcast_root"]) == "HorovodError"


def test_collectives_over_a_reused_id(world):
    """[0, 1, 3] took a freed id and still reduces and gathers over its
    own ranks only."""
    x = _x()
    for r in (0, 1, 3):
        np.testing.assert_array_equal(world[r]["e_sum"],
                                      x[[0, 1, 3]].sum(axis=0))
        np.testing.assert_array_equal(world[r]["e_ag"],
                                      x[[0, 1, 3]].reshape(-1))
    assert "e_sum" not in world[2]
