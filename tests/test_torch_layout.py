"""The port's layout pass (horovod_tpu_torch/ops/layout.py with
models/resnet.conv_stack) and OnlineLayoutTuner against the JAX
package's (horovod_tpu/ops/layout.py, core/autotune.py).

A mini ResNet (STAGE_BLOCKS[8] = (1, 1), 16x16 input, 10 classes, f32)
gets numpy seed-0 parameters in the tree the JAX `init` gives; the port
takes them through models/convert.from_jax. At lane 128 the port's plan
must make the JAX plan's decisions edge for edge, pad and strip must
round-trip bit for bit and agree with the JAX pad, the padded model's
loss must match the padded JAX model's within 1e-5 relative, its
stripped gradients the JAX ones within 5e-5 of the largest, and its
padded-lane gradients must be exactly 0. The tuners get the same step
walls and must make the same moves; a gloo world of 2 must follow rank
0's decision.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.common.config import Config as JConfig
from horovod_tpu.core.autotune import OnlineLayoutTuner as JTuner
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.ops import layout as jlayout
from horovod_tpu_torch.common.config import Config as TConfig
from horovod_tpu_torch.core.autotune import OnlineLayoutTuner as TTuner
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as tresnet
from horovod_tpu_torch.ops import layout as tlayout
from horovod_tpu_torch.ops.layout import LayoutError, Site

TOL_LOSS = 1e-5   # padded port loss vs padded JAX loss, relative
TOL_GRAD = 5e-5   # stripped gradients, of the largest magnitude
TOL_TRAIN = 1e-4  # stripped padded training vs declared, of the largest


def _close(a, b, tol, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= tol * (np.max(np.abs(a)) + 1e-9), \
        (what, np.max(np.abs(a - b)), np.max(np.abs(a)))


def _draw(shapes, rng, stats):
    """numpy leaves for a shape tree: He-normal conv/FC weights, BN
    scale near 1, small biases; running mean near 0, var near 1."""
    def leaf(path, s):
        key = jax.tree_util.keystr(path)
        z = rng.standard_normal(s.shape)
        if stats:
            v = 1.0 + 0.1 * np.abs(z) if key.endswith("['var']") \
                else 0.1 * z
        elif len(s.shape) >= 2:
            v = z * (2.0 / np.prod(s.shape[:-1])) ** 0.5
        elif key.endswith("['scale']"):
            v = 1.0 + 0.1 * z
        else:
            v = 0.1 * z
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def mini():
    """(params, stats) numpy trees of the depth-8 mini ResNet, with
    STAGE_BLOCKS[8] set in both packages for the module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jresnet.STAGE_BLOCKS, 8, (1, 1))
        mp.setitem(tresnet.STAGE_BLOCKS, 8, (1, 1))
        p_shapes, s_shapes = jax.eval_shape(
            lambda: jresnet.init(jax.random.PRNGKey(0), depth=8,
                                 num_classes=10, dtype=jnp.float32))
        rng = np.random.default_rng(0)
        yield _draw(p_shapes, rng, False), _draw(s_shapes, rng, True)


def _state(params, stats):
    return {k: torch.from_numpy(v.copy())
            for k, v in convert.from_jax(params, stats).items()}


def _plans(params, stats, **kw):
    jp = jlayout.plan(params, jresnet.conv_stack(8), **kw)
    tp = tlayout.plan(_state(params, stats), tresnet.conv_stack(8),
                      lane=tlayout.TPU_LANE, **kw)
    return jp, tp


def _edges(plan):
    return {n: (e.size, e.padded, round(e.waste_pct, 9))
            for n, e in plan.edges.items()}


# ------------------------------------------------------------ the plan

def test_plan_at_lane_128_is_the_jax_plan(mini):
    params, stats = mini
    jp, tp = _plans(params, stats)
    assert _edges(tp) == _edges(jp)
    assert tp.padded_edges() == jp.padded_edges() == {
        "stem": (64, 128), "s0b0.c1": (64, 128), "s0b0.c2": (64, 128)}
    assert tp.mode == jp.mode == tlayout.NHWC_PADDED
    assert tp.summary() == jp.summary()
    assert tp.summary()["lane"] == 128


def test_summary_stamps_the_lane(mini):
    params, stats = mini
    state = _state(params, stats)
    s64 = tlayout.plan(state, tresnet.conv_stack(8)).summary()
    assert s64 == {"mode": "as_declared", "lane": 64, "edges": 8,
                   "padded_edges": {}, "max_waste_removed_pct": 0.0}
    s128 = tlayout.plan(state, tresnet.conv_stack(8), lane=128).summary()
    assert s128["lane"] == 128 and s128["max_waste_removed_pct"] == 50.0
    assert s128["padded_edges"]["stem"] == [64, 128]


def test_pad_strip_round_trip_and_match_jax_pad(mini):
    """pad/strip round-trip bit for bit on parameters and stats, and the
    port's pad of the converted trees is from_jax of the JAX pad."""
    params, stats = mini
    jp, tp = _plans(params, stats)
    state = _state(params, stats)
    padded = tp.pad(state)
    want = convert.from_jax(jax.tree_util.tree_map(np.asarray,
                                                   jp.pad(params)),
                            jax.tree_util.tree_map(np.asarray,
                                                   jp.pad(stats)))
    assert set(padded) == set(want)
    for k, v in padded.items():
        assert np.array_equal(v.numpy(), want[k]), k
    back = tp.strip(padded)
    for k, v in state.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k
    assert padded["s0b0.conv1"].shape == (128, 128)      # (Cin, Cout)
    assert padded["s0b0.conv2"].shape == (128, 128, 3, 3)  # OIHW
    assert padded["stem.conv"].shape == (128, 3, 7, 7)
    assert padded["s0b0.conv3"].shape == (128, 256)
    assert padded["fc.w"] is state["fc.w"]  # undeclared edges: shared


def test_load_jax_takes_a_padded_tree(mini):
    """convert.load_jax resizes a declared-width model to the padded
    JAX tree; from_state builds the same model from the port's pad."""
    params, stats = mini
    jp, tp = _plans(params, stats)
    model = tresnet.ResNet(8, 10)
    convert.load_jax(model, jp.pad(params), jp.pad(stats))
    other = tresnet.ResNet.from_state(tp.pad(_state(params, stats)), 8)
    a, b = model.state_dict(), other.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert tresnet.widths_of(a, 8)["s0b0.c2"] == 128


@pytest.fixture(scope="module")
def jax_padded(mini):
    """The JAX model's padded loss and its as-declared loss, gradients
    and new stats on one seeded batch (unfused JAX route)."""
    params, stats = mini
    jp = jlayout.plan(params, jresnet.conv_stack(8))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    yl = rng.integers(0, 10, (2,))
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HOROVOD_CONV_BLOCK", raising=False)
        mp.delenv("HOROVOD_FUSE_CONV_BN", raising=False)

        def loss(p, s):
            return jresnet.loss_fn(p, s, (jnp.asarray(x), jnp.asarray(yl)),
                                   depth=8, train=True)
        lp = float(jax.jit(loss)(jp.pad(params), jp.pad(stats))[0])
        (ld, ns), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params, stats)
    return dict(x=x, y=yl, loss_padded=lp, loss=float(ld),
                grads=convert.from_jax(g, ns))


@pytest.mark.parametrize("route", ["block", "fuse_bn", "unfused"])
def test_padded_model_matches_padded_jax(route, mini, jax_padded,
                                         monkeypatch):
    """The padded port model on each routing of its 1x1 sites (the
    kernels' plain versions on the CPU): f32 loss against the padded JAX
    model's, stripped gradients against the JAX ones, padded-lane
    gradients exactly 0."""
    monkeypatch.setenv("HOROVOD_CONV_BLOCK", "1" if route == "block" else "0")
    monkeypatch.setenv("HOROVOD_FUSE_CONV_BN",
                       "1" if route == "fuse_bn" else "0")
    params, stats = mini
    _, tp = _plans(params, stats)
    model = tresnet.ResNet.from_state(tp.pad(_state(params, stats)), 8)
    loss, _ = tresnet.loss_fn(model, (torch.from_numpy(jax_padded["x"]),
                                      torch.from_numpy(jax_padded["y"])))
    loss.backward()
    lj = jax_padded["loss_padded"]
    assert abs(loss.item() - lj) <= TOL_LOSS * abs(lj)
    assert abs(lj - jax_padded["loss"]) <= TOL_LOSS * abs(lj)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert tp.padding_max(grads) == 0.0
    assert float(grads["s0b0.conv1"][:, 64:].abs().max()) == 0.0
    assert float(grads["s0b0.conv1"][64:, :].abs().max()) == 0.0
    stripped = tp.strip(grads)
    for n, g in stripped.items():
        _close(jax_padded["grads"][n], g.numpy(), TOL_GRAD, n)


def test_padded_training_stays_exact(mini, tmp_path):
    """SGD with momentum through DistributedOptimizer (a gloo world of
    1): 2 declared steps, relayout to padded, 3 steps, relayout back,
    1 step; against 6 declared steps from the same weights. The padded
    lanes of weights, BN parameters, running stats and momentum stay
    exactly 0, and the stripped state tracks the declared run."""
    import horovod_tpu_torch as hvd
    params, stats = mini
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        def make_opt(m):
            return hvd.DistributedOptimizer(
                torch.optim.SGD(m.parameters(), lr=0.05, momentum=0.9),
                named_parameters=m.named_parameters())

        gen = torch.Generator().manual_seed(3)
        batch = (torch.randn((2, 16, 16, 3), generator=gen),
                 torch.randint(0, 10, (2,), generator=gen))

        def step(model, opt):
            opt.zero_grad()
            loss, new = tresnet.loss_fn(model, batch)
            loss.backward()
            opt.step()
            model.set_stats(new)

        ref = tresnet.ResNet.from_state(_state(params, stats), 8)
        ref_opt = make_opt(ref)
        for _ in range(6):
            step(ref, ref_opt)
        model = tresnet.ResNet.from_state(_state(params, stats), 8)
        opt = make_opt(model)
        plan = tlayout.plan(model.state_dict(), tresnet.conv_stack(8),
                            lane=128)
        for _ in range(2):
            step(model, opt)
        model, opt = tresnet.relayout(model, opt, plan, tlayout.NHWC_PADDED,
                                      make_opt)
        assert model.s0b0.conv1.shape == (128, 128)
        for _ in range(3):
            step(model, opt)
        moms = {n: opt.state[p]["momentum_buffer"]
                for n, p in model.named_parameters()}
        assert plan.padding_max(model.state_dict()) == 0.0
        assert plan.padding_max(moms) == 0.0
        model, opt = tresnet.relayout(model, opt, plan, tlayout.AS_DECLARED,
                                      make_opt)
        assert model.s0b0.conv1.shape == (64, 64)
        step(model, opt)
        got, want = model.state_dict(), ref.state_dict()
        for k in want:
            _close(want[k].numpy(), got[k].numpy(), TOL_TRAIN, k)
    finally:
        hvd.shutdown()


# ------------------------------------------------- knobs, caps, errors

def test_disabled_by_env(mini, monkeypatch):
    monkeypatch.setenv("HOROVOD_LAYOUT_PAD", "0")
    params, stats = mini
    jp, tp = _plans(params, stats)
    assert tp.mode == jp.mode == tlayout.AS_DECLARED
    assert not tp.padded_edges()
    state = _state(params, stats)
    for k, v in tp.pad(state).items():
        assert v.shape == state[k].shape


@pytest.mark.parametrize("floor,want", [(None, {}),
                                        (1.0, {"cls": (1000, 1024)})])
def test_waste_floor_and_growth_cap(floor, want):
    """An edge under the waste floor stays unpadded (1000 classes at
    2.3% waste); the growth cap rejects 3→128; the JAX plan agrees."""
    stack = [Site("a", {0: "cls"}), Site("b", {0: "img"})]
    jstack = [jlayout.Site("a", {0: "cls"}), jlayout.Site("b", {0: "img"})]
    tp = tlayout.plan({"a": torch.zeros(1000, 16), "b": torch.zeros(3, 16)},
                      stack, min_waste_pct=floor, lane=128)
    jp = jlayout.plan({"a": jnp.zeros((1000, 16)), "b": jnp.zeros((3, 16))},
                      jstack, min_waste_pct=floor)
    assert tp.padded_edges() == jp.padded_edges() == want


def test_edge_size_conflict_raises():
    stack = [Site("a", {0: "e"}), Site("b", {0: "e"})]
    with pytest.raises(LayoutError, match="two sizes"):
        tlayout.plan({"a": torch.zeros(64, 8), "b": torch.zeros(96, 8)},
                     stack, lane=128)
    with pytest.raises(LayoutError, match="no dim"):
        tlayout.plan({"a": torch.zeros(64)}, [Site("a", {1: "e"})])


def test_pad_rejects_unexpected_shape(mini):
    params, stats = mini
    _, tp = _plans(params, stats)
    bad = tp.pad(_state(params, stats))
    bad["s0b0.conv1"] = torch.zeros(100, 100)
    with pytest.raises(LayoutError, match="dim"):
        tp.pad(bad)


def test_pad_is_idempotent(mini):
    params, stats = mini
    _, tp = _plans(params, stats)
    once = tp.pad(_state(params, stats))
    twice = tp.pad(once)
    for k, v in once.items():
        assert torch.equal(v, twice[k]), k


def test_resnet50_plans_on_the_meta_device():
    """At the port's lane (64) ResNet-50 is as declared; at 128 its plan
    is the JAX package's (on the shapes the JAX init traces)."""
    state = tresnet.ResNet(50, device="meta").state_dict()
    p64 = tlayout.plan(state, tresnet.conv_stack(50))
    assert p64.mode == tlayout.AS_DECLARED and p64.lane == 64
    assert len(p64.edges) == 38 and not p64.padded_edges()
    shapes = jax.eval_shape(lambda: jresnet.init(jax.random.PRNGKey(0), 50))
    jp = jlayout.plan(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes[0]),
        jresnet.conv_stack(50))
    p128 = tlayout.plan(state, tresnet.conv_stack(50), lane=128)
    assert _edges(p128) == _edges(jp)
    assert sorted(p128.padded_edges()) == [
        "s0b0.c1", "s0b0.c2", "s0b1.c1", "s0b1.c2", "s0b2.c1", "s0b2.c2",
        "stem"]
    padded = tresnet.fused_sites(50, 32, 224, {
        **tresnet.declared_widths(50),
        **{e: w for e, (_, w) in p128.padded_edges().items()}})
    assert ("s0b0", "conv1", 100352, 128, 128) in padded
    assert ("s0b1", "conv3", 100352, 128, 256) in padded


def test_default_construction_is_unchanged(mini):
    """widths=None draws, in order, what explicit declared widths draw,
    and the declared widths are the fixed ones (64 · 2^s, 4x trunks)."""
    a = tresnet.ResNet(8, 10).state_dict()
    b = tresnet.ResNet(8, 10, widths=tresnet.declared_widths(8)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert tresnet.widths_of(a, 8) == {
        "img": 3, "stem": 64, "s0": 256, "s0b0.c1": 64, "s0b0.c2": 64,
        "s1": 512, "s1b0.c1": 128, "s1b0.c2": 128}


# ------------------------------------------------------------ the tuner

def _tuners(interval=3, enabled=True, arms=("as_declared", "nhwc_padded")):
    cfgs = [dataclasses.replace(C(), layout_autotune=enabled,
                                layout_autotune_interval=interval)
            for C in (JConfig, TConfig)]
    return JTuner(cfgs[0], arms=arms), TTuner(cfgs[1], arms=arms)


def _drive(t, wall, max_steps=200):
    """(step, update() result, choice) at every step until frozen."""
    trace, seen = [], {}
    for step in range(max_steps):
        if t.frozen:
            break
        seen[t.choice] = seen.get(t.choice, 0) + 1
        t.record_step(wall(t.choice, seen[t.choice]))
        trace.append((step, t.update(), t.choice))
    return trace


WALLS = {
    "padded_faster": lambda arm, n: 0.1 if arm == "nhwc_padded" else 0.2,
    "padded_slower": lambda arm, n: 0.2 if arm == "nhwc_padded" else 0.1,
    "recompile_spike": lambda arm, n: 50.0 if n <= 1 else (
        0.2 if arm == "as_declared" else 0.1),
    "noisy": lambda arm, n: 0.1 + 0.01 * ((n * 7) % 5) + (
        0.003 if arm == "nhwc_padded" else 0.0),
    "zero_walls_ignored": lambda arm, n: 0.0 if n % 3 == 0 else (
        0.3 if arm == "as_declared" else 0.2),
}


@pytest.mark.parametrize("interval", [2, 3, 5])
@pytest.mark.parametrize("case", sorted(WALLS))
def test_tuner_makes_the_jax_tuners_moves(case, interval):
    jt, tt = _tuners(interval)
    assert _drive(tt, WALLS[case]) == _drive(jt, WALLS[case])
    assert tt.frozen and jt.frozen
    assert tt.choice == jt.choice and tt.result == jt.result


def test_tuner_three_arms_and_errors():
    arms = ("as_declared", "nhwc_padded", "third")
    jt, tt = _tuners(3, arms=arms)
    wall = lambda arm, n: {"as_declared": 0.3, "nhwc_padded": 0.2,  # noqa
                           "third": 0.1}[arm]
    assert _drive(tt, wall) == _drive(jt, wall)
    assert tt.choice == "third" == tt.result["winner"]
    with pytest.raises(ValueError):
        _tuners(3, arms=("as_declared",))


def test_tuner_disabled_is_inert():
    jt, tt = _tuners(enabled=False)
    for t in (jt, tt):
        assert t.frozen
        t.record_step(1.0)
        assert not t.update()
        assert t.choice == "as_declared" and t.result is None


def test_tuner_config_knobs(monkeypatch):
    monkeypatch.setenv("HOROVOD_LAYOUT_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_LAYOUT_AUTOTUNE_INTERVAL", "7")
    t, j = TConfig.from_env(), JConfig.from_env()
    assert (t.layout_autotune, t.layout_autotune_interval) == \
        (j.layout_autotune, j.layout_autotune_interval) == (True, 7)
    d = TConfig()
    assert (d.layout_autotune, d.layout_autotune_interval) == (False, 20)


def test_tuner_world_follows_rank_0(tmp_path):
    """Two gloo ranks train the mini ResNet under the tuner with walls
    that make each rank prefer another arm; both end on rank 0's
    (padded), swapped at the same steps, with the padded lanes of the
    weights, stats and momentum exactly 0."""
    from torch_layout_worker import run_tuner
    from torch_world_worker import spawn_world

    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    spawn_world(run_tuner, [(r, 2, store, outs[r]) for r in range(2)],
                tmp_path, deadline=120)
    res = [json.load(open(o)) for o in outs]
    assert [r["choice"] for r in res] == ["nhwc_padded"] * 2
    # 2 discarded + 3 timed steps of the declared arm, then the swap
    assert res[0]["changes"] == res[1]["changes"] == [[4, "nhwc_padded"]]
    assert res[0]["result"]["winner"] == "nhwc_padded"
    assert all(r["frozen"] for r in res)
    assert [r["padded_lanes_max"] for r in res] == [0.0, 0.0]
    assert res[0]["conv1"] == res[1]["conv1"] == [128, 128]
