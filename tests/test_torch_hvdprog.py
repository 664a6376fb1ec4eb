"""The same small programs, lowered by JAX and recorded by the port
(horovod_tpu_torch/analysis/graph.py) on the CPU, fire the same rule
sets, clean twins included; then the recorder's own contract.

| Rules | Program |
| --- | --- |
| HVD201 | an above-cap all-reduce against four bucket-sized ones |
| HVD202 | ``io_callback`` against ``.item()`` in the step |
| HVD203 | donated against updated in place, and neither |
| HVD204 | a contraction of 96 against one of 64, at lane 64 |
| HVD205 | a bf16->f32 upcast feeding a matmul, against one after it |
| HVD502 | a downcast before the reduce against one after it |
| HVD503 | a world-size divisor on a smaller group |
| HVD504 | scatter-add and unkeyed random numbers |
| HVD401/402 | per-rank programs in a gloo world of 4: a rank that skips one all-reduce, and the port's ring shift |

The port's collectives run in a gloo world of one (two- and four-rank
cases in a spawned world of 4, tests/torch_hvdprog_worker.py); the JAX
programs lower under shard_map on the conftest's virtual CPU devices.
"""

import glob
import os
import pickle
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu  # noqa: F401  (ensure_jax_api: jax.shard_map)
from horovod_tpu.analysis import hlo as jhlo
from horovod_tpu.analysis import hlo_rules as jhlo_rules
from horovod_tpu.analysis import numerics as jnum
from horovod_tpu.analysis import schedule as jsched
from horovod_tpu_torch import kernels
from horovod_tpu_torch.analysis import graph
from horovod_tpu_torch.analysis import hlo as thlo
from horovod_tpu_torch.analysis import numerics as tnum
from horovod_tpu_torch.analysis import schedule as tsched

from torch_world_worker import start_world
import torch_hvdprog_worker as worker

MB = 1 << 20


def rules(findings):
    return {f.rule_id for f in findings}


def jax_rules(texts, fams=("hlo", "num")):
    texts = [texts] if isinstance(texts, str) else texts
    out = set()
    if "hlo" in fams:
        for t in texts:
            out |= rules(jhlo.lint_text(t))
    if "sched" in fams:
        out |= rules(jsched.lint_schedules(
            [jsched.parse_schedule(t, f"p{i}") for i, t in enumerate(texts)]))
    if "num" in fams:
        out |= rules(jnum.lint_programs(
            [jnum.analyze_text(t, f"p{i}") for i, t in enumerate(texts)]))
    return out


def port_rules(progs, fams=("hlo", "num")):
    progs = [progs] if isinstance(progs, thlo.HloProgram) else progs
    out = set()
    if "hlo" in fams:
        for p in progs:
            out |= rules(thlo.lint_program(p))
    if "sched" in fams:
        out |= rules(tsched.lint_programs(progs))
    if "num" in fams:
        out |= rules(tnum.lint_programs(progs))
    return out


def _mesh(n, names=("hvd",), shape=None):
    devs = np.array(jax.devices()[:n]).reshape(shape or (n,))
    return Mesh(devs, names)


def _smap(fn, mesh, in_specs, out_specs=P()):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


@pytest.fixture(scope="module")
def hvd():
    """A gloo world of one for the port's collectives."""
    import horovod_tpu_torch
    with thlo.step_world(torch.device("cpu")):
        yield horovod_tpu_torch


@pytest.fixture
def lane64(monkeypatch):
    """Both packages at the port's lane (the JAX rule reads its module's
    LANE at call time)."""
    monkeypatch.setattr(jhlo_rules, "LANE", 64)


def rec(fn, *entries):
    return graph.record(fn, entries=[(t, None) for t in entries])[1]


# ------------------------------------------------- the small programs

@pytest.mark.parametrize("giant", [True, False], ids=["giant", "bucketed"])
def test_hvd201_above_cap_allreduce(hvd, giant):
    mesh = _mesh(2)
    if giant:
        jfn = _smap(lambda x: lax.psum(x, "hvd"), mesh, P())
        jtext = jax.jit(jfn).lower(jnp.ones((2048, 1024))).as_text()
        xs = [torch.ones(2048, 1024)]
    else:
        jfn = _smap(lambda *xs: tuple(lax.psum(x, "hvd") for x in xs), mesh,
                    (P(),) * 4, (P(),) * 4)
        jtext = jax.jit(jfn).lower(*[jnp.ones((512, 1024))] * 4).as_text()
        xs = [torch.ones(512, 1024) for _ in range(4)]
    prog = rec(lambda: [hvd.allreduce(x, op=hvd.Sum) for x in xs], *xs)
    # each input is read once and not donated: HVD203 in both packages
    want = ({"HVD201"} if giant else set()) | {"HVD203"}
    assert jax_rules(jtext, ("hlo",)) == want
    assert port_rules(prog, ("hlo",)) == want


@pytest.mark.parametrize("host", [True, False], ids=["host", "clean"])
def test_hvd202_host_transfer_in_the_step(host):
    from jax.experimental import io_callback

    def jstep(x):
        s = jnp.sum(x)
        if host:
            s = io_callback(lambda v: np.asarray(v, np.float32),
                            jax.ShapeDtypeStruct((), jnp.float32), s)
        return s * 2

    jtext = jax.jit(jstep).lower(jnp.ones((64,), jnp.float32)).as_text()
    x = torch.ones(64)

    def step():
        s = x.sum()
        if host:
            s = torch.tensor(s.item())  # the host reads the value
        return s * 2

    want = {"HVD202"} if host else set()
    assert jax_rules(jtext, ("hlo",)) == want
    assert port_rules(rec(step, x), ("hlo",)) == want


@pytest.mark.parametrize("mode", ["donated", "undonated"])
def test_hvd203_dead_input_not_donated(mode):
    donate = (0,) if mode == "donated" else ()
    jtext = jax.jit(lambda x: x * 2.0, donate_argnums=donate).lower(
        jnp.ones((1 << 20,), jnp.float32)).as_text()
    x = torch.ones(1 << 20)

    def step():
        return x.mul_(2.0) if mode == "donated" else x * 2.0

    want = {"HVD203"} if mode == "undonated" else set()
    assert jax_rules(jtext, ("hlo",)) == want
    prog = rec(step, x)
    assert prog.entry_params[0].donated == (mode == "donated")
    assert port_rules(prog, ("hlo",)) == want


@pytest.mark.parametrize("k", [96, 64])
def test_hvd204_contraction_at_lane_64(lane64, k):
    jtext = jax.jit(lambda a, b: a @ b).lower(
        jnp.ones((32, k), jnp.float32), jnp.ones((k, 64), jnp.float32)
    ).as_text()
    a, b = torch.ones(32, k), torch.ones(k, 64)
    want = {"HVD204"} if k == 96 else set()
    assert jax_rules(jtext, ("hlo",)) == want
    assert port_rules(rec(lambda: a @ b, a, b), ("hlo",)) == want


@pytest.mark.parametrize("where", ["before", "after"])
def test_hvd205_upcast_feeding_a_matmul(where):
    def jstep(x, w):
        if where == "before":
            return x.astype(jnp.float32) @ w.astype(jnp.float32)
        return (x @ w).astype(jnp.float32)

    jtext = jax.jit(jstep).lower(jnp.ones((64, 128), jnp.bfloat16),
                                 jnp.ones((128, 128), jnp.bfloat16)).as_text()
    x = torch.ones(64, 128, dtype=torch.bfloat16)
    w = torch.ones(128, 128, dtype=torch.bfloat16)

    def step():
        if where == "before":
            return x.float() @ w.float()
        return (x @ w).float()

    want = {"HVD205"} if where == "before" else set()
    assert jax_rules(jtext, ("hlo",)) == want
    assert port_rules(rec(step, x, w), ("hlo",)) == want


@pytest.mark.parametrize("where", ["before", "after"])
def test_hvd502_downcast_before_the_reduce(hvd, where):
    mesh = _mesh(2)

    def jlocal(g):
        if where == "before":
            return lax.psum(g.astype(jnp.bfloat16), "hvd")
        return lax.psum(g, "hvd").astype(jnp.bfloat16)

    jtext = jax.jit(_smap(jlocal, mesh, P())).lower(
        jnp.ones((256, 256), jnp.float32)).as_text()
    g = torch.ones(256, 256)

    def step():
        if where == "before":
            return hvd.allreduce(g.bfloat16(), op=hvd.Sum)
        return hvd.allreduce(g, op=hvd.Sum).bfloat16()

    want = {"HVD502"} if where == "before" else set()
    assert jax_rules(jtext, ("num",)) == want
    assert port_rules(rec(step, g), ("num",)) == want


@pytest.mark.parametrize("hazard", [True, False], ids=["hazard", "clean"])
def test_hvd504_scatter_add_and_unkeyed_random(hazard):
    def jstep(x, idx):
        if hazard:
            noise = lax.rng_uniform(jnp.float32(0), jnp.float32(1), (64,))
        else:
            noise = jax.random.uniform(jax.random.key(0), (64,),
                                       jnp.float32)
        return x.at[idx].add(noise[:8])

    jtext = jax.jit(jstep).lower(jnp.zeros((64,), jnp.float32),
                                 jnp.arange(8)).as_text()
    x, idx = torch.zeros(64), torch.arange(8)

    def step():
        if hazard:
            noise = torch.rand(64)
            return x.clone().index_add_(0, idx, noise[:8])
        noise = torch.rand(64, generator=torch.Generator().manual_seed(0))
        return x + noise

    want = {"HVD504"} if hazard else set()
    assert jax_rules(jtext, ("num",)) == want
    assert port_rules(rec(step, x, idx), ("num",)) == want


# ---------------------------------------------- the four-rank programs

@pytest.fixture(scope="module")
def rank_programs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sched")
    start_world(worker.schedule_programs,
                [(r, 4, str(out / "store"), str(out)) for r in range(4)],
                out, deadline=120).join()
    progs = {}
    for p in sorted(glob.glob(str(out / "*.pkl"))):
        name, rank = os.path.basename(p).split(".")[:2]
        with open(p, "rb") as fh:
            progs.setdefault(name, []).append(pickle.load(fh))
    return progs


def _two_programs(skip: bool):
    """JAX's per-device pair of the same step: two psums, one of which
    the second program leaves out."""
    mesh = _mesh(2)
    a = jnp.ones((256 * 1024,), jnp.float32)
    both = jax.jit(_smap(lambda a, b: (lax.psum(a, "hvd"),
                                       lax.psum(b, "hvd")),
                         mesh, (P(), P()), (P(), P()))).lower(a, a)
    one = jax.jit(_smap(lambda a, b: (a, lax.psum(b, "hvd")), mesh,
                        (P(), P()), (P(), P()))).lower(a, a)
    return [both.as_text(), (one if skip else both).as_text()]


def test_hvd401_a_rank_that_skips_one_allreduce(rank_programs):
    progs = rank_programs["skip"]
    assert [p.rank for p in progs] == [0, 1]
    assert [sum(op.opcode == "all_reduce" for op in p.ops)
            for p in progs] == [2, 1]
    jax_skip = jax_rules(_two_programs(True), ("sched",))
    assert jax_skip == {"HVD401"} == port_rules(progs, ("sched",))
    assert jax_rules(_two_programs(False), ("sched",)) == set()
    # each rank's program alone is consistent
    assert port_rules(progs[:1], ("sched",)) == set()


def test_hvd401_402_the_ring_shift_is_clean(rank_programs):
    progs = rank_programs["ring"]
    assert len(progs) == 4
    n = 4
    mesh = _mesh(n, ("sp",))
    pairs = [(i, (i + 1) % n) for i in range(n)]
    jtext = jax.jit(_smap(lambda x: lax.ppermute(x, "sp", pairs), mesh,
                          P("sp"), P("sp"))).lower(
        jnp.ones((4 * 1024,), jnp.float32)).as_text()
    assert jax_rules(jtext, ("sched",)) == set()
    assert port_rules(progs, ("sched",)) == set()
    ends = [sorted(op.opcode for op in p.ops if op.opcode in ("send",
                                                              "recv"))
            for p in progs]
    assert ends == [["recv", "send"]] * 4
    # a program set missing one rank's receive: its sender is orphaned
    import copy
    broken = copy.deepcopy(progs)
    broken[1].ops = [op for op in broken[1].ops if op.opcode != "recv"]
    assert "HVD402" in port_rules(broken, ("sched",))


@pytest.mark.parametrize("divisor", [2, 4], ids=["group", "world"])
def test_hvd503_world_divisor_on_a_smaller_group(rank_programs, divisor):
    mesh = _mesh(4, ("a", "b"), (2, 2))
    jtext = jax.jit(_smap(lambda g: lax.psum(g, "b") / divisor, mesh,
                          P())).lower(jnp.ones((256 * 1024,),
                                               jnp.float32)).as_text()
    progs = rank_programs["mean" if divisor == 2 else "baked"]
    want = {"HVD503"} if divisor == 4 else set()
    assert jax_rules(jtext, ("num",)) == want
    assert port_rules(progs, ("num",)) == want


# ----------------------------------------------------------- recorder

def test_recording_changes_nothing_it_sees():
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(32, 48))
    x = torch.randn(16, 32)

    def step():
        loss = torch.tanh(x @ w).square().mean()
        loss.backward()
        return loss.detach()

    plain = step()
    g_plain = w.grad.clone()
    w.grad = None
    recorded, prog = graph.record(step, entries=[(w, None), (x, None)])
    assert torch.equal(plain, recorded) and torch.equal(g_plain, w.grad)
    assert kernels.op_hook is None  # not left active
    assert [op.opcode for op in prog.ops][-1] == "return"


def test_recorder_holds_no_tensor_and_keys_by_identity():
    refs = []

    def step():
        big = torch.ones(1 << 20)
        refs.append(weakref.ref(big))
        a = big + 1.0
        del big, a
        z = torch.zeros(8)  # may reuse a freed id or address
        return z * 2.0

    _, prog = graph.record(step)
    assert refs[0]() is None
    by = {op.result: op for op in prog.ops}
    mul = [op for op in prog.ops if op.opcode == "multiply"][-1]
    assert by[mul.operands[0]].opcode == "zeros"


def test_kernel_plain_versions_carry_the_kernels_name():
    from horovod_tpu_torch.ops.conv_block import conv1x1_bn_act
    from horovod_tpu_torch.ops.flash_attention import flash_attention
    x = torch.randn(64, 16, requires_grad=True)
    w = torch.randn(16, 8, requires_grad=True)
    s, b = torch.ones(8, requires_grad=True), torch.zeros(8,
                                                          requires_grad=True)
    q = torch.randn(1, 2, 64, 16, requires_grad=True)

    def step():
        z, _ = conv1x1_bn_act(x, w, s, b)
        o = flash_attention(q, q, q, causal=True)
        (z.sum() + o.sum()).backward()

    _, prog = graph.record(step)
    regions = {op.attrs.split('region="')[1].split('"')[0]
               for op in prog.ops if 'region="' in op.attrs}
    assert regions == {"conv1x1_fwd_fused", "conv1x1_bn_act_bwd_fused",
                       "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"}


@kernels.kernel_op("conv1x1_fwd_fused")
def _meta_kernel(x, w):
    """A wrapper whose 'launch' is an allocation on the meta device (not
    the host, so the recorder takes it for the card's)."""
    return torch.empty(x.shape[0], w.shape[1], device=x.device)


def test_a_reported_kernel_is_one_custom_call_with_an_f32_accumulator():
    x, w = torch.randn(8, 4, device="meta"), torch.randn(4, 4, device="meta")

    def step():
        return _meta_kernel(x, w) * 2.0

    _, prog = graph.record(step, entries=[(x, None), (w, None)])
    calls = [op for op in prog.ops if op.opcode == "custom_call"]
    assert len(calls) == 1
    assert 'custom_call_target="conv1x1_fwd_fused"' in calls[0].attrs
    assert calls[0].operands == ("%arg0", "%arg1")
    assert tnum.accumulation_dtype(calls[0]) == "f32"
    # the wrapper's own allocation stays out; its result feeds the multiply
    assert not [op for op in prog.ops if op.opcode == "empty"]
    mul = next(op for op in prog.ops if op.opcode == "multiply")
    assert mul.operands[0] == calls[0].result
    assert kernels.op_hook is None
    assert _meta_kernel(x, w).shape == (8, 4)  # no recording: a plain call


def test_a_wrapper_on_another_thread_is_not_recorded():
    import threading
    x, w = torch.randn(8, 4, device="meta"), torch.randn(4, 4, device="meta")
    from horovod_tpu_torch.ops.conv_block import conv1x1_fwd_fused
    xc, wc = torch.randn(8, 4), torch.randn(4, 4)
    progs = {}

    def other():  # a serving request, say, while a warm-up records
        _meta_kernel(x, w)
        conv1x1_fwd_fused(xc, wc)

    def step():
        t = threading.Thread(target=other)
        t.start()
        t.join()

    def own(key):  # a second recording on its own thread
        progs[key] = graph.record(lambda: _meta_kernel(x, w))[1]

    t = threading.Thread(target=own, args=("own",))
    t.start()
    progs["step"] = graph.record(step)[1]
    t.join()
    assert not [op for op in progs["step"].ops
                if op.opcode == "custom_call" or "region=" in op.attrs]
    assert [op.opcode for op in progs["own"].ops].count("custom_call") == 1
    assert kernels.op_hook is None


def test_hvd501_reads_the_accumulation_type_the_op_uses(monkeypatch):
    """The mapping of numerics.accumulation_dtype's docstring."""
    m = torch.backends.cuda.matmul
    split, whole = (64, 64, 4096, 1), (4096, 4096, 4096, 1)
    assert graph.split_k_possible(*split)
    assert not graph.split_k_possible(*whole)  # 1024 tiles fill the SMs
    assert not graph.split_k_possible(64, 64, 512, 1)  # K too short
    assert not graph.split_k_possible(64, 64, 4096, 200)  # the batch fills
    monkeypatch.setattr(m, "allow_bf16_reduced_precision_reduction", False)
    monkeypatch.setattr(m, "allow_fp16_reduced_precision_reduction", True)
    assert graph.accumulation_type(torch.bfloat16, "dot", split) == "f32"
    assert graph.accumulation_type(torch.float16, "dot", split) == "f16"
    assert graph.accumulation_type(torch.float16, "dot", whole) == "f32"
    assert graph.accumulation_type(torch.float32, "dot", split) == "f32"
    monkeypatch.setattr(m, "allow_bf16_reduced_precision_reduction", True)
    monkeypatch.setattr(m, "allow_fp16_reduced_precision_reduction", False)
    assert graph.accumulation_type(torch.bfloat16, "dot", split) == "bf16"
    assert graph.accumulation_type(torch.bfloat16, "dot", whole) == "f32"
    assert graph.accumulation_type(torch.float16, "dot", split) == "f32"
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        assert graph.accumulation_type(dt, "convolution", split) == "f32"
    # recorded on the host, the card's mapping: a long-K bf16 product
    # may split, a short one does not
    b = torch.ones(16, 2048, dtype=torch.bfloat16)
    prog = rec(lambda: b @ b.t(), b)
    dot = next(op for op in prog.ops if op.opcode == "dot")
    assert tnum.accumulation_dtype(dot) == "bf16"
    assert rules(tnum.lint_programs([prog])) == {"HVD501"}
    # a bf16 matmul returns bf16 and accumulates in f32
    a = torch.ones(16, 64, dtype=torch.bfloat16)
    prog = rec(lambda: a @ a.t(), a)
    dot = next(op for op in prog.ops if op.opcode == "dot")
    assert dot.result_types[0].dtype == "bf16"
    assert tnum.accumulation_dtype(dot) == "f32"
    assert port_rules(prog, ("num",)) == set()
    text = ("module @m {\n  func.func public @main(%arg0: tensor<16x64xbf16>)"
            " -> tensor<16x16xbf16> {\n    %0 = stablehlo.dot_general %arg0,"
            " %arg0, contracting_dims = [1] x [1] : (tensor<16x64xbf16>, "
            "tensor<16x64xbf16>) -> tensor<16x16xbf16>\n    return %0 : "
            "tensor<16x16xbf16>\n  }\n}\n")
    # in lowered text the result type is the accumulator, as in JAX
    assert rules(tnum.lint_text(text)) == rules(jnum.lint_text(text)) == {
        "HVD501"}
