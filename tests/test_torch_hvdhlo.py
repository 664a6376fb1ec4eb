"""The port's analyzers of step programs (horovod_tpu_torch/analysis:
hlo, hlo_rules, shard, shard_rules, schedule, sched_rules, numerics,
num_rules) against the JAX package's on the same lowered text.

For each of the 40 fixtures in tests/fixtures/hlo/, both packages'
parsers give the same model (ops, operands, types, params, donation
bits) and each rule family gives the same findings as (rule, line)
sets, at the JAX package's settings, each set explicitly: lane 128
(hlo_rules.LANE), the 16 GB HBM budget of a TPU v5e core
(HOROVOD_HLO_LINT_HBM_BUDGET) and the JAX TPU link table
(HOROVOD_SCHED_LINK_GBPS). Then the cross-file sets (the HVD401 pair,
HVD505 over the mesh4/mesh8 files), the JAX tests' environment cases
(HOROVOD_HLO_LINT_*, HOROVOD_SHARD_LINT_*, HOROVOD_SCHED_*,
HOROVOD_NUM_*) and `comms_model` on the same schedule and link table.
Separate cases hold the port's own defaults: lane 64, the recording
card's memory as the budget, the H100 link table.
"""

import glob
import os

import pytest

from horovod_tpu.analysis import hlo as jhlo
from horovod_tpu.analysis import numerics as jnum
from horovod_tpu.analysis import schedule as jsched
from horovod_tpu.analysis import shard as jshard
from horovod_tpu_torch.analysis import hlo as thlo
from horovod_tpu_torch.analysis import numerics as tnum
from horovod_tpu_torch.analysis import schedule as tsched
from horovod_tpu_torch.analysis import shard as tshard
from horovod_tpu_torch.analysis import shard_rules as tshard_rules

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "hlo")
FIXTURES = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(FIXDIR, "*")))
FAMILIES = {"hlo": (jhlo, thlo), "shard": (jshard, tshard),
            "sched": (jsched, tsched), "num": (jnum, tnum)}
JAX_SETTINGS = {"HOROVOD_HLO_LINT_HBM_BUDGET": "16G",
                "HOROVOD_SCHED_LINK_GBPS": "ici=90,dcn=12.5"}


def path(name):
    return os.path.join(FIXDIR, name)


def text(name):
    with open(path(name), encoding="utf-8") as fh:
        return fh.read()


def keys(findings):
    return {(f.rule_id, f.line, os.path.basename(f.path)) for f in findings}


@pytest.fixture
def jax_settings(monkeypatch):
    from horovod_tpu_torch.analysis import hlo_rules
    monkeypatch.setattr(hlo_rules, "LANE", 128)
    for k, v in JAX_SETTINGS.items():
        monkeypatch.setenv(k, v)


def _ttype(t):
    return None if t is None else (t.dtype, t.dims)


def _model(prog):
    ops = [(op.line, op.result, op.opcode, op.operands,
            tuple(map(_ttype, op.operand_types)),
            tuple(map(_ttype, op.result_types)), op.attrs, op.scope,
            op.literal) for op in prog.ops]
    params = [(p.index, p.name, _ttype(p.type), p.donated, p.scope, p.line,
               p.sharding) for p in prog.params]
    return (ops, params, prog.entry_scope, prog.fmt, prog.num_partitions)


def test_the_fixture_set_is_the_forty():
    assert len(FIXTURES) == 40


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_model_and_findings_match_jax(jax_settings, name):
    src = text(name)
    assert _model(thlo.parse(src, name)) == _model(jhlo.parse(src, name))
    for fam, (jmod, tmod) in FAMILIES.items():
        want = keys(jmod.lint_files([path(name)]))
        got = keys(tmod.lint_files([path(name)]))
        assert got == want, (fam, got, want)


CROSS_SETS = [
    ("sched", ["hvd401_pair_a.hlo", "hvd401_pair_b.hlo"]),
    ("sched", ["hvd402_sp_ring.mlir", "hvd402_sp_broken_ring.mlir",
               "hvd402_pp_1f1b.mlir"]),
    ("num", ["hvd505_mesh4_mean.hlo", "hvd505_mesh8_mean.hlo"]),
    ("num", ["hvd505_mesh4_sum.hlo", "hvd505_mesh8_sum.hlo"]),
    ("num", ["hvd505_mesh4_mean.hlo", "hvd505_mesh8_sum.hlo"]),
    ("num", ["hvd505_mesh4_sum.hlo", "hvd505_mesh4_mean.hlo",
             "hvd505_mesh8_sum.hlo", "hvd505_mesh8_mean.hlo"]),
    ("num", ["hvd503_group_mean.hlo", "hvd503_baked_world_divisor.hlo"]),
]


@pytest.mark.parametrize("fam,names", CROSS_SETS,
                         ids=[f"{f}-{n[0][:-4]}" for f, n in CROSS_SETS])
def test_cross_file_sets_match_jax(jax_settings, fam, names):
    jmod, tmod = FAMILIES[fam]
    files = [path(n) for n in names]
    want = keys(jmod.lint_files(files))
    assert keys(tmod.lint_files(files)) == want
    if names[0].startswith(("hvd401", "hvd505_mesh4_sum")):
        assert want  # the pair really fires


#: (env, family, fixtures, select) of the JAX tests' environment cases.
ENV_CASES = [
    ({"HOROVOD_HLO_LINT_MAX_COLLECTIVE_BYTES": str(1 << 30)}, "hlo",
     ["hvd201_giant_allreduce.mlir"], None),
    ({"HOROVOD_BUCKET_CAP": "0"}, "hlo", ["hvd201_giant_allreduce.mlir"],
     None),
    ({"HOROVOD_BUCKET_CAP": str(64 << 20)}, "hlo",
     ["hvd201_giant_allreduce.mlir", "hvd201_chained.mlir"], None),
    ({"HOROVOD_HLO_LINT_MIN_DONATION_BYTES": str(1 << 30)}, "hlo",
     ["hvd203_undonated.mlir"], None),
    ({"HOROVOD_HLO_LINT_PAD_WASTE_MIN_PCT": "60"}, "hlo",
     ["hvd204_resnet_block.mlir"], None),
    ({"HOROVOD_SHARD_LINT_MIN_REPLICATED_BYTES": "16M"}, "shard",
     ["hvd301_replicated_emb.mlir"], None),
    ({"HOROVOD_SHARD_LINT_MIN_RESHARD_BYTES": "1G"}, "shard",
     ["hvd302_allgather_inserted.hlo", "hvd305_allreduce_slice.mlir"], None),
    ({"HOROVOD_HLO_LINT_HBM_BUDGET": "56M"}, "shard",
     ["hvd303_overbudget.hlo", "hvd303_donated_underbudget.hlo"], None),
    ({"HOROVOD_HLO_LINT_HBM_BUDGET": "16GiB"}, "shard",
     ["hvd303_overbudget.hlo"], None),
    ({"HOROVOD_SHARD_LINT_MIN_SHARDED_BYTES": "1G"}, "shard",
     ["hvd304_unused_axis.mlir"], None),
    ({"HOROVOD_MESH_SLICES": "2"}, "sched",
     ["hvd404_flat_allreduce.mlir", "hvd404_staged_allreduce.mlir"], None),
    ({"HOROVOD_MESH_SLICES": "2",
      "HOROVOD_SCHED_MIN_STAGED_BYTES": "1G"}, "sched",
     ["hvd404_flat_allreduce.mlir"], None),
    ({"HOROVOD_MESH_SLICES": "two"}, "sched",
     ["hvd404_flat_allreduce.mlir"], None),
    ({"HOROVOD_SCHED_OVERLAP_WINDOW_MS": "0.001"}, "sched",
     ["hvd404_flat_allreduce.mlir"], ["HVD405"]),
    ({"HOROVOD_SCHED_OVERLAP_WINDOW_MS": "1000"}, "sched",
     ["hvd404_flat_allreduce.mlir"], ["HVD405"]),
    ({"HOROVOD_SCHED_PEAK_TFLOPS": "100"}, "sched",
     ["hvd404_flat_allreduce.mlir"], ["HVD405"]),
    ({"HOROVOD_SCHED_PEAK_TFLOPS": "100",
      "HOROVOD_SCHED_OVERLAP_FRACTION": "0.5"}, "sched",
     ["hvd404_flat_allreduce.mlir"], ["HVD405"]),
    ({"HOROVOD_SCHED_LINK_GBPS": "warp=9",
      "HOROVOD_SCHED_OVERLAP_WINDOW_MS": "1"}, "sched",
     ["hvd404_flat_allreduce.mlir"], None),
    ({"HOROVOD_SCHED_LINK_GBPS": "ici=45, dcn=6.25",
      "HOROVOD_SCHED_OVERLAP_WINDOW_MS": "0.01", "HOROVOD_MESH_SLICES": "2"},
     "sched", ["hvd404_flat_allreduce.mlir"], None),
    ({"HOROVOD_NUM_ALLOW_ACCUM": "bf16"}, "num", ["hvd501_bf16_dot.mlir"],
     ["HVD501"]),
    ({"HOROVOD_NUM_ALLOW_ACCUM": "f16"}, "num", ["hvd501_bf16_dot.mlir"],
     ["HVD501"]),
    ({"HOROVOD_NUM_ALLOW_ACCUM": "bfloat16"}, "num",
     ["hvd501_bf16_dot.mlir"], ["HVD501"]),
    ({"HOROVOD_NUM_MIN_REDUCE_BYTES": "1G"}, "num",
     ["hvd502_downcast_then_reduce.mlir", "hvd503_baked_world_divisor.hlo"],
     None),
    ({"HOROVOD_NUM_MIN_REDUCE_BYTES": "lots"}, "num",
     ["hvd502_downcast_then_reduce.mlir"], None),
    ({"HOROVOD_NUM_SCALE_TOL": "1e-6"}, "num",
     ["hvd503_baked_world_divisor.hlo"], ["HVD503"]),
    ({"HOROVOD_NUM_SCALE_TOL": "tight"}, "num",
     ["hvd503_baked_world_divisor.hlo"], ["HVD503"]),
]


@pytest.mark.parametrize("env,fam,names,select", ENV_CASES,
                         ids=[f"{i}-{c[1]}" for i, c in enumerate(ENV_CASES)])
def test_environment_cases_match_jax(jax_settings, monkeypatch, env, fam,
                                     names, select):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jmod, tmod = FAMILIES[fam]
    files = [path(n) for n in names]
    outcome = {}
    for side, mod in (("jax", jmod), ("port", tmod)):
        try:
            outcome[side] = keys(mod.lint_files(files, select=select))
        except ValueError as e:
            name = next(k for k in env if k in str(e))
            outcome[side] = ("ValueError", name)
    assert outcome["port"] == outcome["jax"]


COMMS_CASES = [
    ("hvd402_sp_ring.mlir", [("dp", 1), ("pp", 1), ("ep", 1), ("sp", 4),
                             ("tp", 1)], None),
    ("hvd404_flat_allreduce.mlir", [("dp", 1), ("pp", 1), ("ep", 1),
                                    ("sp", 1), ("tp", 1), ("hvd", 8)], None),
    ("hvd404_flat_allreduce.mlir", [("dp", 1), ("pp", 1), ("ep", 1),
                                    ("sp", 1), ("tp", 1), ("hvd", 8)], 2),
    ("hvd404_staged_allreduce.mlir", [("dp", 2), ("tp", 4)], 2),
    ("hvd401_pair_a.hlo", [("dp", 2), ("tp", 2)], None),
]


@pytest.mark.parametrize("name,axes,slices", COMMS_CASES,
                         ids=[f"{c[0][:-5]}-{c[2]}" for c in COMMS_CASES])
def test_comms_model_matches_jax(jax_settings, name, axes, slices):
    src = text(name)
    assert tsched.comms_model(src, axes, slices=slices) == \
        jsched.comms_model(src, axes, slices=slices)
    assert tshard.comms_by_axis(src, axes) == jshard.comms_by_axis(src, axes)


def test_peak_memory_estimates_match_jax():
    for name in ("hvd303_overbudget.hlo", "hvd303_donated_underbudget.hlo",
                 "hvd302_allgather_inserted.hlo"):
        j = jshard.estimate_compiled_text(text(name))
        t = tshard.estimate_compiled_text(text(name))
        assert t.as_dict() == j.as_dict()


# ------------------------------------------------------ port defaults

def test_default_lane_is_the_h100s(monkeypatch):
    """At the port's lane (64) the C = 64 block fixture is aligned; at
    the JAX package's (128) it fires as the JAX lint does, and the lane
    and waste formula are the layout pass's own."""
    from horovod_tpu_torch.analysis import hlo_rules
    from horovod_tpu_torch.ops import layout
    assert hlo_rules.LANE == layout.LANE == 64
    assert hlo_rules._pad_waste_pct is layout._pad_waste_pct
    assert hlo_rules._min_pad_waste_pct is layout._min_pad_waste_pct
    assert thlo.lint_files([path("hvd204_resnet_block.mlir")]) == []
    monkeypatch.setattr(hlo_rules, "LANE", layout.TPU_LANE)
    fired = keys(thlo.lint_files([path("hvd204_resnet_block.mlir")]))
    assert fired and fired == keys(jhlo.lint_files(
        [path("hvd204_resnet_block.mlir")]))


def test_default_budget_is_the_recording_cards_memory(monkeypatch):
    monkeypatch.delenv("HOROVOD_HLO_LINT_HBM_BUDGET", raising=False)
    prog = thlo.parse(text("hvd303_overbudget.hlo"), "over")
    assert tshard_rules.hbm_budget_bytes(prog) is None
    assert tshard.lint_program(prog) == []  # text: silent, as in JAX
    peak = tshard.peak_memory(prog).peak_bytes
    prog.device_memory = peak - 1  # a card smaller than the peak
    assert [f.rule_id for f in tshard.lint_program(prog)] == ["HVD303"]
    prog.device_memory = 80 * (1 << 30)  # an H100 80GB HBM3
    assert tshard.lint_program(prog) == []
    monkeypatch.setenv("HOROVOD_HLO_LINT_HBM_BUDGET", "56M")  # overrides
    assert [f.rule_id for f in tshard.lint_program(prog)] == ["HVD303"]


def test_default_link_table_is_the_h100s(monkeypatch):
    monkeypatch.delenv("HOROVOD_SCHED_LINK_GBPS", raising=False)
    assert tsched.link_gbps() == {"ici": 209.3, "dcn": 45.0}
    axes = [("hvd", 8)]
    src = text("hvd404_flat_allreduce.mlir")
    cm = tsched.comms_model(src, axes)
    ent = cm["per_axis"]["hvd"]
    assert ent["predicted_s"] == pytest.approx(
        ent["wire_bytes_per_step"] / 209.3e9)
    sliced = tsched.comms_model(src, axes, slices=2)["per_axis"]["hvd"]
    assert sliced["tier"] == "dcn"
    assert sliced["predicted_s"] == pytest.approx(
        sliced["wire_bytes_per_step"] / 45.0e9)
    monkeypatch.setenv("HOROVOD_SCHED_LINK_GBPS", "dcn=25")
    assert tsched.link_gbps() == {"ici": 209.3, "dcn": 25.0}


def test_every_family_has_an_empty_baseline():
    import json
    import horovod_tpu_torch.analysis as pkg
    here = os.path.dirname(pkg.__file__)
    for fam in ("hvdlint", "hvdhlo", "hvdshard", "hvdsched", "hvdnum"):
        with open(os.path.join(here, f"{fam}_baseline.json")) as fh:
            assert json.load(fh)["findings"] == [], fam
