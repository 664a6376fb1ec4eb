"""The four canonical --hlo-step programs: the port's recorded steps
(horovod_tpu_torch/analysis/hlo.py record_step_program, shard.py
record_rank_program) against the JAX package's lowered ones, under the
default configuration and under each regression twin:

* `lm` (the tied LM through the bucketed hook path): clean; with
  HOROVOD_FUSION_THRESHOLD=64MB and HOROVOD_BUCKET_CAP=0 HVD201;
* `resnet_block` (the C = 64 block on the port's block route): clean at
  each package's lane; at the JAX lane without the layout pass, HVD204;
* `lm_sharded`, `lm_runtime` (the tied LM at dp = 2 x tp = 2, each
  rank's program, recorded in a spawned gloo world of 4 through
  tests/torch_world_worker.py): clean under HVD2xx-4xx; with
  HOROVOD_SHARD_LINT_REPLICATED=1 HVD301 on every table >= 4 MB.

One difference is pinned, not baselined (ROADMAP section C, C14): the
JAX GSPMD twin of lm_sharded also fires HVD302 on the all-gather its
partitioner inserts, which the port, with no partitioner, does not
have. Under the numerics rules the port's programs equal the JAX ones
(fault C13, closed: the embedding lookup's index_put sorts on CUDA and
the target gather's scatter_add writes each address once, so neither is
an HVD504 hazard; tests/test_torch_atomics.py).
"""

import glob
import os
import pickle

import pytest

from horovod_tpu.analysis import hlo as jhlo
from horovod_tpu.analysis import numerics as jnum
from horovod_tpu.analysis import schedule as jsched
from horovod_tpu.analysis import shard as jshard
from horovod_tpu_torch.analysis import hlo as thlo
from horovod_tpu_torch.analysis import numerics as tnum
from horovod_tpu_torch.analysis import schedule as tsched
from horovod_tpu_torch.analysis import shard as tshard

from torch_world_worker import start_world
import torch_hvdprog_worker as worker

def rules(findings):
    return {f.rule_id for f in findings}


def port_step(kind):
    return thlo.record_step_program(kind, "cpu")


@pytest.mark.parametrize("twin", [False, True], ids=["default", "twin"])
def test_lm_step(monkeypatch, twin):
    if twin:
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(64 << 20))
        monkeypatch.setenv("HOROVOD_BUCKET_CAP", "0")
    want = rules(jhlo.lint_text(jhlo.lower_step_text("lm")))
    prog = port_step("lm")
    assert want == ({"HVD201"} if twin else set())
    assert rules(thlo.lint_program(prog)) == want
    payloads = [int(op.attrs.split("payload_bytes=")[1].split(",")[0])
                for op in prog.ops if op.opcode == "all_reduce"]
    # ~20 MB of f32 gradients: buckets of <= 4 MiB, or one giant one
    assert sum(payloads) == (8192 * 256 + 6 * 2 * 256 * 1024) * 4
    assert (len(payloads) == 1) == twin
    if not twin:  # the numerics rules: as the JAX program's (C13)
        assert rules(jnum.lint_text(jhlo.lower_step_text("lm"))) == set()
        assert rules(tnum.lint_programs([prog])) == set()


@pytest.mark.parametrize("twin", [False, True], ids=["default", "twin"])
def test_resnet_block_step(monkeypatch, twin):
    if twin:  # the JAX program without its layout pass; the port at 128
        monkeypatch.setenv("HOROVOD_LAYOUT_PAD", "0")
    want = rules(jhlo.lint_text(jhlo.lower_step_text("resnet_block")))
    assert want == ({"HVD204"} if twin else set())
    if twin:
        from horovod_tpu_torch.analysis import hlo_rules
        monkeypatch.setattr(hlo_rules, "LANE", 128)
    prog = port_step("resnet_block")
    assert rules(thlo.lint_program(prog)) == want
    regions = {op.attrs.split('region="')[1].split('"')[0]
               for op in prog.ops if 'region="' in op.attrs}
    assert regions == {"conv1x1_fwd_fused", "conv1x1_bn_act_bwd_fused"}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    start_world(worker.sharded_programs,
                [(r, 4, str(out / "store"), str(out)) for r in range(4)],
                out, deadline=150).join()
    progs = {}
    for p in sorted(glob.glob(str(out / "*.pkl"))):
        name = os.path.basename(p).rsplit(".", 2)[0]
        with open(p, "rb") as fh:
            progs.setdefault(name, []).append(pickle.load(fh))
    return progs


def _jax_sharded_rules(kind, replicated):
    """The JAX CLI's families over both forms of its program."""
    lower = (jshard.lower_sharded_step_texts if kind == "lm_sharded"
             else jshard.lower_runtime_step_texts)
    texts = lower(replicated)
    return (rules(jhlo.lint_text(texts["stablehlo"]))
            | rules(jshard.lint_text(texts["stablehlo"]))
            | rules(jshard.lint_text(texts["hlo"]))
            | rules(jsched.lint_text(texts["hlo"]))
            | rules(jnum.lint_text(texts["hlo"])))


@pytest.mark.parametrize("kind", ["lm_sharded", "lm_runtime"])
@pytest.mark.parametrize("replicated", [False, True],
                         ids=["declared", "replicated"])
def test_sharded_steps(sharded, kind, replicated):
    progs = sharded[f"{kind}.{int(replicated)}"]
    assert [p.rank for p in progs] == [0, 1, 2, 3]
    assert all(p.num_partitions == 4 for p in progs)
    port = set()
    for p in progs:
        port |= rules(thlo.lint_program(p)) | rules(tshard.lint_program(p))
    port |= rules(tsched.lint_programs(progs))
    port |= rules(tnum.lint_programs(progs))
    want = _jax_sharded_rules(kind, replicated)
    assert want == ({"HVD301"} | ({"HVD302"} if kind == "lm_sharded"
                                  else set()) if replicated else set())
    assert port == want - {"HVD302"}
    if replicated:  # every table >= 4 MB, on every rank
        hits = [f for p in progs for f in tshard.lint_program(p)]
        assert len(hits) == 4 * 5
    else:  # nothing the JAX program shards is kept whole here
        emb = progs[0].entry_params[0]
        assert emb.type.dims == (4096, 512)
        assert emb.sharding.startswith("{devices=[2,1,2]")
