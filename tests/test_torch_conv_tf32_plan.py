"""The float32 Hopper instance of kernels 2 and 3 (tf32 wgmma with TMA,
csrc/conv1x1_bwd_hopper_f32.cuh): which shapes take it, and its tile
plan, on the host (the kernels themselves run on the card only:
tests/test_torch_cuda_kernels.py, chip_smoke.py).

- `bwd_instance` sends f32 to "hopper_tf32" for Cin and C multiples of 4
  between 64 and 1024, every ResNet-50 site among them, and keeps the
  simple mma.sync code elsewhere; a function of shape and dtype alone.
- At every ResNet-50 site (batch 32) and the ragged shapes: both kernels
  fit in the H100's 232,448 bytes of shared memory with at least three
  ring stages; the dW split covers M in order in whole 32-row ring steps
  (splits x chunk >= M, no block past the last that holds a row); the
  workspace is at most 16 tiles; the partial tile fits in the ring.
- The wrapper's plan uses the header's constants.
"""

import math
import os
import re

import pytest
import torch

from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.ops import conv_bn_backward as cbb

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "horovod_tpu_torch", "csrc")


def _sites():
    return sorted({(m, cin, c) for _, _, m, cin, c in
                   resnet.fused_sites(50, 32, 224)})


RAGGED = [(6271, 256, 1024), (6271, 64, 200), (1000, 64, 64),
          (100, 1024, 1024), (25087, 512, 132)]


def test_the_resnet50_sites_are_ten_shapes():
    assert _sites() == sorted([
        (6272, 256, 1024), (6272, 1024, 256), (6272, 1024, 512),
        (25088, 128, 512), (25088, 512, 128), (25088, 512, 256),
        (100352, 64, 64), (100352, 64, 256), (100352, 256, 64),
        (100352, 256, 128)])


@pytest.mark.parametrize("m,cin,c", _sites() + RAGGED)
def test_f32_sites_take_the_tf32_hopper_instance(m, cin, c):
    assert cbb.bwd_instance(m, cin, c, torch.float32) == "hopper_tf32"
    assert cbb.bwd_instance(m, cin, c, torch.bfloat16) == (
        "hopper" if cin % 8 == 0 and c % 8 == 0 else "simple")


@pytest.mark.parametrize("m,cin,c", [(1001, 24, 50), (4096, 66, 64),
                                     (4096, 64, 1032), (4096, 2048, 64),
                                     (4096, 60, 64), (256, 32, 48)])
def test_other_f32_shapes_keep_the_simple_instance(m, cin, c):
    """Cin or C below 64, above 1024 or not a multiple of 4 (TMA's
    16-byte stride in f32)."""
    assert cbb.bwd_instance(m, cin, c, torch.float32) == "simple"


@pytest.mark.parametrize("m,cin,c", _sites() + RAGGED)
def test_tf32_shared_memory_holds_three_stages(m, cin, c):
    p = cbb.hopper_tf32_smem(m, cin, c)
    for k in ("dx", "dw"):
        assert cbb.TF32_MIN_STAGES <= p[f"{k}_stages"] \
            <= cbb.TF32_MAX_STAGES, (k, p)
        assert p[f"{k}_bytes"] <= cbb.SMEM_MAX, (k, p)
        # no deeper ring would fit (or the ring is at its maximum)
        assert p[f"{k}_stages"] == cbb.TF32_MAX_STAGES or \
            p[f"{k}_bytes"] + p[f"{k}_stage"] > cbb.SMEM_MAX
    # the dW partial tile reuses the ring at the end
    assert p["tile_bytes"] <= p["dw_stages"] * p["dw_stage"]


@pytest.mark.parametrize("m,cin,c", _sites() + RAGGED)
def test_tf32_dw_split_covers_m_in_ring_steps(m, cin, c):
    clusters, chunk = cbb.hopper_tf32_dw_plan(m, cin, c)
    cl = cbb.TF32_CLUSTER
    splits = clusters * cl
    assert chunk % cbb.TF32_STEP == 0 and chunk > 0
    assert splits * chunk >= m
    # the last cluster holds rows: no cluster is all empty blocks
    assert (splits - cl) * chunk < m
    _, ct, nt = cbb.hopper_tf32_tiles(m, cin, c)
    tiles = math.ceil(cin / ct) * math.ceil(c / nt)
    # one wave: a block an SM at most, every tile at least one cluster
    assert tiles * splits <= cbb.TF32_WAVE
    # and the wave is nearly full where M gives every block rows
    if m >= cbb.TF32_WAVE * cbb.TF32_STEP:
        assert tiles * splits > cbb.TF32_WAVE - tiles * cl


@pytest.mark.parametrize("m,cin,c,want", [
    (100352, 64, 64, (64, 64, 64)), (100352, 64, 256, (64, 64, 128)),
    (25088, 128, 512, (128, 128, 128)), (25088, 512, 128, (256, 256, 128)),
    (100352, 256, 64, (256, 256, 64)), (6272, 1024, 512, (256, 256, 128)),
    (6272, 1024, 256, (256, 256, 128)), (6272, 256, 1024, (128, 256, 128))])
def test_tf32_tiles(m, cin, c, want):
    """dx NB 64, 128 or 256 (128 where 256-wide jobs would fill fewer than
    half the SMs: M 6272 at Cin 256); dW tiles the smallest that hold
    Cin and C, up to 256 x 128."""
    assert cbb.hopper_tf32_tiles(m, cin, c) == want
    nb, ct, nt = want
    assert cin <= ct or ct == 256


def test_plan_constants_are_the_headers():
    def const(fn, name):
        with open(os.path.join(CSRC, fn)) as f:
            return int(re.search(rf"constexpr int {name} = (\d+);",
                                 f.read()).group(1))
    f32 = "conv1x1_bwd_hopper_f32.cuh"
    assert const(f32, "KB") == cbb.TF32_STEP
    assert const(f32, "MIN_STAGES") == cbb.TF32_MIN_STAGES
    assert const(f32, "MAX_STAGES") == cbb.TF32_MAX_STAGES
    assert const(f32, "TF32_CLUSTER") == cbb.TF32_CLUSTER
    assert const("conv1x1_bwd_hopper.cuh", "SMEM_MAX") == cbb.SMEM_MAX
    assert const("conv1x1_bwd_hopper.cuh", "CLUSTER") == cbb.HOPPER_CLUSTER


def test_f32_on_the_host_runs_the_plain_version():
    """A CPU tensor takes the plain version whatever instance the card
    would run."""
    m, cin, c = 256, 64, 64
    assert cbb.bwd_instance(m, cin, c, torch.float32) == "hopper_tf32"
    g = torch.Generator().manual_seed(0)
    x, dz = torch.randn(m, cin, generator=g), torch.randn(m, c, generator=g)
    w = torch.randn(cin, c, generator=g) * 0.1
    y = x @ w
    mean, inv = y.mean(0), torch.rsqrt(y.var(0, unbiased=False) + 1e-5)
    scale = torch.ones(c)
    db, dg = cbb._bn_sums(dz, y, mean, inv)
    dx, dw = cbb.conv1x1_bn_bwd_fused(dz, y, x, w, scale, mean, inv, db, dg)
    g3, a3, b3 = cbb.fold_rows(scale, inv, db, dg, None, None, m)
    rx, rw = cbb._bwd_plain(dz, y, x, w, g3, mean, inv, a3, b3)
    assert torch.equal(dx, rx) and torch.equal(dw, rw)
