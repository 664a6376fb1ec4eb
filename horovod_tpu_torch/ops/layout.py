"""The layout pass: channel padding to the kernels' lane width
(counterpart of horovod_tpu/ops/layout.py).

A model declares its conv stack once (`models/resnet.conv_stack`): every
channel-carrying dim of every parameter and running-stat tensor, tagged
with the named channel EDGE it rides. Edges capture the sharing the pass
must respect: a conv's output channels, its BatchNorm vectors and the
residual trunk a stage adds over pad together, or shapes stop lining up.
`plan()` decides per edge:

* pad an edge up to the next lane multiple when its waste is at or above
  the floor (HOROVOD_LAYOUT_MIN_WASTE_PCT, default the lint floor
  HOROVOD_HLO_LINT_PAD_WASTE_MIN_PCT, 10) and the growth stays within
  HOROVOD_LAYOUT_MAX_GROWTH (default 2.0);
* otherwise leave it as declared. HOROVOD_LAYOUT_PAD=0 turns the pass
  off.

**The lane on the H100 is 64** (`LANE`): the smallest channel width at
which the port's conv kernels take their Hopper instance and a full
wgmma tile. Kernel 1 runs its Hopper instance for bf16 with Cin and C
multiples of 8 in [64, 1024] (`ops/conv_block.py fwd_instance`), with a
wgmma N of at least 64 (`fwd_tile`); kernels 2 and 3 follow the same
rule (`ops/conv_bn_backward.py bwd_instance`, whose dW tiles are 64
wide at the smallest, `hopper_tiles`). So at lane 64 no ResNet-50 edge
pads: 64, 128 ... 2048 are multiples of 64, and the 3-channel image edge
would grow 21x, past the cap. On the card the pass changes nothing on
the main path at the default lane, and that is its correct result.
`plan(..., lane=128)` takes the JAX package's lane (the TPU's 128-wide
vector lanes) and reproduces its decisions exactly: the stem and the
stage-0 block edges pad 64→128.

Zero padding is exact for conv + BN + ReLU stacks, forward and backward:
padded weight columns give zero activations; BN of an all-zero channel
has mean 0 and var 0 (rsqrt(eps) is finite), and zero scale and bias
keep it zero through ReLU and the residual adds; padded weight rows
multiply zero activations; gradients into padded channels are exactly
zero, so SGD, momentum and Adam leave the padding at zero, and the
running stats of a padded channel stay 0.

The port's trees are state dicts (name → tensor): a site's `path` is a
state-dict name (`s0b0.conv1`). `pad` and `strip` return copies and
leave undeclared tensors shared. `core/autotune.OnlineLayoutTuner`
scores the padded layout against the declared one by measured step time.

This module also keeps the port's one copy of the lint's waste arithmetic
(`_pad_waste_pct`, `_min_pad_waste_pct`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

LAYOUT_PAD_ENV = "HOROVOD_LAYOUT_PAD"
LAYOUT_MIN_WASTE_ENV = "HOROVOD_LAYOUT_MIN_WASTE_PCT"
LAYOUT_MAX_GROWTH_ENV = "HOROVOD_LAYOUT_MAX_GROWTH"
PAD_WASTE_MIN_ENV = "HOROVOD_HLO_LINT_PAD_WASTE_MIN_PCT"

#: The H100 lane: the smallest channel width of a Hopper conv instance.
LANE = 64
#: The JAX package's lane (the TPU's vector lanes), for parity.
TPU_LANE = 128

#: The layout modes the tuner arbitrates between.
AS_DECLARED = "as_declared"
NHWC_PADDED = "nhwc_padded"


def _min_pad_waste_pct() -> float:
    """The lint's padding-waste floor (HOROVOD_HLO_LINT_PAD_WASTE_MIN_PCT,
    default 10)."""
    v = os.environ.get(PAD_WASTE_MIN_ENV, "").strip()
    try:
        return float(v) if v else 10.0
    except ValueError:
        return 10.0


def _pad_waste_pct(dim: int, width: int) -> float:
    """The share of a `width`-padded dim that is padding, in per cent."""
    padded = -(-dim // width) * width
    return (1.0 - dim / padded) * 100.0


def layout_pad_enabled() -> bool:
    """HOROVOD_LAYOUT_PAD=0 turns plan() into an as-declared no-op."""
    return os.environ.get(LAYOUT_PAD_ENV, "").strip() not in (
        "0", "false", "False")


def _min_waste_pct() -> float:
    """Waste floor below which an unaligned edge is left alone; defaults
    to the lint's own floor."""
    v = os.environ.get(LAYOUT_MIN_WASTE_ENV, "").strip()
    try:
        return float(v) if v else _min_pad_waste_pct()
    except ValueError:
        return _min_pad_waste_pct()


def _max_growth() -> float:
    """Cap on padded/original size: 2.0 admits 64→128 but rejects
    padding the 3-channel image input."""
    v = os.environ.get(LAYOUT_MAX_GROWTH_ENV, "").strip()
    try:
        return float(v) if v else 2.0
    except ValueError:
        return 2.0


@dataclasses.dataclass(frozen=True)
class Site:
    """One declared tensor: `path` (its state-dict name) and `dims`
    mapping each channel-carrying dim index to its named edge."""

    path: str
    dims: Mapping[int, str]


@dataclasses.dataclass(frozen=True)
class Edge:
    """One named channel stream's layout decision."""

    name: str
    size: int
    padded: int
    waste_pct: float  # padding waste of the UNPADDED size at the lane

    @property
    def is_padded(self) -> bool:
        return self.padded != self.size


class LayoutError(ValueError):
    pass


class LayoutPlan:
    """The per-edge padding decisions for one declared conv stack, and
    the pad/strip rewrites they imply."""

    def __init__(self, edges: Dict[str, Edge], sites: List[Site],
                 lane: int = LANE):
        self.edges = edges
        self.sites = sites
        self.lane = lane

    @property
    def mode(self) -> str:
        return NHWC_PADDED if any(e.is_padded for e in
                                  self.edges.values()) else AS_DECLARED

    def padded_edges(self) -> Dict[str, Tuple[int, int]]:
        return {e.name: (e.size, e.padded)
                for e in self.edges.values() if e.is_padded}

    def _site_pads(self, tree: Mapping[str, Any], site: Site,
                   reverse: bool):
        t = tree.get(site.path)
        if t is None:
            return None, None  # the site lives in another tree
        pads = []
        changed = False
        for d in range(t.ndim):
            edge = site.dims.get(d)
            e = self.edges.get(edge) if edge else None
            if e is None or not e.is_padded:
                pads.append(0)
                continue
            want, have = (e.size, e.padded) if reverse else (e.padded,
                                                             e.size)
            if t.shape[d] == want:
                pads.append(0)  # already in the target layout
                continue
            if t.shape[d] != have:
                raise LayoutError(
                    f"layout: {site.path} dim {d} is {t.shape[d]}, "
                    f"expected {have} (edge {edge!r} "
                    f"{e.size}->{e.padded})")
            pads.append(want - have)
            changed = True
        return t, (pads if changed else None)

    def pad(self, tree: Mapping[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
        """Zero-pad every declared tensor of `tree` to its padded-lane
        shape (a copy; undeclared tensors are shared). Sites absent from
        `tree` are skipped: one stack declares parameters, stats and
        their momentum, and each call rewrites the tree it was given."""
        out = dict(tree)
        for site in self.sites:
            t, pads = self._site_pads(out, site, reverse=False)
            if pads is not None:
                # F.pad lists (lo, hi) pairs from the last dim backwards
                spec = [v for p in reversed(pads) for v in (0, p)]
                out[site.path] = F.pad(t.detach(), spec)
        return out

    def strip(self, tree: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """Inverse of pad(): slice every declared tensor back to its
        as-declared shape (a copy), for checkpoints and exports."""
        out = dict(tree)
        for site in self.sites:
            t, pads = self._site_pads(out, site, reverse=True)
            if pads is not None:
                # pads are negative here: cut each dim down to as-declared
                sl = tuple(slice(0, t.shape[d] + p)
                           for d, p in enumerate(pads))
                out[site.path] = t.detach()[sl].clone()
        return out

    def padding_max(self, tree: Mapping[str, torch.Tensor]) -> float:
        """The largest |value| in the padded lanes of `tree`'s declared
        tensors, which must be in the padded layout: 0.0 while the
        padding is exact."""
        worst = 0.0
        for site in self.sites:
            t = tree.get(site.path)
            if t is None:
                continue
            for d, edge in site.dims.items():
                e = self.edges.get(edge)
                if e is None or not e.is_padded:
                    continue
                if t.shape[d] != e.padded:
                    raise LayoutError(
                        f"layout: {site.path} dim {d} is {t.shape[d]}, "
                        f"not the padded {e.padded}")
                lanes = t.detach().narrow(d, e.size, e.padded - e.size)
                worst = max(worst, float(lanes.abs().max()))
        return worst

    def summary(self) -> Dict[str, Any]:
        """The mode, the lane used, which edges padded, and the largest
        waste the padding removed."""
        padded = self.padded_edges()
        worst = max((e.waste_pct for e in self.edges.values()
                     if e.is_padded), default=0.0)
        return {
            "mode": self.mode,
            "lane": self.lane,
            "edges": len(self.edges),
            "padded_edges": {k: list(v) for k, v in sorted(
                padded.items())},
            "max_waste_removed_pct": round(worst, 1),
        }


def plan(tree: Mapping[str, Any], stack: List[Site],
         min_waste_pct: Optional[float] = None,
         max_growth: Optional[float] = None,
         lane: int = LANE) -> LayoutPlan:
    """Decide the layout of one declared conv stack against the
    as-declared `tree` (a state dict; only shapes are read, so meta
    tensors do). Sites absent from `tree` are skipped here and pad along
    by edge at pad() time.

    HOROVOD_LAYOUT_PAD=0 (or a floor or growth cap that rejects every
    edge) gives an AS_DECLARED plan whose pad()/strip() are identity.
    """
    floor = _min_waste_pct() if min_waste_pct is None else min_waste_pct
    growth = _max_growth() if max_growth is None else max_growth
    enabled = layout_pad_enabled()
    edges: Dict[str, Edge] = {}
    for site in stack:
        t = tree.get(site.path)
        if t is None:
            continue
        for d, edge in site.dims.items():
            if d >= t.ndim:
                raise LayoutError(
                    f"layout: {site.path} has no dim {d} "
                    f"(shape {tuple(t.shape)})")
            size = int(t.shape[d])
            prev = edges.get(edge)
            if prev is not None:
                if prev.size != size:
                    raise LayoutError(
                        f"layout: edge {edge!r} declared at two sizes "
                        f"({prev.size} vs {size} at {site.path})")
                continue
            padded = size
            if enabled and size % lane:
                up = -(-size // lane) * lane
                if _pad_waste_pct(size, lane) >= floor \
                        and up <= growth * size:
                    padded = up
            edges[edge] = Edge(edge, size, padded,
                               _pad_waste_pct(size, lane)
                               if size % lane else 0.0)
    return LayoutPlan(edges, list(stack), lane)
