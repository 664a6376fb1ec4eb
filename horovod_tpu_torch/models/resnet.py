"""ResNet v1.5 (50/101/152) as an nn.Module (counterpart of
horovod_tpu/models/resnet.py).

The public functions take and return the JAX package's layout: images
NHWC, `apply` → (logits, new_stats), `loss_fn` → (loss, new_stats).
Activations stay NHWC-contiguous inside, so a 1x1 site's (N, H, W, C) →
(M, C) view is free; the 3x3 and 7x7 convs see them as channels_last
NCHW tensors.

Parity points with the JAX model:
  * SAME padding is asymmetric for stride 2 (3x3/2 pads (0, 1), 7x7/2
    pads (2, 3) on even inputs; the stem maxpool pads with −inf), so the
    pads are explicit `F.pad`s, never conv2d's symmetric `padding`;
  * BN is the JAX formula (ops/sync_batch_norm.batch_norm), not torch's;
  * 1x1 weights are kept as (Cin, Cout) matrices, as the kernels take
    them; 3x3 and 7x7 weights are OIHW;
  * the fused-site routing (`_fused_site_profitable`, both knobs) is the
    JAX package's, so the same sites run the same kernels.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.ops import sync_batch_norm as sbn
from horovod_tpu_torch.ops.conv_block import (conv1x1_bn_act_nhwc,
                                              conv_block_enabled)
from horovod_tpu_torch.ops.conv_bn_backward import conv1x1_bn_nhwc

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen) * std).to(dtype=dtype,
                                                        device=device)


class BN(nn.Module):
    """BatchNorm parameters (model dtype) and running stats (f32)."""

    def __init__(self, c: int, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=dtype, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))


class Stem(nn.Module):
    def __init__(self, gen, dtype, device):
        super().__init__()
        self.conv = nn.Parameter(_normal(gen, (64, 3, 7, 7),
                                         (2.0 / 147) ** 0.5, dtype, device))
        self.bn = BN(64, dtype, device)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, proj: bool, gen,
                 dtype, device):
        super().__init__()
        cout = width * 4
        self.stride = stride
        self.conv1 = nn.Parameter(_normal(gen, (cin, width),
                                          (2.0 / cin) ** 0.5, dtype, device))
        self.bn1 = BN(width, dtype, device)
        self.conv2 = nn.Parameter(_normal(gen, (width, width, 3, 3),
                                          (2.0 / (9 * width)) ** 0.5, dtype,
                                          device))
        self.bn2 = BN(width, dtype, device)
        self.conv3 = nn.Parameter(_normal(gen, (width, cout),
                                          (2.0 / width) ** 0.5, dtype,
                                          device))
        self.bn3 = BN(cout, dtype, device)
        self.has_proj = proj
        if self.has_proj:
            self.proj = nn.Parameter(_normal(gen, (cin, cout),
                                             (2.0 / cin) ** 0.5, dtype,
                                             device))
            self.bnp = BN(cout, dtype, device)


class FC(nn.Module):
    def __init__(self, cin, num_classes, gen, dtype, device):
        super().__init__()
        self.w = nn.Parameter(_normal(gen, (cin, num_classes), cin ** -0.5,
                                      dtype, device))
        self.b = nn.Parameter(torch.zeros(num_classes, dtype=dtype,
                                          device=device))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) for one spatial dim."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    ph = _same_pads(x.shape[1], k, s)
    pw = _same_pads(x.shape[2], k, s)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=value)


def conv_nhwc(x, w, stride: int = 1):
    """k x k conv, SAME padding: x NHWC, w OIHW → NHWC."""
    xp = _pad_same(x, w.shape[-1], stride)
    out = F.conv2d(xp.permute(0, 3, 1, 2), w, stride=stride)
    return out.permute(0, 2, 3, 1).contiguous()


def conv1x1(x, w, stride: int = 1):
    """1x1 conv as a product over rows: x NHWC, w (Cin, Cout)."""
    if stride != 1:
        x = x[:, ::stride, ::stride, :]
    n, h, wd, cin = x.shape
    return torch.matmul(x.reshape(n * h * wd, cin), w).reshape(n, h, wd, -1)


def max_pool_3x3_s2(x):
    xp = _pad_same(x, 3, 2, value=float("-inf"))
    out = F.max_pool2d(xp.permute(0, 3, 1, 2), 3, 2)
    return out.permute(0, 2, 3, 1).contiguous()


def _fuse_conv_bn() -> bool:
    """HOROVOD_FUSE_CONV_BN=1: 1x1-conv+BN sites run the fused backward
    (kernel 3)."""
    return os.environ.get("HOROVOD_FUSE_CONV_BN") in ("1", "true", "True")


def _fused_site_profitable(w) -> bool:
    """The JAX package's routing: cin, cout <= 1024. The threshold is a
    TPU VMEM rule kept for parity; it is not yet re-decided for the
    H100."""
    cin, cout = w.shape[-2], w.shape[-1]
    return cin <= 1024 and cout <= 1024


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------

Stats = Dict[str, Dict]


class ResNet(nn.Module):
    """ResNet v1.5. Parameters in `dtype`, random from `seed`."""

    def __init__(self, depth: int = 50, num_classes: int = 1000,
                 dtype=torch.float32, device="cpu", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.stem = Stem(gen, dtype, device)
        self.block_names = []
        cin = 64
        for s, n in enumerate(STAGE_BLOCKS[depth]):
            width = 64 * (2 ** s)
            for b in range(n):
                name = f"s{s}b{b}"
                stride = 2 if (b == 0 and s > 0) else 1
                self.add_module(name, Bottleneck(cin, width, stride, b == 0,
                                                 gen, dtype, device))
                self.block_names.append(name)
                cin = width * 4
        self.fc = FC(cin, num_classes, gen, dtype, device)

    def forward(self, x, train: bool = True,
                group=None) -> Tuple[torch.Tensor, Stats]:
        """x: (N, H, W, 3) NHWC. Returns (logits, new_batch_stats), the
        stats nested as the JAX package's tree."""
        block = train and conv_block_enabled()
        fuse = block or (train and _fuse_conv_bn())

        def bn(h, m: BN):
            out, (mean, var) = sbn.batch_norm(h, m.scale, m.bias, m.mean,
                                              m.var, train, group=group)
            return out, {"mean": mean, "var": var}

        def site(h, w, m: BN, relu: bool):
            if block:
                z, (mean, var) = conv1x1_bn_act_nhwc(h, w, m.scale, m.bias,
                                                     1e-5, group, relu)
            else:
                z, (mean, var) = conv1x1_bn_nhwc(h, w, m.scale, m.bias, 1e-5,
                                                 group)
                if relu:
                    z = torch.relu(z)
            return z, {"mean": sbn.update_running(m.mean, mean),
                       "var": sbn.update_running(m.var, var)}

        new_stats: Stats = {}
        h = conv_nhwc(x, self.stem.conv, 2)
        h, new_stats["stem"] = bn(h, self.stem.bn)
        h = max_pool_3x3_s2(torch.relu(h))
        for name in self.block_names:
            blk = getattr(self, name)
            ns = {}
            if fuse and _fused_site_profitable(blk.conv1):
                y, ns["bn1"] = site(h, blk.conv1, blk.bn1, relu=True)
            else:
                y, ns["bn1"] = bn(conv1x1(h, blk.conv1), blk.bn1)
                y = torch.relu(y)
            y, ns["bn2"] = bn(conv_nhwc(y, blk.conv2, blk.stride), blk.bn2)
            y = torch.relu(y)
            if fuse and _fused_site_profitable(blk.conv3):
                y, ns["bn3"] = site(y, blk.conv3, blk.bn3, relu=False)
            else:
                y, ns["bn3"] = bn(conv1x1(y, blk.conv3), blk.bn3)
            if blk.has_proj:
                if fuse and blk.stride == 1 and \
                        _fused_site_profitable(blk.proj):
                    sc, ns["bnp"] = site(h, blk.proj, blk.bnp, relu=False)
                else:
                    sc, ns["bnp"] = bn(conv1x1(h, blk.proj, blk.stride),
                                       blk.bnp)
            else:
                sc = h
            h = torch.relu(y + sc)
            new_stats[name] = ns
        h = h.mean(dim=(1, 2))
        logits = torch.matmul(h, self.fc.w) + self.fc.b
        return logits, new_stats

    @torch.no_grad()
    def set_stats(self, new_stats: Stats) -> None:
        """Install the new batch stats as the running stats."""
        self.stem.bn.mean.copy_(new_stats["stem"]["mean"])
        self.stem.bn.var.copy_(new_stats["stem"]["var"])
        for name in self.block_names:
            blk = getattr(self, name)
            for bn_name, st in new_stats[name].items():
                getattr(blk, bn_name).mean.copy_(st["mean"])
                getattr(blk, bn_name).var.copy_(st["var"])


def apply(model: ResNet, x, train: bool = True,
          group=None) -> Tuple[torch.Tensor, Stats]:
    """x: (N, H, W, 3) NHWC. Returns (logits, new_batch_stats)."""
    return model(x, train=train, group=group)


def loss_fn(model: ResNet, batch, train: bool = True,
            group=None) -> Tuple[torch.Tensor, Stats]:
    """Cross-entropy in f32; returns (loss, new_stats)."""
    x, y = batch
    logits, new_stats = model(x, train=train, group=group)
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(1, y[:, None]).mean()
    return loss, new_stats


def fused_sites(depth: int, batch: int, image_size: int):
    """The 1x1 sites that `apply` routes through the fused kernels, as
    (block, site, M, Cin, C) rows for a batch of `image_size`² images.
    The same rule as `apply`: cin, cout <= 1024; projections only at
    stride 1."""
    res = -(-(-(-image_size // 2)) // 2)  # stem /2, maxpool /2
    sites = []
    cin = 64
    for s, n in enumerate(STAGE_BLOCKS[depth]):
        width = 64 * (2 ** s)
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            out_res = -(-res // stride)
            m_in, m_out = batch * res * res, batch * out_res * out_res
            name = f"s{s}b{b}"
            if cin <= 1024 and width <= 1024:
                sites.append((name, "conv1", m_in, cin, width))
            if width <= 1024 and width * 4 <= 1024:
                sites.append((name, "conv3", m_out, width, width * 4))
            if b == 0 and stride == 1 and cin <= 1024 and width * 4 <= 1024:
                sites.append((name, "proj", m_in, cin, width * 4))
            cin, res = width * 4, out_res
    return sites
