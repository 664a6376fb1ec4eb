"""Inception V3 as an nn.Module (counterpart of
horovod_tpu/models/inception.py): 299x299 input, the stem to 35x35x192,
3x InceptionA, ReductionA, 4x InceptionB, ReductionB, 2x InceptionC,
global average pool, fc 2048 -> classes; no auxiliary head.

The public functions take and return the JAX package's layout: images
NHWC, `apply` → (logits, new_stats), `loss_fn` → (loss, new_stats).
Each conv is followed by the JAX-formula BN (ops/sync_batch_norm
.batch_norm, averaged over `group` as the JAX model's
`axis_name="hvd"`) and ReLU. The plans below are the JAX model's, and
the parameter and stats trees keep its keypaths (`stem/c0/w`,
`a0/b5x5/1/bn/scale` is the state_dict name `a0.b5x5.1.bn.scale`).

Parity points with the JAX model:
  * branches concatenate on C in the plan's dict order (b1x1, the
    5x5/7x7/3x3 branch, the double branch, bpool), and a "split" tail
    feeds both arms the same input and concatenates them (1x3, then
    3x1): the next block's weights are laid out for that order;
  * the average pool is SAME 3x3/1 and divides by the in-bounds count
    (`count_include_pad=False`), the max pools 3x3/2 VALID
    (ops/pooling.max_pool);
  * SAME convs at stride 1 pad symmetrically (odd kernels), every
    stride-2 conv of the plan is VALID; a SAME conv whose pads come out
    uneven would be padded explicitly, as models/resnet.py does;
  * 1x1 weights are (Cin, Cout) matrices and the 1x1 convs products on
    the NHWC rows (every 1x1 of the plan is stride 1), the others OIHW
    on channels_last NCHW views.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.resnet import (BN, FC, Stats, _normal,
                                             _same_pads, conv1x1)
from horovod_tpu_torch.ops import sync_batch_norm as sbn
from horovod_tpu_torch.ops.pooling import max_pool

# Each conv is (kh, kw, cout, stride, padding); a block is
# {branch: [step, ...]} whose branches concatenate on C; "avgpool" and
# "maxpool" steps pool first; a ("split", arm, arm) step ends a branch
# with parallel arms whose outputs concatenate. (The JAX model's plans.)

def _stem_plan():
    return [("c0", 3, 3, 32, 2, "VALID"), ("c1", 3, 3, 32, 1, "VALID"),
            ("c2", 3, 3, 64, 1, "SAME"), ("maxpool", 0, 0, 0, 2, ""),
            ("c3", 1, 1, 80, 1, "VALID"), ("c4", 3, 3, 192, 1, "VALID"),
            ("maxpool", 0, 0, 0, 2, "")]


def _inception_a(pool_feat):
    return {
        "b1x1": [(1, 1, 64, 1, "SAME")],
        "b5x5": [(1, 1, 48, 1, "SAME"), (5, 5, 64, 1, "SAME")],
        "b3x3dbl": [(1, 1, 64, 1, "SAME"), (3, 3, 96, 1, "SAME"),
                    (3, 3, 96, 1, "SAME")],
        "bpool": ["avgpool", (1, 1, pool_feat, 1, "SAME")],
    }


def _reduction_a():
    return {
        "b3x3": [(3, 3, 384, 2, "VALID")],
        "b3x3dbl": [(1, 1, 64, 1, "SAME"), (3, 3, 96, 1, "SAME"),
                    (3, 3, 96, 2, "VALID")],
        "bpool": ["maxpool"],
    }


def _inception_b(c7):
    return {
        "b1x1": [(1, 1, 192, 1, "SAME")],
        "b7x7": [(1, 1, c7, 1, "SAME"), (1, 7, c7, 1, "SAME"),
                 (7, 1, 192, 1, "SAME")],
        "b7x7dbl": [(1, 1, c7, 1, "SAME"), (7, 1, c7, 1, "SAME"),
                    (1, 7, c7, 1, "SAME"), (7, 1, c7, 1, "SAME"),
                    (1, 7, 192, 1, "SAME")],
        "bpool": ["avgpool", (1, 1, 192, 1, "SAME")],
    }


def _reduction_b():
    return {
        "b3x3": [(1, 1, 192, 1, "SAME"), (3, 3, 320, 2, "VALID")],
        "b7x7x3": [(1, 1, 192, 1, "SAME"), (1, 7, 192, 1, "SAME"),
                   (7, 1, 192, 1, "SAME"), (3, 3, 192, 2, "VALID")],
        "bpool": ["maxpool"],
    }


def _inception_c():
    return {
        "b1x1": [(1, 1, 320, 1, "SAME")],
        "b3x3": [(1, 1, 384, 1, "SAME"),
                 ("split", (1, 3, 384, 1, "SAME"), (3, 1, 384, 1, "SAME"))],
        "b3x3dbl": [(1, 1, 448, 1, "SAME"), (3, 3, 384, 1, "SAME"),
                    ("split", (1, 3, 384, 1, "SAME"),
                     (3, 1, 384, 1, "SAME"))],
        "bpool": ["avgpool", (1, 1, 192, 1, "SAME")],
    }


_BLOCKS = (
    [("a0", _inception_a(32)), ("a1", _inception_a(64)),
     ("a2", _inception_a(64)), ("ra", _reduction_a()),
     ("b0", _inception_b(128)), ("b1", _inception_b(160)),
     ("b2", _inception_b(160)), ("b3", _inception_b(192)),
     ("rb", _reduction_b()), ("c0", _inception_c()),
     ("c1", _inception_c())])


def _convs(plan):
    """The (kh, kw, cout, stride, padding) convs of a branch in parameter
    order, each with whether it is an arm of the split tail."""
    for step in plan:
        if step in ("avgpool", "maxpool"):
            continue
        if step[0] == "split":
            for arm in step[1:]:
                yield arm, True
        else:
            yield step, False


class ConvBN(nn.Module):
    """A conv weight `w` (1x1: (Cin, Cout); else OIHW) and its BN."""

    def __init__(self, kh, kw, cin, cout, gen, dtype, device):
        super().__init__()
        std = (2.0 / (kh * kw * cin)) ** 0.5
        shape = (cin, cout) if (kh, kw) == (1, 1) else (cout, cin, kh, kw)
        self.w = nn.Parameter(_normal(gen, shape, std, dtype, device))
        self.bn = BN(cout, dtype, device)


def _conv(x, w, stride: int, padding: str):
    """x NHWC; w (Cin, Cout) for 1x1, else OIHW; XLA's SAME or VALID."""
    if w.dim() == 2:
        return conv1x1(x, w, stride)
    kh, kw = w.shape[-2:]
    if padding == "VALID":
        ph = pw = (0, 0)
    else:
        ph = _same_pads(x.shape[1], kh, stride)
        pw = _same_pads(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xc, w, stride=stride, padding=(ph[0], pw[0]))
    else:
        y = F.conv2d(F.pad(xc, (pw[0], pw[1], ph[0], ph[1])), w,
                     stride=stride)
    return y.permute(0, 2, 3, 1)


def _avg_pool(x):
    """SAME 3x3/1 average over the in-bounds values, NHWC."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=1, padding=1,
                     count_include_pad=False)
    return y.permute(0, 2, 3, 1)


class InceptionV3(nn.Module):
    """Parameters in `dtype`, running stats f32, random from `seed`."""

    def __init__(self, num_classes: int = 1000, dtype=torch.float32,
                 device="cpu", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.stem = nn.ModuleDict()
        cin = 3
        for name, kh, kw, cout, _s, _p in _stem_plan():
            if name == "maxpool":
                continue
            self.stem[name] = ConvBN(kh, kw, cin, cout, gen, dtype, device)
            cin = cout
        for bname, spec in _BLOCKS:
            block = nn.ModuleDict()
            c_out_total = 0
            for br, plan in spec.items():
                convs = nn.ModuleList()
                c = cin
                split_c = None
                for (kh, kw, cout, _s, _p), arm in _convs(plan):
                    # every arm reads the branch's pre-split channels
                    convs.append(ConvBN(kh, kw, c, cout, gen, dtype, device))
                    if arm:
                        split_c = (split_c or 0) + cout
                    else:
                        c = cout
                block[br] = convs
                c_out_total += split_c if split_c is not None else c
            self.add_module(bname, block)
            cin = c_out_total
        self.fc = FC(cin, num_classes, gen, dtype, device)

    def forward(self, x, train: bool = True,
                group=None) -> Tuple[torch.Tensor, Stats]:
        """x: (N, 299, 299, 3) NHWC. Returns (logits, new_batch_stats),
        the stats nested as the JAX package's tree."""

        def conv_bn_relu(h, m: ConvBN, stride, padding):
            h = _conv(h, m.w, stride, padding)
            h, (mean, var) = sbn.batch_norm(h, m.bn.scale, m.bn.bias,
                                            m.bn.mean, m.bn.var, train,
                                            group=group)
            return torch.relu(h), {"mean": mean, "var": var}

        new_stats: Stats = {"stem": {}}
        h = x
        for name, _kh, _kw, _cout, s, p in _stem_plan():
            if name == "maxpool":
                h = max_pool(h, (3, 3), (2, 2), "VALID")
                continue
            h, new_stats["stem"][name] = conv_bn_relu(h, self.stem[name],
                                                      s, p)
        for bname, spec in _BLOCKS:
            block = getattr(self, bname)
            outs = []
            ns: Dict = {}
            for br, plan in spec.items():
                y = h
                mods = iter(block[br])
                nst = []
                for step in plan:
                    if step == "avgpool":
                        y = _avg_pool(y)
                    elif step == "maxpool":
                        y = max_pool(y, (3, 3), (2, 2), "VALID")
                    elif step[0] == "split":
                        arms = []
                        for _kh, _kw, _c, s, p in step[1:]:
                            a, st = conv_bn_relu(y, next(mods), s, p)
                            arms.append(a)
                            nst.append(st)
                        y = torch.cat(arms, dim=-1)
                    else:
                        y, st = conv_bn_relu(y, next(mods), step[3], step[4])
                        nst.append(st)
                ns[br] = nst
                outs.append(y)
            h = torch.cat(outs, dim=-1)
            new_stats[bname] = ns
        h = h.mean(dim=(1, 2))
        logits = torch.matmul(h, self.fc.w) + self.fc.b
        return logits, new_stats

    @torch.no_grad()
    def set_stats(self, new_stats: Stats) -> None:
        """Install the new batch stats as the running stats."""
        for name, st in new_stats["stem"].items():
            self.stem[name].bn.mean.copy_(st["mean"])
            self.stem[name].bn.var.copy_(st["var"])
        for bname, _spec in _BLOCKS:
            block = getattr(self, bname)
            for br, sts in new_stats[bname].items():
                for m, st in zip(block[br], sts):
                    m.bn.mean.copy_(st["mean"])
                    m.bn.var.copy_(st["var"])


def apply(model: InceptionV3, x, train: bool = True,
          group=None) -> Tuple[torch.Tensor, Stats]:
    """x: (N, H, W, 3) NHWC. Returns (logits, new_batch_stats)."""
    return model(x, train=train, group=group)


def loss_fn(model: InceptionV3, batch, train: bool = True,
            group=None) -> Tuple[torch.Tensor, Stats]:
    """Cross-entropy in f32; returns (loss, new_stats)."""
    x, y = batch
    logits, new_stats = model(x, train=train, group=group)
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(1, y[:, None]).mean()
    return loss, new_stats
