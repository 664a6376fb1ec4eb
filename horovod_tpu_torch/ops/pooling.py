"""Max pooling over NHWC input (counterpart of horovod_tpu/ops/pooling.py
max_pool, as far as the models and its parity test need it).

The padding rules (`VALID`, `SAME`, explicit ((lo, hi), (lo, hi))) are
the JAX module's `_resolve_padding`: SAME pads
asymmetrically, the extra row or column at the high end. The input is
padded with −inf (the integer minimum for integer input), then
`F.max_pool2d` runs on the NCHW view. Its backward is torch's, which
gives each window's cotangent to the first maximum in window order
(row-major), as XLA's SelectAndScatter does with its GE-select: ties,
which every window of zeros after a ReLU holds, resolve alike, and
overlapping windows add their cotangents into a shared input.

Not ported: the JAX module's one-hot backward. It replaced
SelectAndScatter on the TPU, where it measured slower and shipped
unwired; on the GPU torch's indexed backward is the stock path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _resolve_padding(padding, h, w, wh, ww, sh, sw
                     ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """'VALID'/'SAME' or explicit ((lo,hi),(lo,hi)) for the two spatial
    dims."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0), (0, 0)
        if padding.upper() == "SAME":
            def same(size, win, stride):
                out = -(-size // stride)
                total = max((out - 1) * stride + win - size, 0)
                return total // 2, total - total // 2
            return same(h, wh, sh), same(w, ww, sw)
        raise ValueError(f"padding {padding!r}")
    (ph, pw) = padding
    return tuple(ph), tuple(pw)


def _lowest(dtype: torch.dtype) -> float:
    return float("-inf") if dtype.is_floating_point else \
        torch.iinfo(dtype).min


def max_pool(x: torch.Tensor, window: Sequence[int] = (3, 3),
             strides: Sequence[int] = (2, 2),
             padding="VALID") -> torch.Tensor:
    """NHWC max pool over the two spatial dims; returns NHWC."""
    wh, ww = window
    sh, sw = strides
    ph, pw = _resolve_padding(padding, x.shape[1], x.shape[2],
                              wh, ww, sh, sw)
    if any(ph) or any(pw):
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]),
                  value=_lowest(x.dtype))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), (wh, ww), (sh, sw))
    return y.permute(0, 2, 3, 1)
