"""VGG-16/19 as an nn.Module (counterpart of horovod_tpu/models/vgg.py).

The public functions take and return the JAX package's layout: images
NHWC, `apply(model, x)` → logits, `loss_fn(model, batch)` → the loss
(the model has no batch stats). Each stage's 3x3 SAME convs add their
bias, then ReLU; a 2x2/2 VALID max pool ends the stage
(ops/pooling.max_pool); then fc0–fc2, ReLU after the first two.

The convs run on channels_last NCHW views of NHWC activations (the
permutes are views, cuDNN keeps the layout), conv weights OIHW, FC
weights (in, out) matrices as the JAX tree holds them. fc0's rows are
in (h, w, c) order, because the JAX model flattens its NHWC feature
map: the port flattens the NHWC view, never the NCHW one, so carried
weights see the same input.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.resnet import Layer
from horovod_tpu_torch.ops.pooling import max_pool

# Stage plans: (convs per stage, channels); pooling after each stage.
STAGE_PLANS = {
    16: ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)),
    19: ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512)),
}


class VGG(nn.Module):
    """VGG-`depth`; parameters in `dtype`, random from `seed`, named as
    the JAX tree (`s<stage>c<conv>.w`, `fc<i>.w`, ...)."""

    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 dtype=torch.float32, image_size: int = 224, device="cpu",
                 seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.depth = depth
        plan = STAGE_PLANS[depth]
        cin = 3
        for s, (n, cout) in enumerate(plan):
            for b in range(n):
                name = f"s{s}c{b}"
                self.add_module(name, Layer((cout, cin, 3, 3),
                                            (2.0 / (9 * cin)) ** 0.5, cout,
                                            gen, dtype, device))
                cin = cout
        feat = (image_size // 2 ** len(plan)) ** 2 * cin
        dims = (feat, 4096, 4096, num_classes)
        for i in range(3):
            self.add_module(f"fc{i}", Layer((dims[i], dims[i + 1]),
                                            dims[i] ** -0.5, dims[i + 1],
                                            gen, dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, 3) NHWC -> logits (N, num_classes)."""
        h = x
        for s, (n, _cout) in enumerate(STAGE_PLANS[self.depth]):
            for b in range(n):
                p = getattr(self, f"s{s}c{b}")
                h = F.conv2d(h.permute(0, 3, 1, 2), p.w, p.b, padding=1)
                h = torch.relu(h).permute(0, 2, 3, 1)
            h = max_pool(h, (2, 2), (2, 2), "VALID")
        h = h.reshape(h.shape[0], -1)  # (h, w, c) order, as the JAX model
        for i in range(3):
            p = getattr(self, f"fc{i}")
            h = torch.matmul(h, p.w) + p.b
            if i < 2:
                h = torch.relu(h)
        return h


def apply(model: VGG, x: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W, 3) NHWC -> logits (N, num_classes)."""
    return model(x)


def loss_fn(model: VGG, batch) -> torch.Tensor:
    """Cross-entropy with log-softmax in f32."""
    x, y = batch
    logp = torch.log_softmax(model(x).float(), dim=-1)
    return -logp.gather(1, y[:, None]).mean()
