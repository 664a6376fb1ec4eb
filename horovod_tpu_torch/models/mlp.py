"""The MNIST-scale MLP as an nn.Module (counterpart of
horovod_tpu/models/mlp.py): sizes 784-512-256-10 by default, He-normal
weights kept as (in, out) matrices, zero biases, ReLU between layers.
`apply(model, x)` and `loss_fn(model, batch)` take the JAX functions'
arguments with the model in place of the parameter list; the loss is
log-softmax in the logits' dtype, as the JAX model takes it."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from horovod_tpu_torch.models.resnet import Layer


class MLP(nn.Module):
    """Parameters in `dtype`, random from `seed`; state_dict names
    `layers.<i>.w`, `layers.<i>.b` (the JAX list's i-th {"w", "b"})."""

    def __init__(self, sizes: Sequence[int] = (784, 512, 256, 10),
                 dtype=torch.float32, device="cpu", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.layers = nn.ModuleList(
            Layer((cin, cout), (2.0 / cin) ** 0.5, cout, gen, dtype, device)
            for cin, cout in zip(sizes[:-1], sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = torch.matmul(x, layer.w) + layer.b
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def apply(model: MLP, x: torch.Tensor) -> torch.Tensor:
    return model(x)


def loss_fn(model: MLP, batch) -> torch.Tensor:
    x, y = batch
    logp = torch.log_softmax(model(x), dim=-1)
    return -logp.gather(1, y[:, None]).mean()
