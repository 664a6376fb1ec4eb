"""Weights of the JAX package's models as the PyTorch models' state.

`from_jax(params, stats)` takes the trees that
horovod_tpu.models.resnet.init returns, with numpy (or array-like)
leaves, and gives a flat {state_dict name: numpy array} for
models/resnet.ResNet: 3x3 and 7x7 conv weights turn from HWIO to OIHW,
1x1 weights stay (Cin, Cout) matrices, BN scale/bias and the running
mean/var keep their shapes.

`transformer_from_jax(params)` takes the tree that
horovod_tpu.models.transformer.init returns (layer leaves stacked on a
leading L axis) and gives the state dict of
models/transformer.TransformerLM: each stacked leaf becomes one
`layers.<i>.<name>` entry per layer, every shape otherwise kept.

Nothing of JAX is imported: the caller hands over plain arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def _conv(w) -> np.ndarray:
    w = np.asarray(w)
    if w.shape[:2] == (1, 1):
        return np.ascontiguousarray(w.reshape(w.shape[2], w.shape[3]))
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def from_jax(params: Mapping[str, Any],
             stats: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's state dict (names → numpy arrays) for a JAX ResNet."""
    out: Dict[str, np.ndarray] = {}
    for top, p in params.items():
        if top == "fc":
            out["fc.w"] = np.asarray(p["w"])
            out["fc.b"] = np.asarray(p["b"])
            continue
        for key, v in p.items():
            if isinstance(v, Mapping):  # a BN's scale/bias
                out[f"{top}.{key}.scale"] = np.asarray(v["scale"])
                out[f"{top}.{key}.bias"] = np.asarray(v["bias"])
            else:
                out[f"{top}.{key}"] = _conv(v)
        st = stats[top]
        if top == "stem":
            out["stem.bn.mean"] = np.asarray(st["mean"])
            out["stem.bn.var"] = np.asarray(st["var"])
        else:
            for bn_name, s in st.items():
                out[f"{top}.{bn_name}.mean"] = np.asarray(s["mean"])
                out[f"{top}.{bn_name}.var"] = np.asarray(s["var"])
    return out


def load_jax(model, params, stats) -> None:
    """Copy a JAX ResNet's weights and running stats into `model` (cast
    to each tensor's dtype and device)."""
    import torch

    state = {k: torch.from_numpy(np.array(v)) for k, v in
             from_jax(params, stats).items()}
    model.load_state_dict(state, strict=True)


def transformer_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The TransformerLM state dict (names → numpy arrays) for a JAX
    transformer parameter tree."""
    out: Dict[str, np.ndarray] = {}
    for top, v in params.items():
        if top == "layers":
            for name, stacked in v.items():
                for i, leaf in enumerate(np.asarray(stacked)):
                    out[f"layers.{i}.{name}"] = np.ascontiguousarray(leaf)
        else:
            out[top] = np.asarray(v)
    return out


def load_jax_transformer(model, params) -> None:
    """Copy a JAX transformer's weights into `model` (cast to each
    parameter's dtype and device)."""
    import torch

    state = {k: torch.from_numpy(np.array(v)) for k, v in
             transformer_from_jax(params).items()}
    model.load_state_dict(state, strict=True)
