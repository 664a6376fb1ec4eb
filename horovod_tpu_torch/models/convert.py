"""Weights of the JAX package's models as the PyTorch models' state.

`from_jax(params, stats)` takes the trees that
horovod_tpu.models.resnet.init returns, with numpy (or array-like)
leaves, and gives a flat {state_dict name: numpy array} for
models/resnet.ResNet: 3x3 and 7x7 conv weights turn from HWIO to OIHW,
1x1 weights stay (Cin, Cout) matrices, BN scale/bias and the running
mean/var keep their shapes. Any widths convert: a tree that
horovod_tpu.ops.layout's `plan(...).pad` returned gives the padded
state, and `load_jax` resizes the model to it.

`vgg_from_jax(params)`, `inception_from_jax(params, stats)` and
`mlp_from_jax(params)` do the same for horovod_tpu.models.vgg,
.inception and .mlp: conv weights HWIO → OIHW (Inception's 1x1 convs
stay (Cin, Cout) matrices, as the port keeps them), FC weights and
biases as they are, Inception's BN parameters and running stats under
the JAX keypaths (`a0/b5x5/1/bn/scale` → `a0.b5x5.1.bn.scale`, its
stats → `a0.b5x5.1.bn.mean`, `.var`).

`transformer_from_jax(params)` takes the tree that
horovod_tpu.models.transformer.init returns (layer leaves stacked on a
leading L axis) and gives the state dict of
models/transformer.TransformerLM: each stacked leaf becomes one
`layers.<i>.<name>` entry per layer, every shape otherwise kept (the
MoE's router, we1 and we2 included). `transformer_shard_from_jax(params,
cfg, mesh, rank)` gives one rank's shard of it on a mesh: the layers of
its pipeline stage, each leaf cut by its partition spec, the state dict
of that rank's TransformerLM.

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
    to each tensor's dtype and device). A tree of other widths than the
    model's (one padded by the layout pass) replaces the model's tensors
    with tensors of the tree's shapes."""
    import torch

    own = model.state_dict()
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             from_jax(params, stats).items()}
    if set(state) != set(own) or all(own[k].shape == v.shape
                                     for k, v in state.items()):
        model.load_state_dict(state, strict=True)
        return
    for k, v in state.items():
        path, _, leaf = k.rpartition(".")
        mod = model.get_submodule(path)
        old = getattr(mod, leaf)
        t = v.to(old)
        setattr(mod, leaf, torch.nn.Parameter(t, old.requires_grad)
                if isinstance(old, torch.nn.Parameter) else t)


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


def transformer_shard_from_jax(params: Mapping[str, Any], cfg, mesh=None,
                               rank=None) -> Dict[str, np.ndarray]:
    """Rank `rank`'s (default this rank's) TransformerLM state on `mesh`
    (default the mesh in force) for a JAX transformer's global tree at
    config `cfg` (models/transformer.shard_state)."""
    from horovod_tpu_torch.models import transformer
    return transformer.shard_state(transformer_from_jax(params), cfg, mesh,
                                   rank)


def load_jax_transformer(model, params) -> None:
    """Copy a JAX transformer's weights into `model` (cast to each
    parameter's dtype and device)."""
    import torch

    state = {k: torch.from_numpy(np.array(v)) for k, v in
             transformer_shard_from_jax(params, model.cfg,
                                        model.mesh).items()}
    model.load_state_dict(state, strict=True)


def _load(model, state: Dict[str, np.ndarray]) -> None:
    """Copy numpy arrays into `model` (cast to each tensor's dtype and
    device), every name matched."""
    import torch

    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)


def vgg_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's VGG state dict for a JAX VGG parameter tree."""
    out: Dict[str, np.ndarray] = {}
    for top, p in params.items():
        w = np.asarray(p["w"])
        out[f"{top}.w"] = np.ascontiguousarray(w.transpose(3, 2, 0, 1)) \
            if w.ndim == 4 else w
        out[f"{top}.b"] = np.asarray(p["b"])
    return out


def load_jax_vgg(model, params) -> None:
    """Copy a JAX VGG's weights into `model`."""
    _load(model, vgg_from_jax(params))


def inception_from_jax(params: Mapping[str, Any],
                       stats: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's Inception V3 state dict (parameters and running stats)
    for the JAX trees `inception.init` returns."""
    out: Dict[str, np.ndarray] = {}

    def conv_bn(prefix, p, st):
        out[f"{prefix}.w"] = _conv(p["w"])
        out[f"{prefix}.bn.scale"] = np.asarray(p["bn"]["scale"])
        out[f"{prefix}.bn.bias"] = np.asarray(p["bn"]["bias"])
        out[f"{prefix}.bn.mean"] = np.asarray(st["mean"])
        out[f"{prefix}.bn.var"] = np.asarray(st["var"])

    for top, p in params.items():
        if top == "fc":
            out["fc.w"] = np.asarray(p["w"])
            out["fc.b"] = np.asarray(p["b"])
        elif top == "stem":
            for name, cp in p.items():
                conv_bn(f"stem.{name}", cp, stats["stem"][name])
        else:
            for br, convs in p.items():
                for i, cp in enumerate(convs):
                    conv_bn(f"{top}.{br}.{i}", cp, stats[top][br][i])
    return out


def load_jax_inception(model, params, stats) -> None:
    """Copy a JAX Inception V3's weights and running stats into
    `model`."""
    _load(model, inception_from_jax(params, stats))


def mlp_from_jax(params) -> Dict[str, np.ndarray]:
    """The port's MLP state dict for the JAX MLP's list of layers."""
    out: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(params):
        out[f"layers.{i}.w"] = np.asarray(layer["w"])
        out[f"layers.{i}.b"] = np.asarray(layer["b"])
    return out
