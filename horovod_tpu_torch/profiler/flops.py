"""Model-FLOPs accounting (counterpart of horovod_tpu/profiler/flops.py):
one home for the FLOPs constants and the card's peak.

Conventions, the JAX package's (they differ, and the factor of 2
matters):

* The conv-model constants (ResNet, Inception, VGG) follow the
  torchvision **multiply-add (MAC)** convention: one MAC = 1 "FLOP".
  `*_train_flops_per_image(..., convention="flops")` returns the 2x
  variant that counts mul and add apart, as the card's published peak
  and `torch.utils.flop_counter` do.
* The transformer formula (6N + attention, PaLM appendix B) counts mul
  and add apart already.

The counted source is `counted_flops`: FlopCounterMode over one call of
a function, on the ops PyTorch dispatches. It cannot see the CUDA
kernels the port calls through ctypes (the fused 1x1 sites of the block
and fuse_bn routes), so count on the unfused route or the plain model.
HOROVOD_PERFSCOPE_XLA_FLOPS=0 turns the counted source off (the knob
keeps the JAX package's name), leaving the constants.

MFU is defined as in the PaLM paper: observed throughput times model
FLOPs per sample over the card's peak FLOP/s.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

from horovod_tpu_torch.common import config as C

# Peak dense bf16 FLOP/s and memory of a card, by the start of
# torch.cuda.get_device_name(): NVIDIA's H100 SXM data sheet (989
# TFLOP/s dense bf16 at the full 700 W power limit; 80 GB of HBM3).
PEAK_TFLOPS = {"NVIDIA H100": 989.0}
HBM_GIB = {"NVIDIA H100": 80.0}

#: Forward GMACs per image @224 (torchvision multiply-add convention).
RESNET_FWD_GMACS = {50: 4.1, 101: 7.8, 152: 11.5}
#: Inception V3 fwd @299, same convention.
INCEPTION_V3_FWD_GMACS = 5.73
#: VGG-16 fwd @224, same convention.
VGG16_FWD_GMACS = 15.5

#: Training step ~= forward + 2x backward.
TRAIN_STEP_MULTIPLIER = 3.0


def _device_name() -> Optional[str]:
    import torch
    return torch.cuda.get_device_name() if torch.cuda.is_available() \
        else None


def _lookup(table: dict, device_name: Optional[str]) -> Optional[float]:
    if device_name is None:
        device_name = _device_name()
        if device_name is None:
            return None
    for name, v in table.items():
        if device_name.startswith(name):
            return v
    return None


def peak_flops_per_chip(device_name: Optional[str] = None
                        ) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the card (default: this process's
    current one), None on an unknown card or without one.
    HOROVOD_BENCH_PEAK_TFLOPS overrides it; a value that is no number
    raises ValueError."""
    env = os.environ.get(C.HOROVOD_BENCH_PEAK_TFLOPS)
    if env:
        try:
            return float(env) * 1e12
        except ValueError:
            raise ValueError(
                f"HOROVOD_BENCH_PEAK_TFLOPS={env!r} is not a number")
    tf = _lookup(PEAK_TFLOPS, device_name)
    return tf * 1e12 if tf is not None else None


def hbm_bytes_per_chip(device_name: Optional[str] = None) -> Optional[int]:
    """The card's memory in bytes, None on an unknown card or without
    one. HOROVOD_BENCH_HBM_GB (GiB) overrides it; a value that is no
    number raises ValueError."""
    env = os.environ.get(C.HOROVOD_BENCH_HBM_GB)
    if env:
        try:
            return int(float(env) * (1 << 30))
        except ValueError:
            raise ValueError(
                f"HOROVOD_BENCH_HBM_GB={env!r} is not a number")
    gib = _lookup(HBM_GIB, device_name)
    return int(gib * (1 << 30)) if gib is not None else None


def _per_image(gmacs: float, convention: str) -> float:
    if convention == "macs":
        return gmacs * 1e9 * TRAIN_STEP_MULTIPLIER
    if convention == "flops":
        return 2.0 * gmacs * 1e9 * TRAIN_STEP_MULTIPLIER
    raise ValueError(f"unknown FLOPs convention {convention!r}")


def resnet_train_flops_per_image(depth: int = 50,
                                 convention: str = "macs") -> float:
    """Training FLOPs an image for ResNet @224."""
    return _per_image(RESNET_FWD_GMACS[depth], convention)


def inception_v3_train_flops_per_image(convention: str = "macs") -> float:
    return _per_image(INCEPTION_V3_FWD_GMACS, convention)


def vgg16_train_flops_per_image(convention: str = "macs") -> float:
    return _per_image(VGG16_FWD_GMACS, convention)


def transformer_train_flops_per_token(d_model: int, d_ff: int,
                                      n_layers: int, vocab: int,
                                      seq: int) -> float:
    """Analytical decoder-LM training FLOPs per token (6N + attention).

    The standard accounting (PaLM appendix B): matmul params
    (non-embedding) N ~= layers*(4*D^2 attn + 2*D*F ffn), fwd+bwd ~= 6*N
    per token; attention scores+values fwd+bwd ~= 12*L*S*D per token
    (causal halves it -> 6*L*S*D); + 6*D*V for the unembedding matmul."""
    n_matmul = n_layers * (4 * d_model * d_model + 2 * d_model * d_ff)
    return float(6 * n_matmul + 6 * n_layers * seq * d_model
                 + 6 * d_model * vocab)


def transformer_matmul_params(d_model: int, d_ff: int, n_layers: int,
                              vocab: int) -> int:
    """Non-embedding matmul params + embedding/unembedding."""
    n_matmul = n_layers * (4 * d_model * d_model + 2 * d_model * d_ff)
    return n_matmul + 2 * d_model * vocab


# ------------------------------------------------------------ counted

def counted_flops_enabled() -> bool:
    """The HOROVOD_PERFSCOPE_XLA_FLOPS gate (default on): `0` leaves the
    constants as the only FLOPs source."""
    return C._env_on(C.HOROVOD_PERFSCOPE_XLA_FLOPS, True)


def counted_flops(fn: Callable, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call `fn(*args, **kwargs)`, counted by
    torch.utils.flop_counter.FlopCounterMode (mul and add apart); None
    when the gate is off or nothing was counted. The call runs."""
    if not counted_flops_enabled():
        return None
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    total = counter.get_total_flops()
    return float(total) if total > 0 else None


def pick_flops(counted: Optional[float], fallback: Optional[float]
               ) -> Tuple[Optional[float], str]:
    """(flops, source): the counted FLOPs when present ("counted"), else
    the constant ("fallback"), else (None, "none")."""
    if counted:
        return counted, "counted"
    if fallback:
        return fallback, "fallback"
    return None, "none"
