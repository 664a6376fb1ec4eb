"""Model-FLOPs accounting for the port (a copy of what it needs from
horovod_tpu/profiler/flops.py, plus the H100's peak).

Counts mul and add separately, as the card's published peak does.
"""

from __future__ import annotations

from typing import Optional

# Peak dense bf16 FLOP/s of a card, by the start of
# torch.cuda.get_device_name(): NVIDIA's H100 SXM data sheet, at the
# full 700 W power limit.
PEAK_TFLOPS = {"NVIDIA H100": 989.0}


def peak_flops(device_name: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the named card, None if unknown."""
    for name, tf in PEAK_TFLOPS.items():
        if device_name.startswith(name):
            return tf * 1e12
    return None


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
