"""Flash attention, forward and backward (counterpart of
horovod_tpu/ops/flash_attention.py).

Exact attention with an online softmax that never writes the (S, S)
scores, through three hand-written CUDA kernels (csrc/, sm_90a):
  * kernel 4, `flash_fwd` (csrc/flash_fwd.cu; replaces the Pallas
    `_fwd_kernel`): o and the f32 row log-sum-exp lse;
  * kernel 5, `flash_bwd_dkdv` (csrc/flash_bwd_dkdv.cu; replaces
    `_bwd_dkdv_kernel`): dk and dv, plus the row sums
    delta = rowsum(do * o) - dlse from a pre-pass of the same launch;
  * kernel 6, `flash_bwd_dq` (csrc/flash_bwd_dq.cu; replaces
    `_bwd_dq_kernel`): dq.
Each takes bf16 or f32 (tf32 products) at any head dim up to 256: the
wrappers zero-pad dh to the next compile-time instance (32, 64, 128,
256) and slice the results back, which is exact (`_pad_head`). In bf16
at D 32–128, kernels 4 and 5 run on Hopper's wgmma with TMA-fed rings
and P kept in registers; kernel 6, f32 and D 256 run the simple
mma.sync versions.

Beside each kernel: its plain PyTorch version (`_fwd_plain`,
`_bwd_dkdv_plain`, `_bwd_dq_plain`: full f32 scores, the softmax, and the
backward written out with the kernels' formulas), which a CPU tensor
takes and the card checks compare against, and its launch counter
(`.launches` on the wrapper). A CUDA tensor always launches the kernel,
or raises KernelError, for instance for a head dim above 256.

The route is chosen by shape, as in the JAX package: `flash_attention`
sends a shape that `_auto_block` cannot tile to
`blockwise_attention_reference`. The kernels choose their own 64-row
tiles and mask ragged edges; `block_q`/`block_k` only validate, as there.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from horovod_tpu_torch import kernels
from horovod_tpu_torch.common.exceptions import KernelError
from horovod_tpu_torch.parallel.ring_attention import (
    blockwise_attention_reference)

_NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)  # the kernels' compile-time instances
_IS_F32 = {torch.bfloat16: 0, torch.float32: 1}


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _scores(q, k, causal, scale):
    """s·scale in f32, masked to −1e30 above the diagonal when causal
    (the JAX kernels' `_attn_block` before its exp)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(keep, s, _NEG_INF)
    return s


def _fwd_plain(q, k, v, causal, scale):
    """Plain version of kernel 4: (o in q.dtype, lse f32)."""
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    return o.to(q.dtype), lse


def _ds(q, k, v, do, lse, delta, causal, scale):
    """(p, ds) with ds = p ∘ (do·vᵀ − delta)·scale."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def _delta(o, do, dlse):
    delta = (do.float() * o.float()).sum(-1)
    return delta if dlse is None else delta - dlse


def _bwd_dkdv_plain(q, k, v, o, do, lse, dlse, causal, scale):
    """Plain version of kernel 5 and its pre-pass: (dk, dv, delta)."""
    delta = _delta(o, do, dlse)
    p, ds = _ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(q.dtype), dv.to(q.dtype), delta


def _bwd_dq_plain(q, k, v, do, lse, delta, causal, scale):
    """Plain version of kernel 6: dq."""
    _, ds = _ds(q, k, v, do, lse, delta, causal, scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _instance(dh: int) -> int:
    """The smallest compile-time head dim that holds dh."""
    for d in HEAD_DIMS:
        if dh <= d:
            return d
    raise KernelError(f"head dim {dh} is above {HEAD_DIMS[-1]}, the "
                      f"largest the kernels take")


def _pad_head(t: torch.Tensor, D: int) -> torch.Tensor:
    """t with its last dim zero-padded to D. Zero columns add nothing to
    q·kᵀ, so scores, lse and delta are unchanged, and they give zero
    columns of o, dq, dk and dv, which the wrappers slice away."""
    dh = t.shape[-1]
    return t if dh == D else torch.nn.functional.pad(t, (0, D - dh))


def _unpad(t: torch.Tensor, dh: int) -> torch.Tensor:
    return t if t.shape[-1] == dh else t[..., :dh].contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _cuda_args(what: str, mats, rows):
    """What the kernels read, after the checks: one CUDA device, bf16 or
    f32 matrices of one dtype with a head dim of at most 256, contiguous
    and zero-padded to their instance's head dim, 16-byte aligned (the
    kernels load rows 16 bytes at a time), f32 contiguous rows. Returns
    (mats, rows, D)."""
    mats = list(mats)
    rows = [r for r in rows if r is not None]
    dev, dtype, dh = mats[0].device, mats[0].dtype, mats[0].shape[-1]
    for t in mats + rows:
        if t.device.type != "cuda":
            raise KernelError(f"{what}: takes CUDA tensors, got a tensor on "
                              f"{t.device}")
        if t.device != dev:
            raise KernelError(f"{what}: tensors on {dev} and {t.device}")
    if dtype not in _IS_F32 or any(t.dtype != dtype for t in mats):
        raise KernelError(f"{what}: takes bfloat16 or float32 q, k, v of "
                          f"one dtype, got {[t.dtype for t in mats]}")
    try:
        D = _instance(dh)
    except KernelError as e:
        raise KernelError(f"{what}: {e}") from None
    if any(r.dtype != torch.float32 for r in rows):
        raise KernelError(f"{what}: lse, delta and dlse must be float32")

    mats = [_pad_head(t, D).contiguous() for t in mats]
    if any(t.data_ptr() % 16 for t in mats):
        raise KernelError(f"{what}: q, k, v, o and do must start on a "
                          f"16-byte boundary")
    return mats, [r.contiguous() for r in rows], D


def _call(name: str, fn_name: str, args, ints, scale, causal, is_f32,
          stream):
    fn = getattr(kernels.lib(name), fn_name)
    fn.argtypes = ([kernels.P] * len(args) + [kernels.I] * len(ints)
                   + [ctypes.c_float, kernels.I, kernels.I, kernels.P])
    fn.restype = ctypes.c_int
    err = fn(*[_ptr(t) for t in args], *ints, scale, int(causal), is_f32,
             stream)
    kernels.check(err, fn_name)


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float):
    """Kernel 4. q (BH, Sq, dh), k, v (BH, Sk, dh). Returns (o (BH, Sq,
    dh) in q.dtype, lse (BH, Sq) f32)."""
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, causal, scale)
    dh = q.shape[-1]
    (q, k, v), _, D = _cuda_args("flash_fwd", (q, k, v), ())
    bh, sq, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _call("flash_fwd", "hvd_flash_fwd", (q, k, v, o, lse),
          (bh, sq, k.shape[1], D), scale, causal, _IS_F32[q.dtype],
          _stream(q))
    flash_fwd.launches += 1
    return _unpad(o, dh), lse


flash_fwd.launches = 0


def flash_bwd_dkdv(q, k, v, o, do, lse, dlse, causal: bool, scale: float):
    """Kernel 5 and its delta pre-pass. dlse None takes the variant
    without an lse cotangent. Returns (dk, dv, delta (BH, Sq) f32)."""
    if q.device.type == "cpu":
        return _bwd_dkdv_plain(q, k, v, o, do, lse, dlse, causal, scale)
    dh = q.shape[-1]
    (q, k, v, o, do), rows, D = _cuda_args(
        "flash_bwd_dkdv", (q, k, v, o, do), (lse, dlse))
    lse, dlse = rows[0], (rows[1] if dlse is not None else None)
    bh, sq, _ = q.shape
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("flash_bwd_dkdv", "hvd_flash_bwd_dkdv",
          (q, k, v, o, do, lse, dlse, delta, dk, dv),
          (bh, sq, k.shape[1], D), scale, causal, _IS_F32[q.dtype],
          _stream(q))
    flash_bwd_dkdv.launches += 1
    return _unpad(dk, dh), _unpad(dv, dh), delta


flash_bwd_dkdv.launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Kernel 6: dq (BH, Sq, dh) from the delta of kernel 5."""
    if q.device.type == "cpu":
        return _bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    dh = q.shape[-1]
    (q, k, v, do), (lse, delta), D = _cuda_args(
        "flash_bwd_dq", (q, k, v, do), (lse, delta))
    bh, sq, _ = q.shape
    dq = torch.empty_like(q)
    _call("flash_bwd_dq", "hvd_flash_bwd_dq", (q, k, v, do, lse, delta, dq),
          (bh, sq, k.shape[1], D), scale, causal, _IS_F32[q.dtype],
          _stream(q))
    flash_bwd_dq.launches += 1
    return _unpad(dq, dh)


flash_bwd_dq.launches = 0


def _bwd(q, k, v, o, lse, do, dlse, causal, scale):
    dk, dv, delta = flash_bwd_dkdv(q, k, v, o, do, lse, dlse, causal, scale)
    return flash_bwd_dq(q, k, v, do, lse, delta, causal, scale), dk, dv


# --------------------------------------------------------------------------
# autograd Functions (the JAX package's custom VJPs)
# --------------------------------------------------------------------------

class _FlashChunk(torch.autograd.Function):
    """(o, lse), differentiable through both: a None lse cotangent (lse
    unused, as in `flash_attention`) takes the kernel variant without
    dlse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = _bwd(q, k, v, o, lse, do, dlse, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def can_tile(Sq: int, Sk: Optional[int] = None,
             causal: bool = False) -> bool:
    """True when the kernel path handles these sequence lengths."""
    if _auto_block(Sq) is None:
        return False
    if Sk is not None and _auto_block(Sk) is None:
        return False
    if causal and Sk is not None and Sq != Sk:
        return False
    return True


def _auto_block(S: int) -> Optional[int]:
    """The JAX package's block rule, kept so that the same shapes take
    the kernel route: S itself up to 1024, else the largest of 1024, 512,
    256, 128 that divides S, else None."""
    if S <= 1024:
        return S
    for b in (1024, 512, 256, 128):
        if S % b == 0:
            return b
    return None


def flash_attention_chunk(q, k, v, causal: bool = False,
                          scale: Optional[float] = None,
                          block_q: Optional[int] = None,
                          block_k: Optional[int] = None):
    """One attention chunk with mergeable outputs.

    q: (B, H, Sq, dh); k, v: (B, H, Sk, dh), Sq ≠ Sk allowed when not
    causal. Returns (o (B, H, Sq, dh), lse (B, H, Sq) f32), both
    differentiable; merge chunks with L = logaddexp(L1, L2),
    o = e^{L1−L}·o1 + e^{L2−L}·o2."""
    B, H, Sq, dh = q.shape
    Sk = k.shape[2]
    if scale is None:
        scale = dh ** -0.5
    bq = min(block_q, Sq) if block_q else _auto_block(Sq)
    bk = min(block_k, Sk) if block_k else _auto_block(Sk)
    if (bq is None or bk is None or Sq % bq or Sk % bk
            or (causal and Sq != Sk)):
        raise ValueError(
            f"flash_attention_chunk cannot tile Sq={Sq}, Sk={Sk} "
            f"(blocks {bq}, {bk}); causal chunks must be square")
    o, lse = _FlashChunk.apply(q.reshape(B * H, Sq, dh),
                               k.reshape(B * H, Sk, dh),
                               v.reshape(B * H, Sk, dh), causal, float(scale))
    return o.reshape(B, H, Sq, dh), lse.reshape(B, H, Sq)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Exact attention of q, k, v (B, H, S, dh) through kernels 4–6.
    Returns (B, H, S, dh), differentiable. A shape `_auto_block` cannot
    tile (or that the given blocks do not divide) takes
    blockwise_attention_reference, as in the JAX package."""
    B, H, S, dh = q.shape
    if scale is None:
        scale = dh ** -0.5
    block_q = min(block_q, S) if block_q else _auto_block(S)
    block_k = min(block_k, S) if block_k else _auto_block(S)
    if (block_q is None or block_k is None
            or S % block_q or S % block_k):
        return blockwise_attention_reference(q, k, v, causal=causal,
                                             scale=scale)
    o = _FlashChunk.apply(q.reshape(B * H, S, dh), k.reshape(B * H, S, dh),
                          v.reshape(B * H, S, dh), causal, float(scale))[0]
    return o.reshape(B, H, S, dh)
