"""Worker for tests/test_torch_sequence_parallel.py: one rank of a gloo
world under HOROVOD_MESH that runs the PyTorch package's sequence
parallelism.

Imports torch and horovod_tpu_torch only. Started with the `spawn`
method through tests/torch_world_worker.py; its inputs arrive as numpy
arrays (bf16 as uint16 bit patterns), and it writes every result to
`out_path` as an .npz file.
"""

import os

import numpy as np


def _join(rank, size, store, mesh):
    os.environ.update({"HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(size),
                       "HOROVOD_LOCAL_RANK": str(rank),
                       "HOROVOD_LOCAL_SIZE": str(size),
                       "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1",
                       "HOROVOD_MESH": mesh})
    import torch

    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    return torch, hvd


def run_attn(rank, size, store, cases, out_path):
    """Every attention case on an sp=`size` world. `cases` maps a name to
    (function, kwargs, q, k, v, grad): the global (B, H, S, dh) inputs,
    of which this rank takes its contiguous sequence block; with `grad`
    it also backpropagates the local Σ out² and keeps dq, dk, dv."""
    torch, hvd = _join(rank, size, store, f"sp={size}")
    from horovod_tpu_torch.parallel.ring_attention import (
        ring_attention, ring_flash_attention)
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention
    fns = {"ring": ring_attention, "ring_flash": ring_flash_attention,
           "ulysses": ulysses_attention}
    out = {}
    try:
        sp = hvd.axis_process_set("sp")
        out["sp_ranks"] = np.asarray(sp.ranks)
        for name, (fn, kw, *qkv, grad) in cases.items():
            ts = []
            for a in qkv:
                n = a.shape[2] // size
                a = a[:, :, rank * n:(rank + 1) * n].copy()
                t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                     if a.dtype == np.uint16 else torch.from_numpy(a))
                ts.append(t.requires_grad_(grad))
            o = fns[fn](*ts, "sp", **kw)
            out[f"{name}/o"] = (o.detach().view(torch.int16).numpy()
                                .view(np.uint16)
                                if o.dtype == torch.bfloat16
                                else o.detach().numpy())
            if grad:
                (o ** 2).sum().backward()
                for g, t in zip(("dq", "dk", "dv"), ts):
                    out[f"{name}/{g}"] = t.grad.numpy()
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)


def run_lm(rank, size, store, cfg_kw, state, tokens, steps, out_path):
    """The LM under HOROVOD_MESH="dp=2,sp=2" for attn ring, then ulysses:
    rank 0's weights (`state`, broadcast), tokens sharded as P("dp",
    "sp") cuts them with the targets rolled over the whole sequence; the
    logits before training, the world's loss of each Adam step, the
    reduced gradients of the first step and the weights after `steps`.
    Also transformer_lm.rank_batch's slice of its replica's batch."""
    torch, hvd = _join(rank, size, store, "dp=2,sp=2")
    from horovod_tpu_torch import transformer_lm as lm
    from horovod_tpu_torch.models import transformer as tfm
    out = {}
    try:
        dp_i, sp_i, sp_n = lm.coords()
        out["coords"] = np.asarray([dp_i, sp_i, sp_n])
        B, S = tokens.shape
        b, s = B // (size // sp_n), S // sp_n
        rows, cols = slice(dp_i * b, (dp_i + 1) * b), slice(sp_i * s,
                                                           (sp_i + 1) * s)
        tok = torch.from_numpy(tokens[rows, cols].copy())
        tgt = torch.from_numpy(np.roll(tokens, -1, axis=1)[rows, cols].copy())
        for attn in ("ring", "ulysses"):
            cfg = tfm.TransformerConfig(**cfg_kw, attn=attn,
                                        dtype=torch.float32)
            tfm.validate_cfg_for_mesh(cfg, hvd.hybrid_mesh())
            model, opt = lm.build(cfg, hvd.device(), seed=100 + rank)
            if rank == 0:
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        p.copy_(torch.from_numpy(state[name]))
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            with torch.no_grad():
                out[f"{attn}/logits"] = model(tok).numpy()
            for i in range(steps):
                loss = lm.train_step(model, opt, (tok, tgt))
                out[f"{attn}/loss{i}"] = np.asarray(lm.world_loss(loss))
                if i == 0:
                    for name, p in model.named_parameters():
                        out[f"{attn}/grad/{name}"] = p.grad.numpy().copy()
            for name, v in model.state_dict().items():
                out[f"{attn}/state/{name}"] = v.numpy()
        t, g = lm.rank_batch(2, S, cfg_kw["vocab"], hvd.device())
        out["rank_batch/tokens"], out["rank_batch/targets"] = t.numpy(), \
            g.numpy()
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)
