"""Worker for tests/test_torch_lm_train.py: one rank of a gloo world that
trains the PyTorch package's transformer LM with Adam.

Imports torch and horovod_tpu_torch only. Started with the `spawn`
method; everything it needs arrives as arguments, and it writes the
trained state to `out_path` as an .npz file.
"""

import os

import numpy as np


def run(rank: int, size: int, store: str, cfg_kw: dict, state: dict,
        tokens: np.ndarray, steps: int, out_path: str) -> None:
    os.environ.update({"HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(size),
                       "HOROVOD_LOCAL_RANK": str(rank),
                       "HOROVOD_LOCAL_SIZE": str(size),
                       "HOROVOD_FUSION_THRESHOLD": str(16 * 1024)})
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import transformer_lm as lm
    from horovod_tpu_torch.models import transformer as tfm

    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    out = {}
    try:
        cfg = tfm.TransformerConfig(**cfg_kw, attn="flash",
                                    dtype=torch.float32)
        # Every rank starts from its own random weights; build()
        # broadcasts rank 0's, which are the JAX weights.
        model, opt, step = lm.build(cfg, hvd.device(), seed=100 + rank)
        if rank == 0:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(torch.from_numpy(state[name]))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        out["n_buckets"] = np.asarray(len(opt.plan))
        n = tokens.shape[0] // size  # contiguous shards, as P("dp") cuts
        tok = torch.from_numpy(tokens[rank * n:(rank + 1) * n].copy())
        batch = (tok, torch.roll(tok, -1, dims=1))
        for i in range(steps):
            out[f"loss{i}"] = step(batch).numpy()
        for k, v in model.state_dict().items():
            out[f"state/{k}"] = v.numpy()
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)
