"""Worker for tests/test_torch_tp_pp_ep.py and tests/test_torch_tied_lm.py:
one rank of a 4-rank gloo world under HOROVOD_MESH="dp=2,tp=2" that
runs the PyTorch package's tensor, pipeline and expert parallelism on
that mesh and on others built inside the same world
(parallel/mesh.build_mesh, each used through `use_mesh`).

Imports torch and horovod_tpu_torch only. Started with the `spawn`
method through tests/torch_world_worker.py; inputs arrive as numpy
arrays, and every result goes to `out_path` as an .npz file.
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


def _mesh(text, size):
    from horovod_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    return build_mesh(MeshSpec.parse(text, size))


def _pipeline(torch, mesh, ws, x):
    """pipeline_apply over pp of a tanh-layer stack (this stage's slice
    of `ws`), its output and the gradients of Σ y² (no psum first)."""
    from horovod_tpu_torch.parallel.mesh import axis_index, axis_sizes, \
        use_mesh
    from horovod_tpu_torch.parallel.pipeline import pipeline_apply
    with use_mesh(mesh):
        P, s = axis_sizes()["pp"], axis_index("pp")
        n = ws.shape[0] // P
        w = torch.from_numpy(ws[s * n:(s + 1) * n].copy()).requires_grad_()
        xm = torch.from_numpy(x).requires_grad_()

        def stage_fn(stage_ws, act):
            for layer in stage_ws:
                act = torch.tanh(act @ layer)
            return act

        y = pipeline_apply(stage_fn, w, xm, "pp")
        (y ** 2).sum().backward()
    return {"y": y.detach().numpy(), "dw": w.grad.numpy(),
            "dx": xm.grad.numpy()}


def _moe(torch, mesh, x, router, w1, w2, cf):
    """moe_ffn over ep: this rank's token block and its experts; the
    routing of its tokens, and the gradients of Σ out²."""
    from horovod_tpu_torch.parallel.mesh import axis_index, axis_sizes, \
        use_mesh
    from horovod_tpu_torch.parallel.moe import moe_ffn, route
    with use_mesh(mesh):
        P, e = axis_sizes()["ep"], axis_index("ep")
        t, n = x.shape[0] // P, w1.shape[0] // P
        xs = torch.from_numpy(x[e * t:(e + 1) * t].copy()).requires_grad_()
        r = torch.from_numpy(router).requires_grad_()
        a = torch.from_numpy(w1[e * n:(e + 1) * n].copy()).requires_grad_()
        b = torch.from_numpy(w2[e * n:(e + 1) * n].copy()).requires_grad_()
        out = moe_ffn(xs, r, a, b, "ep", capacity_factor=cf)
        (out ** 2).sum().backward()
        _, expert, _, keep, _ = route(xs.detach(), r.detach(), cf)
    return {"out": out.detach().numpy(), "expert": expert.numpy(),
            "keep": keep.numpy(), "dx": xs.grad.numpy(),
            "drouter": r.grad.numpy(), "dw1": a.grad.numpy(),
            "dw2": b.grad.numpy()}


def _lm(torch, hvd, mesh, cfg_kw, params, tokens, steps, lr):
    """The LM on `mesh` from the JAX weights, trained `steps` SGD steps
    through the sharded step: each step's world loss, the reduced
    gradients of the first and the weights at the end."""
    from horovod_tpu_torch import transformer_lm as lm
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel.mesh import use_mesh
    out = {}
    with use_mesh(mesh):
        cfg = tfm.TransformerConfig(**cfg_kw, dtype=torch.float32)
        model = tfm.TransformerLM(cfg, seed=99)
        convert.load_jax_transformer(model, params)
        tok = tfm.batch_shard(torch.from_numpy(tokens))
        tgt = tfm.batch_shard(torch.from_numpy(np.roll(tokens, -1, 1)))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=lr),
            named_parameters=model.named_parameters(), op=hvd.Sum,
            sharding_spec=tfm.named_specs(model), mesh=mesh)
        step = opt.sharded_step(
            lambda _, b: tfm.local_loss(model, *b),
            batch_spec=lm.BATCH_SPEC, loss_axes=lm.LOSS_AXES)
        for i in range(steps):
            out[f"loss{i}"] = step((tok, tgt)).numpy()
            if i == 0:
                for name, p in model.named_parameters():
                    out[f"grad/{name}"] = p.grad.numpy().copy()
        for name, p in model.named_parameters():
            out[f"state/{name}"] = p.detach().numpy().copy()
    return out


def _lm_ckpt(torch, hvd, mesh, cfg_kw, params, root, rank, size):
    """The LM's shards on `mesh` saved as Fragments (one writer a shard)
    and restored whole: the assembled state dict, and this rank's
    shard_state of it on dp=2 x tp=2."""
    import torch.distributed as dist
    from horovod_tpu_torch import ckpt
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.parallel.mesh import use_mesh
    with use_mesh(mesh):
        cfg = tfm.TransformerConfig(**cfg_kw, dtype=torch.float32)
        model = tfm.TransformerLM(cfg, seed=99)
        convert.load_jax_transformer(model, params)
        tree = {"params": tfm.checkpoint_tree(model)}
    saver = ckpt.AsyncCheckpointer(
        root, writers=size, kv=StoreKV(dist.distributed_c10d
                                       ._get_default_store()))
    ok = saver.save(1, tree, block=True)
    if rank == 0 and not ok:
        raise RuntimeError(f"the LM save did not commit: "
                           f"{saver.last_error}")
    hvd.allreduce(torch.zeros(1), name="committed")  # a barrier
    whole = ckpt.AsyncCheckpointer(root).restore_latest().tree["params"]
    out = {f"whole/{n}": v.numpy() for n, v in whole.items()}
    tp = _mesh("dp=2,tp=2", size)
    out.update({f"tp/{n}": v.numpy() for n, v in
                tfm.shard_state(whole, cfg, tp).items()})
    return out


def run_lm(rank, size, store, cases, out_path):
    """Every case of `cases` in order, in one world: name -> (kind,
    mesh, args); kind "lm" (cfg_kw, params, tokens, steps, lr),
    "pipeline" (ws, x), "moe" (x, router, w1, w2, capacity_factor) or
    "ckpt" (cfg_kw, params, root)."""
    torch, hvd = _join(rank, size, store, "dp=2,tp=2")
    out = {}
    try:
        for name, (kind, text, args) in cases.items():
            mesh = _mesh(text, size)
            if kind == "lm":
                res = _lm(torch, hvd, mesh, *args)
            elif kind == "pipeline":
                res = _pipeline(torch, mesh, *args)
            elif kind == "ckpt":
                res = _lm_ckpt(torch, hvd, mesh, *args, rank, size)
            else:
                res = _moe(torch, mesh, *args)
            out.update({f"{name}/{k}": v for k, v in res.items()})
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)


# --------------------------------------------------------- the tied LM

class StoreKV:
    """The checkpointer's KV (put/get of bytes by scope and key) over the
    world's torch Store: the writers' manifest fragments meet there
    without a rendezvous server."""

    def __init__(self, store):
        self.store = store

    def put(self, scope, key, value):
        self.store.set(f"kv/{scope}/{key}", value)

    def get(self, scope, key, timeout=0.0):
        k = f"kv/{scope}/{key}"
        return self.store.get(k) if self.store.check([k]) else None


def _tied_steps(torch, hvd, mesh, specs, shards, data, cfg, steps,
                opt_kind, lr, state=None):
    """`steps` sharded steps of the tied LM on `mesh` from this rank's
    `shards` ({name: tensor}) through DistributedOptimizer(
    sharding_spec=...).sharded_step; `state` a named optimizer state to
    start from. Returns (losses, the DistributedOptimizer, shards)."""
    from horovod_tpu_torch.models import tied_lm
    from horovod_tpu_torch.optim.optimizer import load_named_state
    from horovod_tpu_torch.parallel.mesh import shard_of, use_mesh
    shards = {n: t.detach().clone().requires_grad_()
              for n, t in shards.items()}
    inner = (torch.optim.SGD if opt_kind == "sgd" else torch.optim.Adam)(
        list(shards.values()), lr=lr)
    if state is not None:
        load_named_state(inner, list(shards.items()), state)
    opt = hvd.DistributedOptimizer(inner, named_parameters=list(
        shards.items()), sharding_spec=specs, mesh=mesh)
    step = opt.sharded_step(
        lambda p, b: tied_lm.local_loss(p, b[0], b[1], cfg))
    with use_mesh(mesh):
        batch = tuple(shard_of(torch.from_numpy(a), ("dp",))
                      for a in data)
    return [float(step(batch)) for _ in range(steps)], opt, shards


def run_tied(rank, size, store, cfg_kw, params, data, root, out_path):
    """The tied LM in one world: its local loss on dp=2 x tp=2, SGD
    trajectories there (param_specs) and on dp=4 (replicated, through
    build_sharded_train_step), an Adam
    one on dp=2 x tp=2 (and the optimizer's shard_params of the global
    weights) and through hybrid_lm.train, and a tp=4 Adam run
    checkpointed after 3 steps (sharded leaves, one writer a shard) and
    resumed for 2 on dp=2 x tp=2 and on dp=4."""
    torch, hvd = _join(rank, size, store, "dp=2,tp=2")
    from horovod_tpu_torch import ckpt, hybrid_lm
    from horovod_tpu_torch.ckpt import sharded
    from horovod_tpu_torch.models import tied_lm
    from horovod_tpu_torch.optim.optimizer import (named_state,
                                                   opt_state_specs)
    from horovod_tpu_torch.parallel.mesh import shard_of, use_mesh
    cfg = tied_lm.TiedLMConfig(**cfg_kw)
    glob = {n: torch.from_numpy(v) for n, v in params.items()}
    out = {}
    try:
        hy, dp4, tp4 = (_mesh(t, size) for t in ("dp=2,tp=2", "dp=4",
                                                 "tp=4"))
        ps, rs = tied_lm.param_specs(cfg), tied_lm.replicated_specs(cfg)

        def cut(mesh, specs):
            with use_mesh(mesh):
                return {n: shard_of(v, specs[n]) for n, v in glob.items()}

        with use_mesh(hy):
            tok, tgt = (shard_of(torch.from_numpy(a), ("dp",))
                        for a in data)
            out["local_loss"] = tied_lm.local_loss(cut(hy, ps), tok, tgt,
                                                   cfg).detach().numpy()
            out["dp_index"] = np.asarray(hy.coords(rank)["dp"])
        out["sgd_hybrid"] = _tied_steps(torch, hvd, hy, ps, cut(hy, ps),
                                        data, cfg, 5, "sgd", 0.05)[0]
        # dp=4 through build_sharded_train_step
        from horovod_tpu_torch.optim.optimizer import (
            build_sharded_train_step)
        shards = {n: t.requires_grad_() for n, t in cut(dp4, rs).items()}
        step = build_sharded_train_step(
            lambda p, b: tied_lm.local_loss(p, b[0], b[1], cfg),
            torch.optim.SGD(list(shards.values()), lr=0.05),
            list(shards.items()), mesh=dp4, param_specs=rs)
        with use_mesh(dp4):
            batch = tuple(shard_of(torch.from_numpy(a), ("dp",))
                          for a in data)
        out["sgd_dp4"] = [float(step(batch)) for _ in range(5)]
        losses, opt, shards = _tied_steps(torch, hvd, hy, ps, cut(hy, ps),
                                          data, cfg, 3, "adam", 1e-2)
        out["adam_hybrid"] = losses
        out["adam_emb_moment_shape"] = np.asarray(
            opt.state[shards["emb"]]["exp_avg"].shape)
        again = opt.shard_params(glob)
        out["shard_params_equal"] = np.asarray(all(
            torch.equal(again[n], v) for n, v in cut(hy, ps).items()))
        out["hybrid_lm"] = hybrid_lm.train(
            cfg, hy, params=glob, data=tuple(torch.from_numpy(a)
                                             for a in data), steps=3,
            lr=1e-2)[0]

        # tp=4: 3 Adam steps, save, 2 more (the uninterrupted run)
        losses, opt, shards = _tied_steps(torch, hvd, tp4, ps,
                                          cut(tp4, ps), data, cfg, 3,
                                          "adam", 1e-2)
        state = named_state(opt.opt, list(shards.items()))
        with use_mesh(tp4):
            tree = {"params": sharded.fragments(shards, ps),
                    "opt_state": sharded.fragments(state, opt_state_specs(
                        state, shards, ps))}
        import torch.distributed as dist
        saver = ckpt.AsyncCheckpointer(
            root, writers=size, kv=StoreKV(dist.distributed_c10d
                                           ._get_default_store()))
        out["saved"] = np.asarray(saver.save(3, tree, block=True))
        if rank == 0 and not out["saved"]:
            raise RuntimeError(f"the tp=4 save did not commit: "
                               f"{saver.last_error}")
        hvd.allreduce(torch.zeros(1), name="committed")  # a barrier
        more = _tied_steps(torch, hvd, tp4, ps, shards, data, cfg, 2,
                           "adam", 1e-2, state=state)[0]
        out["adam_tp4"] = losses + more
        for tag, mesh, specs in (("hy", hy, ps), ("dp4", dp4, rs)):
            got = ckpt.AsyncCheckpointer(root).restore_latest()
            params2 = sharded.reshard(got.tree["params"], mesh, specs)
            st2 = sharded.reshard(got.tree["opt_state"], mesh,
                                  opt_state_specs(got.tree["opt_state"],
                                                  got.tree["params"],
                                                  specs))
            out[f"resumed_{tag}"] = _tied_steps(
                torch, hvd, mesh, specs, params2, data, cfg, 2, "adam",
                1e-2, state=st2)[0]
            out[f"restored_step_{tag}"] = np.asarray(got.step)
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)
