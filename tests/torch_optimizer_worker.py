"""Worker for tests/test_torch_dist_optimizer.py: one rank of a gloo
world that drives horovod_tpu_torch's DistributedOptimizer, its sparse
path and the object helpers.

Imports torch and horovod_tpu_torch only. Started with the `spawn`
method (tests/torch_collectives_worker.py spawn); its inputs arrive as
numpy arrays (bf16 as uint16 bit patterns under a "bf16:" key prefix),
and it writes every result to `out_path` as an .npz file.

Every case installs seeded per-rank gradients through a real backward
pass, so that the post-accumulate-grad hooks fire: the loss
Σ_i (p_i · g_i).sum() has the gradient g_i exactly, in f32 and in bf16.
"""

import numpy as np

from torch_collectives_worker import _env, _io

SHAPES = [(5, 3), (7,), (4, 2, 2), (11,)]
# Small enough that the four parameters plan into several buckets.
THRESHOLD = 64
EMB = (20, 3)  # the sparse case's embedding table
SET3 = [0, 1, 2]
OBJ_SET = [0, 2, 3]  # leaves out rank 0's neighbour


def _params(torch, dt):
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    return [torch.nn.Parameter(torch.zeros(s, dtype=dtype)) for s in SHAPES]


def _backward(ps, gs):
    sum((p * g).sum() for p, g in zip(ps, gs)).backward()


def run_opt(rank, size, store, inputs, out_path):
    """Every optimizer case of the 4-rank world."""
    _env(rank, size, {"HOROVOD_DYNAMIC_PROCESS_SETS": "1",
                      "HOROVOD_FUSION_THRESHOLD": str(THRESHOLD)})
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion

    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    get, bits = _io(inputs, rank)
    out = {}

    def case(name, dt="f32", gkey="g", **kw):
        ps = _params(torch, dt)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(ps, lr=0.0),
            named_parameters=[(f"p{i}", p) for i, p in enumerate(ps)], **kw)
        _backward(ps, [get(f"{gkey}{i}_{dt}") for i in range(len(ps))])
        opt.synchronize()
        for i, p in enumerate(ps):
            out[f"{name}/{i}"] = bits(p.grad)
            out[f"{name}/dtype{i}"] = np.asarray(str(p.grad.dtype))
        out[f"{name}/calls"] = np.asarray(opt.collectives_per_step)
        out[f"{name}/hooked"] = np.asarray(opt.hooked)
        out[f"{name}/buckets"] = np.asarray(len(opt.plan))
        return ps

    try:
        for dt in ("f32", "bf16"):
            for op in ("AVERAGE", "SUM", "MIN", "MAX", "PRODUCT", "ADASUM"):
                case(f"{op}_{dt}", dt, op=op)
            case(f"predivide_{dt}", dt, gradient_predivide_factor=4.0)
        case("fp16", compression=hvd.Compression.fp16)
        case("groups2", groups=2)
        case("groups3_max", groups=3, op=hvd.Max)
        ref = _params(torch, "f32")
        case("groups_list", groups=[[ref[1], ref[3]]])
        s3 = hvd.add_process_set(SET3)
        if rank in SET3:
            case("set3_avg", process_set=s3)
            case("set3_adasum", process_set=s3, op=hvd.Adasum)
            case("set3_groups", process_set=s3, groups=2, op=hvd.Sum)

        # The plan: the group plan and the bucket plan of the hook path.
        ps = _params(torch, "f32")
        opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=0.0))
        out["plan_sig"] = np.asarray(fusion.plan_signature(opt.plan))

        # backward_passes_per_step 3: three passes pile up in .grad;
        # step() returns None twice and moves nothing.
        ps = _params(torch, "f32")
        opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=1.0),
                                       backward_passes_per_step=3)
        for j in range(3):
            _backward(ps, [get(f"bp{j}_{i}_f32") for i in range(len(ps))])
            # the closure's value comes back only from a step that applies
            ret = opt.step(lambda: torch.tensor(7.0))
            out[f"bpps/ret{j}"] = np.asarray(ret is None)
            for i, p in enumerate(ps):
                out[f"bpps/p{j}_{i}"] = p.detach().numpy().copy()
        # then a second cycle: the hooks count passes per cycle
        opt.zero_grad()
        for j in range(3):
            _backward(ps, [get(f"bp{j}_{i}_f32") for i in range(len(ps))])
            out[f"bpps/ret2_{j}"] = np.asarray(
                opt.step(lambda: torch.tensor(7.0)) is None)
        for i, p in enumerate(ps):
            out[f"bpps/p_cycle2_{i}"] = p.detach().numpy().copy()

        # Sparse gradients: nn.Embedding(sparse=True) beside a dense
        # parameter, two steps (the first rides the bucket as zeros and
        # re-plans), against the same model under sparse_as_dense.
        idx = torch.from_numpy(inputs["emb_idx"][rank].copy())
        w = torch.from_numpy(inputs["emb_w"][rank].copy())
        for tag, dense in (("sparse", False), ("as_dense", True)):
            emb = torch.nn.Embedding(*EMB, sparse=True)
            torch.nn.init.zeros_(emb.weight)
            bias = torch.nn.Parameter(torch.zeros(3))
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD([emb.weight, bias], lr=1.0),
                sparse_as_dense=dense)
            for step in range(2):
                opt.zero_grad()
                ((emb(idx) + bias) * w).sum().backward()
                out[f"{tag}/is_sparse{step}"] = np.asarray(
                    emb.weight.grad.is_sparse)
                opt.synchronize()
                g = emb.weight.grad
                out[f"{tag}/grad{step}"] = (g.to_dense() if g.is_sparse
                                            else g).numpy().copy()
                out[f"{tag}/bias{step}"] = bias.grad.numpy().copy()
                out[f"{tag}/buckets{step}"] = np.asarray(len(opt.plan))
                opt.step()
            out[f"{tag}/weight"] = emb.weight.detach().numpy().copy()
        h = hvd.sparse_allreduce_async(
            torch.sparse_coo_tensor(idx[None, :], w, size=EMB), op=hvd.Sum)
        out["sparse_sum"] = hvd.synchronize(h).to_dense().numpy()

        # Objects: broadcast from global rank 2 over a set without rank
        # 1, and allgather over the world and the set.
        so = hvd.add_process_set(OBJ_SET)
        if rank in OBJ_SET:
            got = hvd.broadcast_object(
                {"from": rank, "t": torch.full((3,), float(rank))},
                root_rank=2, process_set=so)
            out["obj_set/from"] = np.asarray(got["from"])
            out["obj_set/t"] = got["t"].numpy()
            out["obj_set/gather"] = np.asarray(
                hvd.allgather_object(rank * 10, process_set=so))
        out["obj_gather"] = np.asarray(
            [o["r"] for o in hvd.allgather_object({"r": rank,
                                                   "pad": "x" * rank})])
        hvd.barrier()
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)


def run_c5(rank, size, store, inputs, out_path):
    """Fault C5: rank 0 resumed (it took one step, so it holds momentum
    buffers), rank 1 starts fresh; broadcast_optimizer_state."""
    _env(rank, size, {})
    import torch

    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    out = {}
    try:
        torch.manual_seed(rank)
        model = torch.nn.Linear(3, 2)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        if rank == 0:
            model(torch.randn(4, 3)).sum().backward()
            opt.step()
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        out["entries"] = np.asarray(len(opt.state))
        for i, p in enumerate(model.parameters()):
            buf = opt.state[p]["momentum_buffer"]
            out[f"buf{i}"] = buf.numpy().copy()
            out[f"buf_device{i}"] = np.asarray(str(buf.device))
        out["lr"] = np.asarray(opt.param_groups[0]["lr"])
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)
