"""Worker for tests/test_torch_api_surface.py: one rank of a gloo world
of 2 that runs the in-place and grouped async collectives and the
count-weighted SyncBatchNorm.

Imports torch and horovod_tpu_torch only. Inputs and outputs travel as
in tests/torch_collectives_worker.py (numpy, bf16 as uint16 bit
patterns under a "bf16:" key prefix, results in an .npz file).
"""

import numpy as np

from torch_collectives_worker import _env, _io

OPS = ("AVERAGE", "SUM", "MAX", "PRODUCT", "ADASUM")
DTYPES = ("f32", "bf16", "i32")


def _same(r, t, ptr) -> np.ndarray:
    """The call gave back the caller's tensor object, in its storage."""
    return np.asarray(r is t and t.data_ptr() == ptr)


def run_api(rank, size, store, inputs, out_path):
    """Each in-place form beside its out-of-place form; the grouped async
    forms beside their synchronous ones; the build queries."""
    _env(rank, size, {})
    import torch

    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    get, bits = _io(inputs, rank)
    out = {"gloo_enabled": np.asarray(hvd.gloo_enabled()),
           "mpi_enabled": np.asarray(hvd.mpi_enabled()),
           "local_slot_ranks": np.asarray(hvd.local_slot_ranks())}
    try:
        for dt in DTYPES:
            x, x2 = get(f"x_{dt}"), get(f"x2_{dt}")
            ops = OPS if dt != "i32" else OPS[:4]
            for op in ops:
                out[f"oop_{op}_{dt}"] = bits(hvd.allreduce(x, op=op))
                t = x.clone()
                ptr = t.data_ptr()
                out[f"same_{op}_{dt}"] = _same(hvd.allreduce_(t, op=op), t,
                                               ptr)
                out[f"ip_{op}_{dt}"] = bits(t)
                t = x.clone()
                ptr = t.data_ptr()
                h = hvd.allreduce_async_(t, op=op, name=f"ar.{op}.{dt}")
                out[f"asame_{op}_{dt}"] = _same(hvd.synchronize(h), t, ptr)
                out[f"aip_{op}_{dt}"] = bits(t)
            if dt != "i32":
                kw = dict(op=hvd.Average, prescale_factor=0.5,
                          postscale_factor=3.0)
                out[f"oop_scaled_{dt}"] = bits(hvd.allreduce(x, **kw))
                t = x.clone()
                hvd.allreduce_(t, **kw)
                out[f"ip_scaled_{dt}"] = bits(t)
            # A transposed view (not contiguous), written in place.
            base = x.clone()
            tv = base.t()
            out[f"same_view_{dt}"] = np.asarray(
                hvd.allreduce_(tv, op=hvd.Sum) is tv)
            out[f"ip_view_{dt}"] = bits(base)

            group = [x.clone(), x2.clone(), x.clone().t()]
            ptrs = [g.data_ptr() for g in group]
            want = hvd.grouped_allreduce(
                [x, x2, x.t()], op=hvd.Sum)
            got = hvd.grouped_allreduce_(group, op=hvd.Sum)
            out[f"gsame_{dt}"] = np.asarray(
                all(r is g and g.data_ptr() == p
                    for r, g, p in zip(got, group, ptrs)))
            for i, (g, w) in enumerate(zip(group, want)):
                out[f"gip{i}_{dt}"] = bits(g.contiguous())
                out[f"goop{i}_{dt}"] = bits(w.contiguous())
            group = [x.clone(), x2.clone()]
            h = hvd.grouped_allreduce_async_(group, name=f"gar.{dt}")
            got = hvd.synchronize(h)
            out[f"gasame_{dt}"] = np.asarray(
                all(r is g for r, g in zip(got, group)))
            want = hvd.grouped_allreduce([x, x2])
            out[f"gaeq_{dt}"] = np.asarray(
                all(torch.equal(g, w) for g, w in zip(group, want)))

            t = x.clone()
            ptr = t.data_ptr()
            out[f"bsame_{dt}"] = _same(hvd.broadcast_(t, root_rank=1), t,
                                       ptr)
            out[f"bip_{dt}"] = bits(t)
            out[f"boop_{dt}"] = bits(hvd.broadcast(x, root_rank=1))
            t = x.clone()
            ptr = t.data_ptr()
            h = hvd.broadcast_async_(t, root_rank=1, name=f"bc.{dt}")
            out[f"basame_{dt}"] = _same(hvd.synchronize(h), t, ptr)
            out[f"baip_{dt}"] = bits(t)

            h = hvd.grouped_allgather_async([x, x2[:rank + 1]])
            for i, (a, b) in enumerate(zip(
                    hvd.synchronize(h),
                    hvd.grouped_allgather([x, x2[:rank + 1]]))):
                out[f"gag_async{i}_{dt}"] = bits(a)
                out[f"gag_sync{i}_{dt}"] = bits(b)
            h = hvd.grouped_reducescatter_async([x, x2], op=hvd.Sum)
            for i, (a, b) in enumerate(zip(
                    hvd.synchronize(h),
                    hvd.grouped_reducescatter([x, x2], op=hvd.Sum))):
                out[f"grs_async{i}_{dt}"] = bits(a)
                out[f"grs_sync{i}_{dt}"] = bits(b)

        t = get("x_f32").clone()
        h = hvd.allreduce_async_(t, name="dup")
        try:
            hvd.allreduce_async_(t.clone(), name="dup")
            out["dup"] = np.asarray("none")
        except hvd.DuplicateNameError as e:
            out["dup"] = np.asarray(type(e).__name__)
        hvd.synchronize(h)
        hvd.synchronize(hvd.grouped_allreduce_async_([t], name="dup"))
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)


def run_sbn(rank, size, store, inputs, out_path):
    """SyncBatchNorm on this rank's batch (3 or 5 images): output,
    gradients of sum(out * ct) for x, scale and bias, running stats,
    then eval mode; and, on equal batches of 4, SyncBatchNorm against
    the pmean batch_norm over the world."""
    _env(rank, size, {})
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import sync_batch_norm as sbn

    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    out = {}
    try:
        x = torch.from_numpy(inputs[f"x{rank}"].copy()).requires_grad_()
        ct = torch.from_numpy(inputs[f"ct{rank}"].copy())
        c = x.shape[-1]
        bn = hvd.SyncBatchNorm(c)
        with torch.no_grad():
            bn.scale.copy_(torch.from_numpy(inputs["scale"]))
            bn.bias.copy_(torch.from_numpy(inputs["bias"]))
        y = bn(x)
        (y * ct).sum().backward()
        out.update(out=y.detach().numpy(), dx=x.grad.numpy(),
                   dscale=bn.scale.grad.numpy(), dbias=bn.bias.grad.numpy(),
                   running_mean=bn.running_mean.numpy(),
                   running_var=bn.running_var.numpy())
        bn.eval()
        out["eval_out"] = bn(x.detach()).detach().numpy()

        xe = torch.from_numpy(inputs[f"xe{rank}"].copy()).requires_grad_()
        xp = xe.detach().clone().requires_grad_()
        bn = hvd.SyncBatchNormalization(c)
        ye = bn(xe)
        cte = torch.from_numpy(inputs[f"cte{rank}"].copy())
        (ye * cte).sum().backward()
        yp, (m, v) = sbn.batch_norm(xp, bn.scale.detach(), bn.bias.detach(),
                                    torch.zeros(c), torch.ones(c), True,
                                    group=dist.group.WORLD)
        (yp * cte).sum().backward()
        out.update(eq_sync=ye.detach().numpy(), eq_pmean=yp.detach().numpy(),
                   eq_dx_sync=xe.grad.numpy(), eq_dx_pmean=xp.grad.numpy(),
                   eq_rm_sync=bn.running_mean.numpy(), eq_rm_pmean=m.numpy(),
                   eq_rv_sync=bn.running_var.numpy(), eq_rv_pmean=v.numpy())
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)
