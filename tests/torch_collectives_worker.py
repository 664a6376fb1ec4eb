"""Worker for tests/test_torch_collectives.py and
tests/test_torch_process_sets.py: one rank of a 4-rank gloo world that
runs the eager collectives, process sets and the hierarchical split.

Imports torch and horovod_tpu_torch only. Started with the `spawn`
method; its inputs arrive as numpy arrays (bf16 as uint16 bit patterns
under a "bf16:" key prefix), and it writes every result to `out_path`
as an .npz file (bf16 as bit patterns again, errors as their class
name under an "err:" key).
"""

import os

import numpy as np

OPS = ("MIN", "MAX", "PRODUCT", "ADASUM")
DTYPES = ("f32", "bf16", "i32")
# One alltoall splits row per rank: zeros included, and dim 0 (the row
# sum) differs per rank.
A2A_SPLITS = [[0, 1, 2, 1], [2, 0, 1, 1], [1, 1, 0, 2], [3, 0, 0, 1]]
AG_ROWS = [1, 3, 0, 2]  # allgather's dim 0 per rank


def _env(rank, size, extra):
    os.environ.update({"HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(size),
                       "HOROVOD_LOCAL_RANK": str(rank),
                       "HOROVOD_LOCAL_SIZE": str(size),
                       "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1",
                       **extra})


def _io(inputs, rank):
    import torch

    def get(key):
        if "bf16:" + key in inputs:
            bits = inputs["bf16:" + key][rank].view(np.int16)
            return torch.from_numpy(bits.copy()).view(torch.bfloat16)
        return torch.from_numpy(inputs[key][rank].copy())

    def bits(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return get, bits


def _err(out, key, fn):
    """Record the class name of what `fn` raised (or "none")."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - recorded, the test checks it
        out["err:" + key] = np.asarray(type(e).__name__)
        return
    out["err:" + key] = np.asarray("none")


def run_flat(rank, size, store, inputs, out_path):
    """Every op and case of the flat world (HOROVOD_DYNAMIC_PROCESS_SETS=1)."""
    _env(rank, size, {"HOROVOD_DYNAMIC_PROCESS_SETS": "1"})
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import topology

    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    get, bits = _io(inputs, rank)
    cfg = topology.config()
    out = {}
    try:
        for dt in DTYPES:
            x, x2 = get(f"red_{dt}"), get(f"red2_{dt}")
            for op in OPS:
                out[f"{op}_{dt}"] = bits(hvd.allreduce(x, op=op))
                g = hvd.grouped_allreduce([x, x2], op=op)
                out[f"grouped_{op}_{dt}"] = bits(g[0])
                out[f"grouped2_{op}_{dt}"] = bits(g[1])
            out[f"SUM_{dt}"] = bits(hvd.allreduce(x, op=hvd.Sum))
            out[f"AVERAGE_{dt}"] = bits(hvd.allreduce(x))
            out[f"bucketed_MAX_{dt}"] = bits(
                hvd.bucketed_allreduce([x2, x], op=hvd.Max)[1])
        x = get("red_f32")
        out["MIN_scaled"] = bits(hvd.allreduce(x, op=hvd.Min,
                                               prescale_factor=2.0,
                                               postscale_factor=0.5))
        sets = {"s012": hvd.add_process_set([0, 1, 2]),
                "s02": hvd.add_process_set([0, 2])}
        for halving in (False, True):
            cfg.adasum_halving = halving
            tag = "H" if halving else ""
            for dt in DTYPES:
                out[f"ADASUM{tag}_{dt}"] = bits(
                    hvd.allreduce(get(f"red_{dt}"), op=hvd.Adasum))
            for sname, ps in sets.items():
                if ps.included():
                    for dt in ("f32", "bf16"):
                        out[f"ADASUM{tag}_{sname}_{dt}"] = bits(
                            hvd.allreduce(get(f"red_{dt}"), op=hvd.Adasum,
                                          process_set=ps))
        cfg.adasum_halving = False
        if sets["s02"].included():
            out["SUM_s02"] = bits(hvd.allreduce(get("red_f32"), op=hvd.Sum,
                                                process_set=sets["s02"]))
            out["bcast_s02"] = bits(hvd.broadcast(
                get("red_f32"), root_rank=2, process_set=sets["s02"]))
        else:
            _err(out, "outside_set", lambda: hvd.allreduce(
                get("red_f32"), process_set=sets["s02"]))

        for dt in ("f32", "i32"):
            out[f"ag_{dt}"] = bits(hvd.allgather(get(f"ag_{dt}")))
        a, b = hvd.grouped_allgather([get("ag_f32"), get("ag2_f32")])
        out["gag_0"], out["gag_1"] = bits(a), bits(b)
        out["ag_even"] = bits(hvd.allgather(get("red_f32")))

        for key in ("rs_even", "rs_uneven"):
            for dt in DTYPES:
                for op in ("SUM", "AVERAGE"):
                    out[f"{key}_{op}_{dt}"] = bits(hvd.reducescatter(
                        get(f"{key}_{dt}"), op=op))
        out["rs_scaled"] = bits(hvd.reducescatter(
            get("rs_uneven_f32"), op=hvd.Sum, prescale_factor=0.5,
            postscale_factor=3.0))
        gr = hvd.grouped_reducescatter(
            [get("rs_even_f32"), get("rs_uneven_i32")], op=hvd.Sum)
        out["grs_0"], out["grs_1"] = bits(gr[0]), bits(gr[1])
        _err(out, "rs_min", lambda: hvd.reducescatter(get("rs_even_f32"),
                                                      op=hvd.Min))

        y, recv = hvd.alltoall(get("a2a_f32"), splits=A2A_SPLITS[rank])
        out["a2a"], out["a2a_recv"] = bits(y), recv.numpy()
        y, recv = hvd.alltoall(get("rs_even_f32"))
        out["a2a_even"], out["a2a_even_recv"] = bits(y), recv.numpy()
        _err(out, "a2a_indivisible",
             lambda: hvd.alltoall(get("red_f32")[:3]))

        h = hvd.allreduce_async(get("red_f32"), name="grad")
        _err(out, "dup_async", lambda: hvd.allreduce_async(
            get("red_f32"), name="grad"))
        _err(out, "dup_sync", lambda: hvd.allgather(get("ag_f32"),
                                                    name="grad"))
        out["named_async"] = bits(hvd.synchronize(h))
        _err(out, "reuse_after_sync", lambda: hvd.allreduce(
            get("red_f32"), name="grad"))
        handles = [hvd.allgather_async(get("ag_f32"), name="ag"),
                   hvd.reducescatter_async(get("rs_even_f32"), op=hvd.Sum),
                   hvd.alltoall_async(get("rs_even_f32")),
                   hvd.broadcast_async(get("red_f32"), root_rank=1),
                   hvd.grouped_allreduce_async([get("red_f32")], op=hvd.Max),
                   hvd.bucketed_allreduce_async([get("red_i32")],
                                                op=hvd.Sum)]
        res = [hvd.synchronize(h) for h in handles]
        out["async_ag"], out["async_rs"] = bits(res[0]), bits(res[1])
        out["async_a2a"], out["async_bcast"] = bits(res[2][0]), bits(res[3])
        out["async_grouped"] = bits(res[4][0])
        out["async_bucketed"] = bits(res[5][0])
        if sets["s012"].included():
            hvd.barrier(process_set=sets["s012"])
        hvd.barrier()
        from horovod_tpu_torch import collective_bench
        out["bench_check"] = np.asarray(sorted(collective_bench.check(n=64)))
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)


def run_hier(rank, size, store, inputs, out_path):
    """Hierarchical allreduce and allgather under a 2x2 split, then the
    same calls flat (the mode switched off in the config)."""
    _env(rank, size, {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                      "HOROVOD_HIERARCHICAL_ALLGATHER": "1",
                      "HOROVOD_TPU_MESH_SHAPE": "2x2"})
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import topology

    torch.set_num_threads(1)
    hvd.init(device="cpu", init_method=f"file://{store}")
    get, bits = _io(inputs, rank)
    cfg = topology.config()
    h = topology.hier()
    out = {"split": np.asarray([h.n_cross, h.n_local]),
           "cross": np.asarray([hvd.cross_rank(), hvd.cross_size(),
                                int(hvd.is_homogeneous())])}
    try:
        for mode in ("hier", "flat"):
            cfg.hierarchical_allreduce = cfg.hierarchical_allgather = \
                mode == "hier"
            for dt in DTYPES:
                x = get(f"h_{dt}")
                out[f"{mode}_SUM_{dt}"] = bits(hvd.allreduce(x, op=hvd.Sum))
                out[f"{mode}_AVERAGE_{dt}"] = bits(hvd.allreduce(x))
                out[f"{mode}_MIN_{dt}"] = bits(hvd.allreduce(x, op=hvd.Min))
                out[f"{mode}_MAX_{dt}"] = bits(hvd.allreduce(x, op=hvd.Max))
            g = hvd.grouped_allreduce([get("h_f32"), get("h2_f32")],
                                      op=hvd.Sum)
            out[f"{mode}_grouped_0"], out[f"{mode}_grouped_1"] = \
                bits(g[0]), bits(g[1])
            out[f"{mode}_scaled"] = bits(hvd.allreduce(
                get("h_f32"), prescale_factor=0.5, postscale_factor=3.0))
            out[f"{mode}_ag"] = bits(hvd.allgather(get("hag_f32")))
            out[f"{mode}_ag_uneven"] = bits(hvd.allgather(get("ag_f32")))
        from horovod_tpu_torch import collective_bench
        out["bench_check"] = np.asarray(sorted(collective_bench.check(n=64)))
        b = collective_bench.bench(values=4096, iters=2)
        out["bench_ops"] = np.asarray(sorted(
            name for name, v in b.items() if isinstance(v, dict)))
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)


def run_sets(rank, size, store, inputs, out_path):
    """The process-set table: sets given to init, the dynamic gate, then
    a sequence of adds and removes with every outcome recorded."""
    _env(rank, size, {})
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import topology

    torch.set_num_threads(1)
    early = [hvd.ProcessSet([0, 1]), hvd.ProcessSet([3, 2])]
    hvd.init(device="cpu", init_method=f"file://{store}",
             process_sets=early)
    get, bits = _io(inputs, rank)
    out = {"init_ids": np.asarray([ps.process_set_id for ps in early])}
    try:
        _err(out, "gate_add", lambda: hvd.add_process_set([0, 2]))
        _err(out, "gate_remove", lambda: hvd.remove_process_set(early[0]))
        mine = early[0] if rank < 2 else early[1]
        out["init_sum"] = bits(hvd.allreduce(get("x"), op=hvd.Sum,
                                             process_set=mine))
        other = early[1] if rank < 2 else early[0]
        _err(out, "outside", lambda: hvd.allreduce(get("x"),
                                                   process_set=other))
        _err(out, "outside_bcast_root", lambda: hvd.broadcast(
            get("x"), root_rank=3 if rank < 2 else 0, process_set=mine))
        topology.config().dynamic_process_sets = True
        ids = []
        a = hvd.add_process_set([0, 1, 2, 3])
        ids.append(a.process_set_id)
        ids.append(hvd.add_process_set([3, 2, 1, 0]).process_set_id)
        b = hvd.add_process_set([1, 3])
        ids.append(b.process_set_id)
        out["size_index"] = np.asarray([a.size(), a.rank_index(2),
                                        b.rank_index(3)])
        hvd.remove_process_set(a)
        c = hvd.add_process_set([0, 2])
        ids.append(c.process_set_id)
        hvd.remove_process_set(b)
        hvd.remove_process_set(early[0])
        d = hvd.add_process_set([2, 1, 1])
        ids.append(d.process_set_id)
        e = hvd.add_process_set([0, 1, 3])
        ids.append(e.process_set_id)
        out["ids"] = np.asarray(ids)
        out["table"] = np.asarray(topology._require().process_set_table.ids())
        out["d_ranks"] = np.asarray(d.ranks)
        _err(out, "out_of_range", lambda: hvd.add_process_set([0, 5]))
        _err(out, "remove_global",
             lambda: hvd.remove_process_set(hvd.global_process_set))
        _err(out, "get_unknown", lambda: hvd.get_process_set(99))
        _err(out, "removed_set", lambda: hvd.allreduce(get("x"),
                                                       process_set=a))
        _err(out, "axis", lambda: hvd.axis_process_set("dp"))
        out["get_c"] = np.asarray(hvd.get_process_set(
            c.process_set_id).ranks)
        if e.included():
            out["e_sum"] = bits(hvd.allreduce(get("x"), op=hvd.Sum,
                                              process_set=e))
            out["e_ag"] = bits(hvd.allgather(get("x"), process_set=e))
        hvd.barrier()
    finally:
        hvd.shutdown()
    np.savez(out_path, **out)


def spawn(target, tmp_path, inputs, k=4, timeout=180):
    """Run `target` (one of the run_* above) on k spawned ranks; each
    rank's results, in rank order. Workers join with a bound and are
    killed past it."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(k)]
    procs = [ctx.Process(target=target,
                         args=(r, k, store, inputs, outs[r]))
             for r in range(k)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * k
    return [dict(np.load(o)) for o in outs]
