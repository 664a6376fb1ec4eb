"""Check and time the eager collectives over a world of N ranks.

    python -m horovod_tpu_torch.collective_bench --np 4 [--device cpu]
        [--values 25557032] [--iters 10] [--no-check] [--no-bench]

Starts N workers through `runner.run` (one GPU each over NCCL, or gloo
on the host with `--device cpu`). `check` holds every op of
ops/collectives.py against numpy on inputs that each rank rebuilds from
a seed for every rank: Min, Max, Product, Sum, Average and Adasum (with
and without HOROVOD_ADASUM_HALVING) in float32, bf16 and int32, over the
world and over the sets {0, 2} and {0, 1, 2} (where the world has
them); uneven allgather, reducescatter and alltoall; broadcast; and,
where hierarchical mode's groups exist, the hierarchical allreduce and
allgather against the same numpy results. `bench` times the flat
allreduce, the hierarchical one (where its groups exist), allgather and
alltoall on `values` bf16 elements (default ResNet-50's 25,557,032
gradient values) and reports each as device ms (CUDA events around
`iters` calls, the slowest rank's) and bus GB/s with the NCCL tests'
factors: 2(k-1)/k for allreduce, (k-1)/k for allgather (on the gathered
size) and alltoall (on what one rank sends), beside the time of the one
torch.distributed call that moves the same bytes (`library_ms`) and of
allgather's size exchange. Prints one JSON object.
Hierarchical mode is taken from the environment
(HOROVOD_HIERARCHICAL_ALLREDUCE/_ALLGATHER, HOROVOD_TPU_MESH_SHAPE).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.ops import adasum

RESNET50_GRAD_VALUES = 25_557_032
# Tolerances, each of the largest magnitude of the numpy result: sums of
# k float32 rows in another order (1e-6 of Σ|x_r|), of bf16 rows (three
# roundings of half a bf16 step, 3·2^-8 of Σ|x_r|); Adasum against the
# float64 oracle (float32 1e-5; bf16 rounds at each of up to three
# levels, 2^-5).
TOL = {"sum_f32": 1e-6, "sum_bf16": 3 * 2.0 ** -8,
       "adasum_f32": 1e-5, "adasum_bf16": 2.0 ** -5}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}


def _rank_input(r: int, dt: str, shape, seed: int = 0) -> torch.Tensor:
    """Rank r's input, built on the host from (seed, r): every rank can
    build every rank's."""
    g = torch.Generator().manual_seed(1000 * seed + r)
    if dt == "i32":
        return torch.randint(-3, 4, shape, generator=g, dtype=torch.int32)
    return torch.randn(shape, generator=g).to(DTYPES[dt])


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def _same(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    got = got.cpu()
    if got.dtype != want.dtype or got.shape != want.shape or \
            not torch.equal(got, want):
        raise AssertionError(f"{name}: differs from numpy "
                             f"({got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)})")
    return 0.0


def _near(name: str, got: torch.Tensor, want: np.ndarray, tol: float,
          scale: float) -> float:
    err = float(np.max(np.abs(_f64(got) - want))) if want.size else 0.0
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max |error| {err:.3g} above "
                             f"{tol:.3g} x {scale:.3g}")
    return err


def _product(rows: List[torch.Tensor]) -> torch.Tensor:
    """Rows multiplied in rank order with numpy, bf16 in float32."""
    dt = rows[0].dtype
    wide = np.float32 if dt in (torch.bfloat16, torch.float32) else None
    acc = rows[0].float().numpy() if wide else rows[0].numpy()
    for r in rows[1:]:
        acc = acc * (r.float().numpy() if wide else r.numpy())
    return torch.from_numpy(np.asarray(acc)).to(dt)


def check(dev: Optional[torch.device] = None, n: int = 1000) -> Dict:
    """Every op against numpy on this world; raises AssertionError at the
    first disagreement. Returns {case: max |error|}."""
    dev = dev or hvd.device()
    k, me = hvd.size(), hvd.rank()
    cfg = topology.config()
    errs: Dict[str, float] = {}

    def rows(dt, shape, seed=0, members=None):
        return [_rank_input(r, dt, shape, seed)
                for r in (members if members is not None else range(k))]

    def mine(dt, shape, seed=0):
        return _rank_input(me, dt, shape, seed).to(dev)

    shape = (n // 4, 4)
    for dt in DTYPES:
        xs, x = rows(dt, shape), mine(dt, shape)
        st = torch.stack(xs)
        errs[f"min_{dt}"] = _same(
            f"min {dt}", hvd.allreduce(x, op=hvd.Min, name="check.min"),
            st.min(0).values)
        errs[f"max_{dt}"] = _same(
            f"max {dt}",
            hvd.grouped_allreduce([x, x], op=hvd.Max, name="check.max")[1],
            st.max(0).values)
        errs[f"product_{dt}"] = _same(
            f"product {dt}",
            hvd.allreduce(x, op=hvd.Product, name="check.product"),
            _product(xs))
        if dt == "i32":
            errs["sum_i32"] = _same(
                "sum i32", hvd.allreduce(x, op=hvd.Sum, name="check.sum_i32"),
                st.sum(0).to(torch.int32))
            errs["avg_i32"] = _same(
                "average i32", hvd.allreduce(x, name="check.avg_i32"),
                torch.div(st.sum(0), k, rounding_mode="floor").to(
                    torch.int32))
            continue
        ref = _f64(st).sum(0)
        scale = np.abs(_f64(st)).sum(0).max()
        errs[f"sum_{dt}"] = _near(
            f"sum {dt}", hvd.allreduce(x, op=hvd.Sum, name="check.sum"),
            ref, TOL[f"sum_{dt}"], scale)
        errs[f"avg_{dt}"] = _near(
            f"average {dt}", hvd.allreduce(x, name="check.avg"), ref / k,
            TOL[f"sum_{dt}"], scale)
        oracle = adasum.adasum_numpy_reference([_f64(t) for t in xs])
        for halving in (False, True):
            cfg.adasum_halving = halving
            tag = "_halving" if halving else ""
            errs[f"adasum{tag}_{dt}"] = _near(
                f"adasum{tag} {dt}",
                hvd.allreduce(x, op=hvd.Adasum, name="check.adasum"),
                oracle, TOL[f"adasum_{dt}"], np.abs(oracle).max())
        cfg.adasum_halving = False

    if k >= 3:
        dyn = cfg.dynamic_process_sets
        cfg.dynamic_process_sets = True
        for members in ([0, 2], [0, 1, 2]):
            ps = hvd.add_process_set(members)
            tag = "".join(map(str, members))
            if ps.included():
                xs = rows("f32", shape, members=members)
                x = mine("f32", shape)
                oracle = adasum.adasum_numpy_reference(
                    [_f64(t) for t in xs])
                errs[f"adasum_set{tag}"] = _near(
                    f"adasum over {members}",
                    hvd.allreduce(x, op=hvd.Adasum, name="check.adasum_set",
                                  process_set=ps), oracle,
                    TOL["adasum_f32"], np.abs(oracle).max())
                st = _f64(torch.stack(xs))
                errs[f"sum_set{tag}"] = _near(
                    f"sum over {members}",
                    hvd.allreduce(x, op=hvd.Sum, name="check.sum_set",
                                  process_set=ps), st.sum(0),
                    TOL["sum_f32"], np.abs(st).sum(0).max())
                root = members[-1]
                errs[f"broadcast_set{tag}"] = _same(
                    f"broadcast over {members}",
                    hvd.broadcast(x, root, name="check.broadcast_set",
                                  process_set=ps), xs[-1])
            hvd.remove_process_set(ps)
        cfg.dynamic_process_sets = dyn

    sizes = [(1, 3, 0, 2)[r % 4] for r in range(k)]
    ag = [_rank_input(r, "f32", (sizes[r], 3), 1) for r in range(k)]
    errs["allgather_uneven"] = _same(
        "uneven allgather", hvd.allgather(ag[me].to(dev)), torch.cat(ag))
    d0 = 2 * k + 1  # uneven: rank i gets d0 // k + (i < d0 % k) rows
    xs = rows("f32", (d0, 3), 2)
    st = _f64(torch.stack(xs))
    cut = [d0 // k + (1 if i < d0 % k else 0) for i in range(k)]
    lo = sum(cut[:me])
    for op, div in (("SUM", 1), ("AVERAGE", k)):
        errs[f"reducescatter_{op.lower()}"] = _near(
            f"reducescatter {op}",
            hvd.reducescatter(mine("f32", (d0, 3), 2), op=op,
                              name="check.reducescatter"),
            st.sum(0)[lo:lo + cut[me]] / div, TOL["sum_f32"],
            np.abs(st).sum(0).max())
    splits = [[(i + 2 * j) % 3 for j in range(k)] for i in range(k)]
    a2a = [_rank_input(r, "f32", (sum(splits[r]), 2), 3) for r in range(k)]
    want = torch.cat([a2a[i][sum(splits[i][:me]):
                             sum(splits[i][:me + 1])] for i in range(k)])
    out, recv = hvd.alltoall(a2a[me].to(dev), splits=splits[me])
    errs["alltoall_splits"] = _same("alltoall", out, want)
    if recv.tolist() != [splits[i][me] for i in range(k)]:
        raise AssertionError(f"alltoall received splits {recv.tolist()}")

    if topology.hier() is not None:
        flags = (cfg.hierarchical_allreduce, cfg.hierarchical_allgather)
        cfg.hierarchical_allreduce = cfg.hierarchical_allgather = True
        m = 2 * n + 1  # not a multiple of any local size above 1
        for dt in ("f32", "bf16"):
            xs = rows(dt, (m,), 4)
            st = _f64(torch.stack(xs))
            scale = np.abs(st).sum(0).max()
            x = mine(dt, (m,), 4)
            hier = hvd.allreduce(x, op=hvd.Sum, name="check.hier_sum")
            cfg.hierarchical_allreduce = False
            flat = hvd.allreduce(x, op=hvd.Sum, name="check.flat_sum")
            cfg.hierarchical_allreduce = True
            errs[f"hier_sum_{dt}"] = _near(f"hierarchical sum {dt}", hier,
                                           st.sum(0), TOL[f"sum_{dt}"],
                                           scale)
            errs[f"hier_vs_flat_{dt}"] = _near(
                f"hierarchical vs flat {dt}", hier, _f64(flat),
                2 * TOL[f"sum_{dt}"], scale)
            errs[f"hier_avg_{dt}"] = _near(
                f"hierarchical average {dt}",
                hvd.allreduce(x, name="check.hier_avg"),
                st.sum(0) / k, TOL[f"sum_{dt}"], scale)
        xs = rows("i32", (m,), 4)
        errs["hier_sum_i32"] = _same(
            "hierarchical sum i32", hvd.allreduce(mine("i32", (m,), 4),
                                                  op=hvd.Sum),
            torch.stack(xs).sum(0).to(torch.int32))
        even = rows("f32", (3, 2), 5)
        errs["hier_allgather"] = _same(
            "hierarchical allgather", hvd.allgather(mine("f32", (3, 2), 5)),
            torch.cat(even))
        cfg.hierarchical_allreduce, cfg.hierarchical_allgather = flags
    hvd.barrier()
    return errs


def _timed(fn, iters: int) -> float:
    """Mean ms of fn() over `iters` back-to-back calls, CUDA events on
    the card (host clock on the CPU), after 3 warm-up calls and a
    barrier."""
    for _ in range(3):
        fn()
    hvd.barrier()
    if hvd.device().type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def bench(values: int = RESNET50_GRAD_VALUES, iters: int = 10) -> Dict:
    """ms and bus GB/s of the flat and hierarchical allreduce, allgather
    and alltoall on `values` bf16 elements, this rank's view. Beside
    each API call, `library_ms`: the one torch.distributed call that
    moves the same bytes on buffers allocated beforehand (none for the
    hierarchical allreduce, which is three); and `size_exchange`, the
    dim-0 exchange that allgather runs before its gather."""
    import torch.distributed as dist
    from horovod_tpu_torch.core.process_sets import global_process_set
    from horovod_tpu_torch.ops import collectives as C
    dev = hvd.device()
    k = hvd.size()
    cfg = topology.config()
    flags = (cfg.hierarchical_allreduce, cfg.hierarchical_allgather)
    x = torch.randn(values, device=dev).to(torch.bfloat16)
    per = values // k
    part = x[:per].contiguous()
    a2a = x[:per * k].contiguous()
    buf, gathered, swapped = (torch.zeros_like(x), torch.empty_like(a2a),
                              torch.empty_like(a2a))
    nbytes = 2 * values
    cases = {"allreduce_flat": (lambda: hvd.allreduce(x, op=hvd.Sum),
                                lambda: dist.all_reduce(buf),
                                nbytes, 2 * (k - 1) / k, False)}
    if topology.hier() is not None:
        cases["allreduce_hier"] = (lambda: hvd.allreduce(x, op=hvd.Sum),
                                   None, nbytes, 2 * (k - 1) / k, True)
    cases["allgather"] = (lambda: hvd.allgather(part),
                          lambda: C._all_gather_single(gathered, part),
                          2 * per * k, (k - 1) / k, False)
    cases["alltoall"] = (lambda: hvd.alltoall(a2a),
                         lambda: dist.all_to_all_single(swapped, a2a),
                         2 * per * k, (k - 1) / k, False)
    out = {"k": k, "values": values, "dtype": "bfloat16", "iters": iters}
    for name, (fn, lib, size, factor, hier) in cases.items():
        cfg.hierarchical_allreduce = cfg.hierarchical_allgather = hier
        ms = _timed(fn, iters)
        out[name] = {"ms": ms, "bytes": size,
                     "bus_gb_s": size / (ms * 1e-3) * factor / 1e9,
                     "library_ms": None if lib is None else
                     _timed(lib, iters)}
    cfg.hierarchical_allreduce, cfg.hierarchical_allgather = flags
    out["size_exchange_ms"] = _timed(
        lambda: C._exchange_rows([per], global_process_set), iters)
    return out


def worker(device: Optional[str] = None, run_check: bool = True,
           run_bench: bool = True, values: int = RESNET50_GRAD_VALUES,
           iters: int = 10) -> Dict:
    """One rank under runner.run: join the world, check, time, leave."""
    os.environ.setdefault("HOROVOD_DYNAMIC_PROCESS_SETS", "1")
    if device == "cpu":
        torch.set_num_threads(1)  # the N ranks share the host's cores
    hvd.init(device=device)
    try:
        res = {"rank": hvd.rank(), "size": hvd.size(),
               "device": (torch.cuda.get_device_name(hvd.device())
                          if hvd.device().type == "cuda" else "cpu"),
               "hier": (None if topology.hier() is None else
                        [topology.hier().n_cross, topology.hier().n_local])}
        if run_check:
            res["check"] = check()
        if run_bench:
            res["bench"] = bench(values, iters)
        return res
    finally:
        hvd.shutdown()


def summarize(per_rank: List[Dict]) -> Dict:
    """The slowest rank's time of each op, and its bus GB/s."""
    out = {k: per_rank[0][k] for k in ("size", "device", "hier")}
    if "check" in per_rank[0]:
        out["check_max_err"] = {c: max(r["check"][c] for r in per_rank
                                       if c in r["check"])
                                for c in per_rank[0]["check"]}
    if "bench" in per_rank[0]:
        b0 = per_rank[0]["bench"]
        out["bench"] = {k: b0[k] for k in ("k", "values", "dtype", "iters")}
        out["bench"]["size_exchange_ms"] = max(
            r["bench"]["size_exchange_ms"] for r in per_rank)
        for name in b0:
            if isinstance(b0[name], dict):
                ms = max(r["bench"][name]["ms"] for r in per_rank)
                factor = b0[name]["bus_gb_s"] * b0[name]["ms"]
                lib = None if b0[name]["library_ms"] is None else max(
                    r["bench"][name]["library_ms"] for r in per_rank)
                out["bench"][name] = {"ms": ms, "bus_gb_s": factor / ms,
                                      "library_ms": lib}
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--np", type=int, default=1)
    p.add_argument("--device", choices=["cpu"], default=None)
    p.add_argument("--values", type=int, default=RESNET50_GRAD_VALUES)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--no-bench", action="store_true")
    p.add_argument("--timeout", type=float, default=600)
    args = p.parse_args(argv)
    from horovod_tpu_torch import runner
    if args.device is None:
        have = torch.cuda.device_count()
        if args.np > have:
            raise SystemExit(f"--np {args.np} needs {args.np} GPUs, have "
                             f"{have} visible")
    # By its import path, not as __main__'s: pickled by reference.
    from horovod_tpu_torch.collective_bench import worker as by_path
    fn = functools.partial(by_path, args.device, not args.no_check,
                           not args.no_bench, args.values, args.iters)
    print(json.dumps(summarize(runner.run(fn, np=args.np,
                                          timeout=args.timeout))))


if __name__ == "__main__":
    main()
