"""Ranks of the spawned gloo worlds of tests/test_torch_hvdprog.py: each
records its programs (horovod_tpu_torch/analysis/graph.py) and pickles
them to `<out>/<name>.rank<r>.pkl`. Imports no JAX.

* `schedule_programs`, a world of 4: "skip" (rank 1 skips the first of
  two equal all-reduces over ranks {0, 1}, which therefore pairs with
  rank 0's second: the programs diverge and nothing hangs; rank 0 exits
  without waiting for its unpaired one), "ring" (the port's ring shift,
  parallel/comm.py, over all four), "mean" and "baked" (an all-reduce
  over the pairs {0, 1} / {2, 3} divided by the group's size, 2, or by
  the world's, 4);
* `sharded_programs`, a world of 4 at HOROVOD_MESH="dp=2,tp=2": the tied
  LM's lm_sharded and lm_runtime steps, as declared and replicated.
"""

import os
import pickle


def _join(rank: int, world: int, store: str, mesh: str = "",
          process_sets=None) -> None:
    os.environ.update({"HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(world),
                       "HOROVOD_LOCAL_RANK": str(rank),
                       "HOROVOD_LOCAL_SIZE": str(world)})
    if mesh:
        os.environ["HOROVOD_MESH"] = mesh
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", init_method=f"file://{store}",
             process_sets=process_sets)


def _dump(out: str, name: str, rank: int, prog) -> None:
    with open(os.path.join(out, f"{name}.rank{rank}.pkl"), "wb") as fh:
        pickle.dump(prog, fh)


def schedule_programs(rank: int, world: int, store: str, out: str) -> None:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import graph
    from horovod_tpu_torch.parallel.comm import ring_shift

    pairs = [hvd.ProcessSet([0, 1]), hvd.ProcessSet([2, 3])]
    _join(rank, world, store, process_sets=pairs)
    mine = pairs[rank // 2]
    a = torch.ones(256 * 1024)
    b = torch.full((256 * 1024,), 2.0)

    def ring():
        return ring_shift(torch.full((1024,), float(rank)),
                          hvd.global_process_set)

    def mean(divisor):
        def step():
            s = hvd.allreduce(a, op=hvd.Sum, process_set=mine)
            return s / divisor
        return step

    for name, fn in (("ring", ring), ("mean", mean(2)), ("baked", mean(4))):
        _, prog = graph.record(fn, path=f"<{name}:rank{rank}>")
        _dump(out, name, rank, prog)

    if rank in (0, 1):
        def skip():
            if rank == 0:
                h = hvd.allreduce_async(a, op=hvd.Sum, process_set=pairs[0])
                hvd.allreduce_async(b, op=hvd.Sum, process_set=pairs[0])
                return hvd.synchronize(h)
            return hvd.allreduce(b, op=hvd.Sum, process_set=pairs[0])

        _, prog = graph.record(skip, path=f"<skip:rank{rank}>")
        _dump(out, "skip", rank, prog)
    # rank 0's second all-reduce never pairs, so no rank shuts down (a
    # shutdown would wait for it): each leaves once its files are out
    os._exit(0)


def sharded_programs(rank: int, world: int, store: str, out: str) -> None:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import shard

    _join(rank, world, store, mesh=shard.SHARDED_MESH)
    for kind in ("lm_sharded", "lm_runtime"):
        for replicated in (False, True):
            prog = shard.record_rank_program(kind, replicated)
            _dump(out, f"{kind}.{int(replicated)}", rank, prog)
    hvd.shutdown()
