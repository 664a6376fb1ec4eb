"""Disk checkpoints with rank-0 semantics, and the elastic state's disk
anchor (counterpart of horovod_tpu/checkpoint.py).

Rank 0 writes, a barrier makes the save visible before anyone goes on,
and every rank can read. Where the JAX package writes through orbax,
the port writes one ``torch.save`` file, ``<path>/tree.pt``, and then
the same commit marker ``<path>.done`` (ckpt/manifest.py), strictly
after the file is durable. ``restore_params`` requires the marker.

    from horovod_tpu_torch import checkpoint as ckpt

    ckpt.save("/tmp/run/step_1000", {"params": model.state_dict(),
                                      "opt": opt.state_dict()})
    params = ckpt.restore_params("/tmp/run/step_1000")

    # Elastic anchor: commits and hits disk every N batches.
    cb = ckpt.CheckpointCallback("/tmp/run", state, every_n=100)

The file is a pickle: load only checkpoints this program wrote.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from horovod_tpu_torch.common import config as _config
from horovod_tpu_torch.common.exceptions import CheckpointCorruptError
from horovod_tpu_torch.core import topology
from horovod_tpu_torch.ckpt import manifest as _mf
from horovod_tpu_torch.optim.callbacks import Callback as _Callback

TREE_FILE = "tree.pt"


def _peer_env() -> bool:
    """True when the launcher env says this process has PEERS
    (HOROVOD_SIZE > 1, or a nonzero HOROVOD_RANK): the uninitialized
    `save` leniency must not extend to a multi-process job, where N
    uninitialized workers would race the same path barrier-free."""
    try:
        if int(os.environ.get(_config.HOROVOD_SIZE, "1") or "1") > 1:
            return True
        if int(os.environ.get(_config.HOROVOD_RANK, "0") or "0") > 0:
            return True
    except ValueError:
        return True  # unparseable peer env: refuse rather than race
    return False


def _host(tree: Any) -> Any:
    """`tree` with every tensor detached to host memory."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((k, _host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        out = [_host(v) for v in tree]
        return out if isinstance(tree, list) else type(tree)(out)
    return tree


def save(path: str, tree: Any, *, all_ranks_barrier: bool = True) -> None:
    """Write a checkpoint from rank 0 (the reference's rank-0-only
    saves); the other ranks wait at a barrier so the checkpoint is
    durable before anyone races ahead.

    An uninitialized process acts as rank 0 and skips the barrier
    (single-process tools), but only when it is genuinely solo: a worker
    spawned by a multi-process launcher (HOROVOD_RANK/HOROVOD_SIZE in
    the env) that saves before `hvd.init()` fails fast, since N
    uninitialized peers would all write `path` with no barrier."""
    rank = topology.rank_or_none()
    if rank is None and _peer_env():
        raise RuntimeError(
            "checkpoint.save() called before hvd.init() in a "
            f"multi-process job ({_config.HOROVOD_RANK}="
            f"{os.environ.get(_config.HOROVOD_RANK)!r}, "
            f"{_config.HOROVOD_SIZE}="
            f"{os.environ.get(_config.HOROVOD_SIZE)!r}): every peer "
            "would race the same checkpoint path with no barrier. "
            "Call hvd.init() first.")
    if rank is None or rank == 0:
        apath = os.path.abspath(path)
        os.makedirs(apath, exist_ok=True)
        target = os.path.join(apath, TREE_FILE)
        tmp = f"{target}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            torch.save(_host(tree), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
        # the commit marker, strictly after the payload is durable
        _mf.write_done_marker(path, extra={"format": "torch.save"})
    if all_ranks_barrier and rank is not None and topology.size() > 1:
        from horovod_tpu_torch.ops import collectives
        collectives.barrier()


def _coerce(like: Any, got: Any) -> Any:
    """`got` in `like`'s structure, numpy-scalar leaves of `like` coerced
    back to their type; a structure mismatch raises."""
    if isinstance(like, dict):
        if not isinstance(got, dict) or set(like) != set(got):
            raise ValueError(f"checkpoint structure differs from like: "
                             f"{sorted(got) if isinstance(got, dict) else type(got)} "
                             f"vs {sorted(like)}")
        return type(like)((k, _coerce(like[k], got[k])) for k in like)
    if isinstance(like, (list, tuple)):
        if len(like) != len(got):
            raise ValueError("checkpoint structure differs from like")
        out = [_coerce(a, b) for a, b in zip(like, got)]
        return out if isinstance(like, list) else type(like)(out)
    if isinstance(like, np.generic):
        return type(like)(np.asarray(got)[()])
    return got


def restore(path: str, like: Optional[Any] = None) -> Any:
    """Read a checkpoint on every rank (host tensors). With `like`, the
    structure is checked against it and numpy-scalar leaves come back
    as the same scalar type."""
    with open(os.path.join(os.path.abspath(path), TREE_FILE), "rb") as f:
        tree = torch.load(f, map_location="cpu", weights_only=False)
    return _coerce(like, tree) if like is not None else tree


def _require_marker_env() -> bool:
    return _config._env_on("HOROVOD_CKPT_REQUIRE_MARKER", True)


def restore_params(path: str, like: Optional[Any] = None,
                   key: str = "params") -> Any:
    """Load only the `key` subtree (default ``"params"``) of a training
    checkpoint; the rest (optimizer state) is never built into optimizer
    objects, so a serving replica restores weights without the
    optimizer that trained them.

    The ``<path>.done`` commit marker is verified before any read, and a
    partial or corrupt directory raises CheckpointCorruptError: a
    replica never boots from a checkpoint whose writer was killed
    mid-save. HOROVOD_CKPT_REQUIRE_MARKER=0 reads checkpoints written
    before the marker protocol."""
    apath = os.path.abspath(path)
    if _require_marker_env() and not _mf.has_done_marker(apath):
        raise CheckpointCorruptError(
            f"checkpoint {apath} has no commit marker ({apath}.done): "
            f"the writer died mid-save, or the checkpoint predates the "
            f"marker protocol (set HOROVOD_CKPT_REQUIRE_MARKER=0 to "
            f"read legacy checkpoints)")
    try:
        tree = restore(path)
    except (OSError, EOFError, RuntimeError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {apath} is committed but unreadable "
            f"(partial/corrupt directory): {type(e).__name__}: "
            f"{e}") from e
    if not isinstance(tree, dict) or key not in tree:
        have = sorted(tree) if isinstance(tree, dict) else type(tree)
        raise KeyError(
            f"checkpoint {path} has no {key!r} subtree (top-level keys: "
            f"{have}); pass key=... for checkpoints saved under a "
            f"different name")
    params = tree[key]
    return _coerce(like, params) if like is not None else params


def latest_step(root: str) -> Optional[int]:
    """Highest step_N subdirectory under `root`, or None."""
    try:
        steps = [int(d.rsplit("_", 1)[1]) for d in os.listdir(root)
                 if d.startswith("step_") and d.rsplit("_", 1)[1].isdigit()]
    except FileNotFoundError:
        return None
    return max(steps) if steps else None


def save_state(root: str, state, step: int) -> None:
    """Anchor an elastic State's COMMITTED values to disk
    (elastic/state.py): reads the last commit()'s snapshot as it is; it
    must not re-snapshot, or a mid-step anchor would write uncommitted
    values and move the in-memory rollback point."""
    tree, objects = state._ckpt_payload()
    save(os.path.join(root, f"step_{step}"),
         {"step": step, "tree": tree, "objects": objects})


def restore_state(root: str, state, step: Optional[int] = None) -> int:
    """Load a disk anchor back into an elastic State; returns the step.
    A missing root or no steps raise FileNotFoundError."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no step_N checkpoints under {root}")
    payload = restore(os.path.join(root, f"step_{step}"))
    state._ckpt_adopt(payload["tree"], payload["objects"])
    return int(payload["step"])


class CheckpointCallback(_Callback):
    """Commit and anchor to disk every N batches, as an optim/callbacks
    Callback (the disk-backed sibling of CommitStateCallback).

    Pass the GLOBAL step as the `batch` argument: the anchor is labeled
    step_<batch>, so after an elastic restart (a fresh callback) the
    anchors continue from the restored step instead of regressing to a
    local counter."""

    def __init__(self, root: str, state, every_n: int = 100):
        self.root = root
        self.state = state
        self.every_n = max(1, every_n)
        self._count = 0

    def on_batch_end(self, batch, state=None) -> None:
        self._count += 1
        if self._count % self.every_n == 0:
            step = batch if isinstance(batch, int) else self._count
            self.state.commit()
            save_state(self.root, self.state, step=step)
