"""Restore side (counterpart of horovod_tpu/ckpt/resume.py): the
newest-committed walk with quarantine fallback, the params-only load,
and the cross-rank restore signal.

``restore_latest`` walks committed generations newest-first. A
generation that fails verification (missing marker dir, unreadable
manifest, absent or truncated shard files) is QUARANTINED (moved under
``<root>/quarantine/`` with the reason) and the walk falls back to the
next older generation. Restore therefore degrades in freshness, never
in correctness.

The restore signal (``signal_restore``): a rank reading a checkpoint
can take long, while its peers already wait in the round's first
collective. While restoring, the rank heartbeats a ``ckpt/restoring``
KV key; ``peer_restore_active()`` says whether the signal is fresh,
and ``grace_max_seconds()`` bounds the grace a stall watchdog may grant
on it. The collectives' stall watchdog (ops/collectives.py) re-arms its
deadline on them; the elastic launcher clears the key at every round publication
(elastic/driver.py RoundPublisher).

Knobs: HOROVOD_CKPT_RESTORE_HEARTBEAT (seconds between beats, default
1), HOROVOD_CKPT_RESTORE_GRACE_MAX (default 600), with
HOROVOD_CKPT_KEEP, _QUEUE and _COMMIT_TIMEOUT in ckpt/async_ckpt.py and
HOROVOD_CKPT_DIR, _EVERY and _RESUME in elastic/state.py.
"""

from __future__ import annotations

import json
import os
import pickle
import threading
import time
from typing import Any, Dict, Optional

from horovod_tpu_torch.common.config import _env_float
from horovod_tpu_torch.common.exceptions import CheckpointCorruptError
from horovod_tpu_torch.ckpt import manifest as mf
from horovod_tpu_torch.ckpt import sharded
from horovod_tpu_torch.ckpt.async_ckpt import (KV_LATEST_KEY, Restored,
                                               ident_fields, kv_from_env)

HOROVOD_CKPT_RESTORE_HEARTBEAT = "HOROVOD_CKPT_RESTORE_HEARTBEAT"
HOROVOD_CKPT_RESTORE_GRACE_MAX = "HOROVOD_CKPT_RESTORE_GRACE_MAX"

KV_SCOPE = "ckpt"
KV_RESTORING_KEY = "restoring"
DEFAULT_HEARTBEAT = 1.0
#: Floor of the staleness window: a restoring signal older than
#: ``stale_seconds()`` is ignored (a dead restorer). The window scales
#: with the heartbeat (3x, this floor), so a slower heartbeat does not
#: silently disable the grace it feeds.
STALE_SECONDS = 10.0

_local_restoring = threading.Event()


def heartbeat_seconds() -> float:
    return max(0.1, _env_float(HOROVOD_CKPT_RESTORE_HEARTBEAT,
                               DEFAULT_HEARTBEAT))


def stale_seconds() -> float:
    return max(STALE_SECONDS, 3.0 * heartbeat_seconds())


def grace_max_seconds() -> float:
    return _env_float(HOROVOD_CKPT_RESTORE_GRACE_MAX, 600.0)


def latest_pointer(kv: Optional[Any] = None) -> Optional[Dict[str, Any]]:
    """The writer-published ``ckpt/latest`` pointer
    ({step, generation, root, time}), or None."""
    kv = kv or kv_from_env()
    if kv is None:
        return None
    try:
        data = kv.get(KV_SCOPE, KV_LATEST_KEY, timeout=0.0)
    except Exception:
        return None
    if not data:
        return None
    try:
        body = json.loads(data.decode())
    except ValueError:
        return None
    return body if isinstance(body, dict) else None


# --------------------------------------------------------------- restore
def restore_latest(root: str, like: Optional[Any] = None,
                   mesh: Optional[Any] = None,
                   specs: Optional[Any] = None,
                   kv: Optional[Any] = None) -> Optional[Restored]:
    """Newest committed checkpoint under `root`, with quarantine
    fallback; None when none survives. The disk read runs under the
    restore signal. Restores and quarantines are counted and recorded
    in the flight recorder (ckpt/async_ckpt.py)."""
    import time
    from horovod_tpu_torch.ckpt.async_ckpt import _mx, flight_event
    for step in mf.sweep_stale(root):
        _mx()["quarantined"].inc()
        flight_event(f"quarantine step={step} reason=stale-uncommitted")
    t0 = time.perf_counter()
    with signal_restore(kv=kv):
        for gen, step in reversed(mf.committed(root)):
            dirpath = os.path.join(root, mf.dirname_for(step))
            try:
                man = mf.read_manifest(dirpath)
                tree = sharded.restore_tree(dirpath, man.leaves, like=like)
                objects: Dict[str, Any] = {}
                if man.has_objects:
                    with open(os.path.join(dirpath, mf.OBJECTS_NAME),
                              "rb") as f:
                        objects = pickle.load(f)
            except (CheckpointCorruptError, OSError,
                    pickle.UnpicklingError, EOFError) as e:
                mf.quarantine(root, step, f"restore failed: {e}")
                _mx()["quarantined"].inc()
                flight_event(f"quarantine step={step} gen={gen} "
                             f"reason={type(e).__name__}")
                continue
            if mesh is not None and specs is not None:
                tree = sharded.reshard(tree, mesh, specs)
            dt = time.perf_counter() - t0
            _mx()["restores"].inc()
            _mx()["restore_s"].set(dt)
            flight_event(f"restore step={step} gen={gen} "
                         f"source=checkpoint seconds={dt:.3f}")
            return Restored(step=step, generation=gen, tree=tree,
                            objects=objects)
    return None


def load_params(root: str, key: str = "params",
                like: Optional[Any] = None) -> Any:
    """Params-only restore of the newest committed generation: the
    other subtrees' leaves are never read from disk. Both payload
    layouts are accepted: a bare ``{key: ...}`` tree (direct
    AsyncCheckpointer use) and the elastic states' ``{"trees": {key:
    ...}}``."""
    latest = mf.latest_committed(root)
    if latest is None:
        raise CheckpointCorruptError(
            f"no committed checkpoint under {root} (no "
            f"ckpt-*.done marker with a surviving directory)")
    gen, step = latest
    dirpath = os.path.join(root, mf.dirname_for(step))
    man = mf.read_manifest(dirpath)
    entries = None
    keypath = (key,)
    for prefix, kp in ((f"['{key}']", (key,)),
                       (f"['trees']['{key}']", ("trees", key))):
        found = [e for e in man.leaves if e.path.startswith(prefix)]
        if found:
            entries, keypath = found, kp
            break
    if not entries:
        tops = sorted({e.path.split("]")[0] + "]" for e in man.leaves})
        raise KeyError(
            f"checkpoint generation {gen} at {dirpath} has no {key!r} "
            f"subtree (top-level keys: {tops}); pass key=... for "
            f"checkpoints saved under a different name")
    if like is not None:
        wrapped = like
        for k in reversed(keypath):
            wrapped = {k: wrapped}
        out = sharded.restore_tree(dirpath, entries, like=wrapped)
    else:
        out = sharded.restore_tree(dirpath, entries)
    for k in keypath:
        out = out[k]
    return out


# -------------------------------------------------------- restore signal
class _RestoreSignal:
    """Heartbeats ``ckpt/restoring`` while a disk restore runs."""

    def __init__(self, kv: Optional[Any]) -> None:
        self._kv = kv
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.heartbeat = heartbeat_seconds()

    def _beat(self) -> None:
        body = dict(ident_fields())
        while not self._stop.is_set():
            body["ts"] = time.time()
            try:
                self._kv.put(KV_SCOPE, KV_RESTORING_KEY,
                             json.dumps(body).encode())
            except Exception:
                pass
            self._stop.wait(self.heartbeat)

    def __enter__(self):
        _local_restoring.set()
        if self._kv is None:
            self._kv = kv_from_env()
        if self._kv is not None:
            self._thread = threading.Thread(
                target=self._beat, name="hvd-ckpt-restore-signal",
                daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._kv is not None:
            try:
                body = dict(ident_fields())
                body["ts"] = 0.0  # done: explicitly stale
                self._kv.put(KV_SCOPE, KV_RESTORING_KEY,
                             json.dumps(body).encode())
            except Exception:
                pass
        _local_restoring.clear()
        return False


def signal_restore(kv: Optional[Any] = None) -> _RestoreSignal:
    return _RestoreSignal(kv)


def peer_restore_active(kv: Optional[Any] = None) -> bool:
    """True while some rank's restore signal is fresh (heartbeat within
    ``stale_seconds()``). Local restores (same process, another thread)
    count too, without a KV round trip."""
    if _local_restoring.is_set():
        return True
    kv = kv or kv_from_env()
    if kv is None:
        return False
    try:
        data = kv.get(KV_SCOPE, KV_RESTORING_KEY, timeout=0.0)
    except Exception:
        return False
    if not data:
        return False
    try:
        body = json.loads(data.decode())
        ts = float(body.get("ts", 0.0))
    except (ValueError, TypeError, AttributeError):
        return False
    return 0.0 < ts and (time.time() - ts) < stale_seconds()
