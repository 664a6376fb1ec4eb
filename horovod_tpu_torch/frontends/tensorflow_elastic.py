"""Elastic state for the port's TensorFlow frontend (counterpart of
horovod_tpu/frontends/tensorflow_elastic.py).

Reference: horovod/tensorflow/elastic.py — TensorFlowKerasState snapshots
model/optimizer variables in memory and syncs them by broadcast after a
topology change.

    import horovod_tpu_torch.frontends.tensorflow as hvd
    state = hvd.elastic.TfKerasState(model=model, optimizer=opt, epoch=0)

    @hvd.elastic.run
    def train(state):
        ...
        state.commit()
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

from horovod_tpu_torch.elastic import run  # noqa: F401  (re-exported: @elastic.run)
from horovod_tpu_torch.elastic.state import CheckpointableState, ObjectState


class TfKerasState(CheckpointableState, ObjectState):
    """In-memory checkpoint of Keras model + optimizer variables
    (reference: tensorflow/elastic.py TensorFlowKerasState).

    With a checkpointer attached (``checkpointer=``/``root=`` or
    HOROVOD_CKPT_DIR), the committed variable snapshots persist as the
    checkpoint's array tree (numpy copies, in the JAX package's on-disk
    format) and plain values ride the object channel; ``sync()`` runs
    rank 0's disk-vs-memory resume probe before broadcasting — see
    ``CheckpointableState``."""

    def __init__(self, model=None, optimizer=None, checkpointer=None,
                 root=None, **kwargs):
        self.model = model
        self.optimizer = optimizer
        self._saved_vars: Optional[List[Any]] = None
        self._init_checkpointer(checkpointer=checkpointer, root=root)
        super().__init__(**kwargs)
        self._known_attrs -= {"model", "optimizer"}

    def _all_vars(self) -> List[Any]:
        out: List[Any] = []
        if self.model is not None:
            out.extend(self.model.variables)
        if self.optimizer is not None:
            out.extend(getattr(self.optimizer, "variables", []))
        return out

    def save(self) -> None:
        self._saved_vars = [v.numpy().copy() for v in self._all_vars()]
        super().save()

    def restore(self) -> None:
        if self._saved_vars is not None:
            for v, s in zip(self._all_vars(), self._saved_vars):
                v.assign(s)
        super().restore()

    def sync(self) -> None:
        # resume probe first: a restored rank 0 broadcasts the
        # checkpoint's variables (CheckpointableState.maybe_resume)
        self.maybe_resume()
        from horovod_tpu_torch.frontends.tensorflow import broadcast_variables
        broadcast_variables(self._all_vars(), root_rank=0)
        super().sync()

    # ---- CheckpointableState hooks (last COMMITTED snapshot only) ----
    def _ckpt_payload(self):
        tree = {"vars": [v.copy() for v in (self._saved_vars or [])]}
        return tree, dict(self._saved)

    def _ckpt_like(self):
        # the variable list is list-addressed: restore it against the
        # current snapshot's structure, as the JAX package does
        return self._ckpt_payload()[0]

    def _ckpt_adopt(self, tree: Any, objects: Dict[str, Any]) -> None:
        vars_ = list((tree or {}).get("vars", []))
        if vars_:
            self._saved_vars = vars_
        for k, v in (objects or {}).items():
            self._saved[k] = copy.deepcopy(v)
            self._known_attrs.add(k)
        self.restore()


# Reference exposes the non-Keras variant under the same module.
TensorFlowKerasState = TfKerasState
