"""horovod_tpu_torch.ckpt: async checkpointing and exactly-once elastic
step-resume (counterpart of horovod_tpu/ckpt/).

A two-phase ``AsyncCheckpointer`` (host snapshot on the step boundary,
persist and atomic commit on a background writer), multi-writer saves
of offset-named fragments, a crash-consistent manifest and commit-marker
protocol with quarantine fallback, and the restore signal. The on-disk
format is the JAX package's: either package reads what the other
commits. ``elastic.TrainLoopState`` ties it into the elastic retry loop
so resumed rounds continue from the last committed step.

    from horovod_tpu_torch import ckpt

    saver = ckpt.AsyncCheckpointer("/ckpts/run1")
    saver.save(step, {"model": model.state_dict()},
               objects={"step": step, "cursor": cursor})
    ...
    got = saver.restore_latest()
"""

from horovod_tpu_torch.common.exceptions import (  # noqa: F401
    CheckpointCorruptError,
)
from horovod_tpu_torch.ckpt.async_ckpt import (  # noqa: F401
    AsyncCheckpointer, Restored,
)
from horovod_tpu_torch.ckpt.manifest import (  # noqa: F401
    LeafEntry, Manifest, committed, has_done_marker, latest_committed,
    quarantine, sweep_stale, write_done_marker,
)
from horovod_tpu_torch.ckpt.resume import (  # noqa: F401
    latest_pointer, load_params, peer_restore_active, restore_latest,
    signal_restore,
)
from horovod_tpu_torch.ckpt.sharded import Fragment  # noqa: F401
