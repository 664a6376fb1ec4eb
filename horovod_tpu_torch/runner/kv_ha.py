"""The launcher's control-plane factory (counterpart of
horovod_tpu/runner/kv_ha.py `start_control_plane`).

HOROVOD_KV_REPLICAS <= 1, the default, gives a started plain
`RendezvousServer`. The replicated control plane with epoch-fenced
failover that the JAX package starts for > 1 is not ported yet: asking
for it raises HorovodError naming ROADMAP A13.
"""

from __future__ import annotations

import os
from typing import Optional

from horovod_tpu_torch.common.exceptions import HorovodError
from horovod_tpu_torch.runner.rendezvous import RendezvousServer

HOROVOD_KV_REPLICAS = "HOROVOD_KV_REPLICAS"


def start_control_plane(secret: Optional[bytes]) -> RendezvousServer:
    n = int(os.environ.get(HOROVOD_KV_REPLICAS, "1") or 1)
    if n > 1:
        raise HorovodError(
            f"{HOROVOD_KV_REPLICAS}={n}: the replicated rendezvous control "
            f"plane is not ported yet (ROADMAP A13); unset it or set 1")
    rdv = RendezvousServer(secret=secret)
    rdv.start()
    return rdv
