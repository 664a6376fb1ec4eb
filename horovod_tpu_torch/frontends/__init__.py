"""Framework frontends of the port (counterpart of
horovod_tpu/frontends/).

The port's core is the torch API itself (`horovod_tpu_torch`), so
`frontends.torch` and `frontends.torch_elastic` only re-export it. The
TensorFlow/Keras and MXNet frontends are thin adapters: a foreign tensor
crosses the boundary as numpy, becomes a torch tensor on `hvd.device()`
(the card, or the host under `hvd.init(device="cpu")`), goes through the
port's collectives (NCCL or gloo), and comes back in the input's own
type, dtype and shape. Each framework is imported only when a frontend
function needs it.
"""
