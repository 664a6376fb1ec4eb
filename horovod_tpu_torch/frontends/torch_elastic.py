"""Elastic state and sampler of the torch frontend (counterpart of
horovod_tpu/frontends/torch_elastic.py): the port's own
`horovod_tpu_torch.elastic`, re-exported.

    import horovod_tpu_torch.frontends.torch as hvd
    state = hvd.elastic.TorchState(model=model, optimizer=opt, epoch=0)

    @hvd.elastic.run
    def train(state):
        ...
        state.commit()
"""

from horovod_tpu_torch.elastic import (  # noqa: F401
    CheckpointableState, ElasticSampler, ModelStateHandler, ObjectState,
    OptimizerStateHandler, SamplerStateHandler, StateHandler, TorchState,
    get_handler_registry, run, set_handler_registry,
)
