"""The port's models: ResNet v1.5, VGG-16/19, Inception V3, the MLP and
the transformer LM; `convert` carries the JAX package's weights over."""

from horovod_tpu_torch.models.inception import InceptionV3  # noqa: F401
from horovod_tpu_torch.models.mlp import MLP  # noqa: F401
from horovod_tpu_torch.models.resnet import ResNet  # noqa: F401
from horovod_tpu_torch.models.transformer import TransformerLM  # noqa: F401
from horovod_tpu_torch.models.vgg import VGG  # noqa: F401
