"""Models of the port: CLIP (``models.clip``) and the conv models."""

from eoe_tpu_torch.models.ae import AE32  # noqa: F401
from eoe_tpu_torch.models.cnn import CNN28, CNN32  # noqa: F401
from eoe_tpu_torch.models.resnet import WideResNet  # noqa: F401
from eoe_tpu_torch.models.resnet50 import WideResNet50Pretrained  # noqa: F401
