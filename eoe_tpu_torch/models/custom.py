"""User-extensible custom model zoo: the port of eoe_tpu/models/custom.py.
Every ``CustomNet`` subclass defined in this module is found by the
``train_only_custom`` and ``inference_custom`` runners."""

from torch import nn

from eoe_tpu_torch.models.custom_base import CustomNet
from eoe_tpu_torch.models.resnet import WideResNet


class WideResNetCustom(CustomNet):
    """The WideResNet(+CBAM) feature model behind the CustomNet head."""
    feature_dim: int = 256

    def build_feature_model(self) -> nn.Module:
        return WideResNet(rep_dim=self.feature_dim, clf=False)
