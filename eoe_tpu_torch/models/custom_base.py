"""Plug-in base for user-defined models: the port of
eoe_tpu/models/custom_base.py.

A ``CustomNet`` wraps a ``feature_model`` submodule (built by the subclass's
``build_feature_model``, with ``feature_dim`` outputs) and, with
``prediction_head``, a ``final_linear`` dense layer of 1 output for the
classification objectives and 256 otherwise, initialised as ``nn.Linear``
(weight and bias uniform in +-1/sqrt(feature_dim)). With ``freeze`` the
trainer updates no parameter of the feature model (``frozen_param_labels``):
no gradient step and no weight decay; its batch statistics still move in
train mode, as in the JAX package. The trainer loads a state dict of the
feature model alone into ``feature_model``. Subclasses in
``models.custom`` are found by the ``train_only_custom`` and
``inference_custom`` runners.
"""

from typing import Dict

import torch
from torch import nn

from eoe_tpu_torch.models.layers import ConvModel, Dense, torch_linear


class CustomNet(ConvModel):
    feature_dim: int = 256
    # the submodule holding the feature model: what ``freeze`` leaves alone
    # and what a feature-model-only snapshot loads into
    FEATURE_COLLECTION = "feature_model"

    def __init__(self, prediction_head: bool = True, clf: bool = False, freeze: bool = False):
        super().__init__()
        self.prediction_head, self.clf, self.freeze = prediction_head, clf, freeze
        self.feature_model = self.build_feature_model()
        if prediction_head:
            self.final_linear = Dense(self.feature_dim, 1 if clf else 256,
                                      kernel_init=torch_linear, bias_init=torch_linear)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def build_feature_model(self) -> nn.Module:
        raise NotImplementedError("CustomNet subclasses must implement build_feature_model()")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.prediction_head and self.clf and self.feature_dim != 1:
            raise ValueError(
                f"{type(self).__name__} is used with a classification loss (BCE, focal, ...) "
                f"without a prediction head, but its feature model outputs "
                f"{self.feature_dim} > 1 neurons. Add a prediction head "
                f"(--custom-model-add-prediction-head) or change the objective.")
        feats = self.feature_model(x)
        if self.prediction_head:
            feats = self.final_linear(feats.reshape(feats.shape[0], -1))
        return feats


def frozen_param_labels(model: nn.Module, freeze: bool) -> Dict[str, str]:
    """Each parameter's label by name: "frozen" for the feature model's when
    ``freeze`` is set, "trainable" otherwise."""
    return {name: "frozen" if freeze and name.split(".")[0] == CustomNet.FEATURE_COLLECTION
            else "trainable" for name, _ in model.named_parameters()}
