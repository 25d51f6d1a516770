"""CLIP anomaly detection: ``ClipTrainer`` and the prompt centre. The port of
eoe_tpu/training/clip.py.

``ClipTrainer`` fine-tunes CLIP's image tower with the prompt-contrastive
objective: it always uses the given CLIP weights (they are copied in again
for every class and seed, never re-drawn), SGD with Nesterov momentum,
CLIP's test preprocessing, and the prompt centre as the objective's centre.
Zero-shot is a run with ``epochs=0``.

The prompts: one-vs-rest ``["a photo of a {cls}", anomaly prompt]``;
leave-one-out every other class's ``"a photo of a {c}"`` then the anomaly
prompt. Their text features, L2-normalised, are the "center" that
``clip_loss`` and ``clip_score`` take, anomaly prompt last.

Weights: the OpenAI checkpoint at ``checkpoint_path``, else at
``$EOE_TPU_CLIP_CHECKPOINT``, else at ``~/.cache/clip/ViT-B-32.pt``, its
architecture (a ViT, or a ModifiedResNet such as RN50) read from its shapes
(``models.clip.convert``); nothing is downloaded. Tests pass a port
``state_dict`` instead (``clip_state_dict=``, with ``clip_config=``). A
ResNet tower's batch-norm averages come with the weights, are copied in
anew for every class-seed, move in the train step and serve eval.
"""

import os
import os.path as pt
from typing import List, Optional, Sequence

import torch

from eoe_tpu_torch.datasets import CIFAR10_LABELS, str_labels  # noqa: F401
from eoe_tpu_torch.device import resolve_device
from eoe_tpu_torch.models.clip import CLIP, VIT_B32, ClipConfig
from eoe_tpu_torch.models.clip.convert import config_from_state_dict, from_openai, load_checkpoint
from eoe_tpu_torch.models.clip.tokenizer import tokenize
from eoe_tpu_torch.training.trainer import TrainState, Trainer

CLIP_SPECS = [{"op": "clip_pil_preprocessing"}, {"op": "clip_tensor_preprocessing"}]
DEFAULT_CHECKPOINT = "~/.cache/clip/ViT-B-32.pt"


def resolve_checkpoint(path: Optional[str] = None) -> Optional[str]:
    """The first of ``path``, ``$EOE_TPU_CLIP_CHECKPOINT`` and the default
    location that exists."""
    for cand in (path, os.environ.get("EOE_TPU_CLIP_CHECKPOINT"),
                 pt.expanduser(DEFAULT_CHECKPOINT)):
        if cand and pt.exists(cand):
            return cand
    return None


def prompt_texts(clsstr: str, class_names: Sequence[str], ad_mode: str = "one_vs_rest",
                 anom_tkn_ptn: str = "a photo of something") -> List[str]:
    if ad_mode == "one_vs_rest":
        return [f"a photo of a {clsstr}", anom_tkn_ptn.format(clsstr)]
    if ad_mode == "leave_one_out":
        return [*[f"a photo of a {cs}" for cs in class_names if cs != clsstr],
                anom_tkn_ptn.format(clsstr)]
    raise NotImplementedError(f"AD mode {ad_mode} unknown.")


@torch.no_grad()
def prompt_center(model, clsstr: str, class_names: Sequence[str],
                  ad_mode: str = "one_vs_rest",
                  anom_tkn_ptn: str = "a photo of something", device=None) -> torch.Tensor:
    """Encode the prompt set with ``model`` (a port ``CLIP``), which is moved
    to ``device`` (``cuda`` unless the caller asks for another one); returns
    the L2-normalised fp32 text features, anomaly prompt last, on ``device``.
    Computed without gradients but as an ordinary tensor, so that it can
    enter ``clip_loss`` in a training step."""
    device = resolve_device(device)
    texts = prompt_texts(clsstr, class_names, ad_mode, anom_tkn_ptn)
    model = model.to(device)
    tokens = torch.from_numpy(tokenize(texts, model.config.context_length)).long().to(device)
    feats = model.encode_text(tokens).float()
    return feats / feats.norm(dim=-1, keepdim=True)


class ClipTrainer(Trainer):
    def __init__(self, model, train_specs, test_specs, *args,
                 anom_tkn_ptn: str = "a photo of something",
                 checkpoint_path: Optional[str] = None,
                 clip_config: Optional[ClipConfig] = None,
                 clip_state_dict: Optional[dict] = None,
                 compute_dtype: torch.dtype = torch.float32, **kwargs):
        assert model is None, "CLIP-AD always uses the CLIP model"
        assert not test_specs, "CLIP-AD always uses CLIP's test transform"
        if clip_state_dict is not None:
            config = clip_config or VIT_B32
        else:
            ckpt = resolve_checkpoint(checkpoint_path)
            if ckpt is None:
                raise FileNotFoundError(
                    "No CLIP checkpoint found. Place the OpenAI ViT-B/32 weights at "
                    f"{DEFAULT_CHECKPOINT} or set EOE_TPU_CLIP_CHECKPOINT (nothing is "
                    "downloaded).")
            sd = load_checkpoint(ckpt)
            config = config_from_state_dict(sd)
            clip_state_dict = from_openai(sd)
        self._clip_state_dict = {k: v.detach().cpu().clone() for k, v in clip_state_dict.items()}
        clip_model = CLIP(config, dtype=compute_dtype)
        # setup.json records the raw specs; placeholders resolve below
        self._raw_train_specs = list(train_specs) if train_specs else None
        self._raw_test_specs = list(test_specs) if test_specs else None
        train_specs = list(train_specs) if train_specs else list(CLIP_SPECS)
        res = config.image_resolution
        train_specs = [
            ({"op": "clip_pil_preprocessing", "resolution": res}
             if (s == "clip_pil_preprocessing"
                 or (isinstance(s, dict) and s.get("op") == "clip_pil_preprocessing"))
             else s)
            for s in train_specs]
        test_specs = [{"op": "clip_pil_preprocessing", "resolution": res},
                      {"op": "clip_tensor_preprocessing"}]
        super().__init__(clip_model, train_specs, test_specs, *args,
                         objective="clip", compute_dtype=compute_dtype, **kwargs)
        self.anom_tkn_ptn = anom_tkn_ptn
        self.raw_texts: Sequence[str] = ()

    def setup_dict(self) -> dict:
        d = super().setup_dict()
        d["train_specs"] = self._raw_train_specs or []
        d["test_specs"] = self._raw_test_specs or []
        return d

    def init_weights(self, seed: int):
        """The given CLIP weights, copied in anew for every class-seed."""
        self.model.load_state_dict(self._clip_state_dict)

    def _loss_kwargs(self, inputs):
        return {"nominal_label": self.nominal_label, "ad_mode": self.ad_mode}

    def prepare_metric(self, clsstr: str, ds, state: TrainState, seed: int) -> torch.Tensor:
        """The prompt set's normalised text features under the current
        weights: the objective's centre."""
        classes = str_labels(self.dsstr) if self.ad_mode == "leave_one_out" else ()
        self.raw_texts = prompt_texts(clsstr, classes, self.ad_mode, self.anom_tkn_ptn)
        return prompt_center(state.model, clsstr, classes, self.ad_mode, self.anom_tkn_ptn,
                             device=self.device)
