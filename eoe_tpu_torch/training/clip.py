"""The CLIP prompt centre: the text side of ``ClipTrainer.prepare_metric``
(eoe_tpu/training/clip.py:138-155). ``ClipTrainer`` itself comes with the
training slice.

The prompts: one-vs-rest ``["a photo of a {cls}", anomaly prompt]``;
leave-one-out every other class's ``"a photo of a {c}"`` then the anomaly
prompt. Their text features, L2-normalised, are the "center" that
``clip_score`` takes, anomaly prompt last.
"""

from typing import List, Sequence

import torch

from eoe_tpu_torch.device import resolve_device
from eoe_tpu_torch.models.clip.tokenizer import tokenize

CIFAR10_LABELS = ["airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse",
                  "ship", "truck"]


def prompt_texts(clsstr: str, class_names: Sequence[str], ad_mode: str = "one_vs_rest",
                 anom_tkn_ptn: str = "a photo of something") -> List[str]:
    if ad_mode == "one_vs_rest":
        return [f"a photo of a {clsstr}", anom_tkn_ptn.format(clsstr)]
    if ad_mode == "leave_one_out":
        return [*[f"a photo of a {cs}" for cs in class_names if cs != clsstr],
                anom_tkn_ptn.format(clsstr)]
    raise NotImplementedError(f"AD mode {ad_mode} unknown.")


@torch.inference_mode()
def prompt_center(model, clsstr: str, class_names: Sequence[str],
                  ad_mode: str = "one_vs_rest",
                  anom_tkn_ptn: str = "a photo of something", device=None) -> torch.Tensor:
    """Encode the prompt set with ``model`` (a port ``CLIP``), which is moved
    to ``device`` (``cuda`` unless the caller asks for another one); returns
    the L2-normalised fp32 text features, anomaly prompt last, on ``device``."""
    device = resolve_device(device)
    texts = prompt_texts(clsstr, class_names, ad_mode, anom_tkn_ptn)
    model = model.to(device)
    tokens = torch.from_numpy(tokenize(texts, model.config.context_length)).long().to(device)
    feats = model.encode_text(tokens).float()
    return feats / feats.norm(dim=-1, keepdim=True)
