"""CLIP in PyTorch (ViT and ResNet variants), its tokenizer, the Flax weight
bridge and the OpenAI checkpoint converter."""

from eoe_tpu_torch.models.clip.model import (  # noqa: F401
    CLIP, RN50, VIT_B32, ClipConfig, quick_gelu)
from eoe_tpu_torch.models.clip.tokenizer import ClipTokenizer, tokenize  # noqa: F401
from eoe_tpu_torch.models.clip.convert import (  # noqa: F401
    config_from_state_dict, from_flax, from_openai, load_checkpoint, to_flax_numpy,
    to_flax_variables, to_openai)
