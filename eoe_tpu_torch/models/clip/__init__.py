"""CLIP in PyTorch (ViT variants), its tokenizer and the Flax weight bridge."""

from eoe_tpu_torch.models.clip.model import CLIP, ClipConfig, VIT_B32, quick_gelu  # noqa: F401
from eoe_tpu_torch.models.clip.tokenizer import ClipTokenizer, tokenize  # noqa: F401
from eoe_tpu_torch.models.clip.convert import from_flax, to_flax_numpy  # noqa: F401
