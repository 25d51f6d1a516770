"""CLIP ViT: training through ``ClipTrainer`` (the prompt objective, given
weights), scoring through ``AnomalyScorer`` with the prompt centre of
``prompt_center``; the reference side of the same configuration."""

import torch

from portbench.harness.common import BENCH_DIR, load_json
from portbench.reference import clip_vit as reference

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ROW_BLOCK = 64   # rows of the reference's training step at a time: the tower treats rows alone


def program_config(cfg: dict):
    from eoe_tpu_torch.models.clip import ClipConfig
    return ClipConfig(**{k: cfg[k] for k in (
        "embed_dim", "image_resolution", "vision_layers", "vision_width", "vision_patch_size",
        "context_length", "vocab_size", "transformer_width", "transformer_heads",
        "transformer_layers")})


def class_label(cfg: dict, dataset: str, cls: int) -> str:
    """The class's name, in the order of the frozen prompt tokens."""
    return list(load_json(BENCH_DIR / "reference" / "prompt_tokens.json")[dataset])[cls]


def prompt_tokens(cfg: dict, dataset: str, cls: int, device) -> torch.Tensor:
    """The one-vs-rest prompts' token ids, frozen as data, padded."""
    rows = load_json(BENCH_DIR / "reference" / "prompt_tokens.json")[dataset][
        class_label(cfg, dataset, cls)]
    out = torch.zeros((len(rows), cfg["context_length"]), dtype=torch.long)
    for i, r in enumerate(rows):
        out[i, :len(r)] = torch.tensor(r)
    return out.to(device)


def build_trainer(cfg: dict, weights: dict, device, mesh=None):
    from eoe_tpu_torch.training.clip import ClipTrainer
    tr = cfg["train"]
    return ClipTrainer(
        None, tr["specs"], [], dataset=tr["dataset"], oe_dataset=tr["oe_dataset"], datapath="",
        logger=None, epochs=tr["epochs"], lr=tr["lr"], wdk=tr["weight_decay"],
        milestones=tr["milestones"], batch_size=tr["batch_size"], ad_mode="one_vs_rest",
        clip_config=program_config(cfg), clip_state_dict=weights,
        compute_dtype=DTYPES[tr["compute_dtype"]], device=device, mesh=mesh)


def build_scorer(cfg: dict, weights: dict, dataset: str, cls: int, device):
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.models.clip import CLIP
    from eoe_tpu_torch.training.clip import prompt_center
    sv = cfg["serve"]
    dtype = DTYPES[sv["compute_dtype"]]
    model = CLIP(program_config(cfg), dtype=dtype)
    model.load_state_dict(weights)
    centre = prompt_center(model, class_label(cfg, dataset, cls), (), device=device)
    return AnomalyScorer({"params": weights}, model, objective="clip", test_specs=sv["specs"],
                         batch_size=sv["batch_size"], center=centre, compute_dtype=dtype,
                         device=device)


def reference_parts(cfg: dict, params: dict, inputs: dict, dataset: str, P) -> dict:
    """What the reference's training step and score take for this family."""
    centre = reference.prompt_centre(params, prompt_tokens(cfg, dataset, inputs["cls"],
                                                           params["logit_scale"].device), cfg, P)
    return {"forward": lambda p, x: reference.encode_image(p, x, cfg, P),
            "loss_terms": reference.loss_terms, "score": reference.score, "centre": centre,
            "stats": None, "row_block": ROW_BLOCK, "trainable": reference.trainable}
