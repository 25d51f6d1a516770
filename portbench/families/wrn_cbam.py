"""WideResNet + CBAM trained with HSC through ``Trainer``, its weights the
benchmark's (loaded where the trainer would draw them); the reference side
of the same configuration."""

import torch

from portbench.reference import augment
from portbench.reference import wrn_cbam as reference

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_trainer(cfg: dict, weights: dict, device, mesh=None):
    from eoe_tpu_torch.models import WideResNet
    from eoe_tpu_torch.training import TRAINER
    tr = cfg["train"]
    assert (cfg["stem_width"], tuple(cfg["stage_widths"]), cfg["cbam_reduction"]) == \
        (64, (64, 128, 256, 512), 16), "the program's WideResNet has the published widths"
    model = WideResNet(rep_dim=cfg["rep_dim"], clf=False, layers=tuple(cfg["blocks_per_stage"]))
    trainer = TRAINER[tr["objective"]](
        model=model, train_specs=tr["specs"], test_specs=tr["test_specs"], dataset=tr["dataset"],
        oe_dataset=tr["oe_dataset"], datapath="", logger=None, epochs=tr["epochs"], lr=tr["lr"],
        wdk=tr["weight_decay"], milestones=tr["milestones"], batch_size=tr["batch_size"],
        compute_dtype=DTYPES[tr["compute_dtype"]], device=device, mesh=mesh)
    trainer.init_weights = lambda seed: trainer.model.load_state_dict(weights)
    return trainer


def class_label(cfg: dict, dataset: str, cls: int) -> str:
    from eoe_tpu_torch.datasets import str_labels
    return str_labels(dataset)[cls]


def reference_parts(cfg: dict, params: dict, inputs: dict, dataset: str, P) -> dict:
    device = params["fc.weight"].device
    stats = augment.channel_stats(torch.from_numpy(inputs["xn"]).to(device))
    return {"forward": lambda p, x: reference.forward(p, x, cfg, P),
            "loss_terms": reference.loss_terms, "score": reference.score, "centre": None,
            "stats": stats, "row_block": None, "trainable": reference.trainable}
