"""Tiny configurations, mixes and cells for the CPU tests, written as new
files into a directory laid out as ``portbench/`` is, with a
``BENCHMARK.json`` of their own."""

import copy
import json
import shutil
from pathlib import Path

from portbench.harness.common import BENCH_DIR, load_json

CLIP = {
    "embed_dim": 16, "image_resolution": 32, "vision_layers": 2, "vision_width": 128,
    "vision_patch_size": 16, "context_length": 77, "vocab_size": 49408,
    "transformer_width": 64, "transformer_heads": 2, "transformer_layers": 1}
WRN_TRAIN_SPECS = [{"op": "resize", "size": 40}, {"op": "random_hflip", "p": 0.5},
                   {"op": "random_crop", "size": 32}, "normalize"]
CLIP_TRAIN_SPECS = [
    {"op": "resize", "size": 40},
    {"op": "color_jitter", "brightness": 0.01, "contrast": 0.01, "saturation": 0.01, "hue": 0.01},
    {"op": "random_crop", "size": 32}, {"op": "random_hflip", "p": 0.5},
    {"op": "clip_pil_preprocessing", "resolution": 32}, {"op": "gaussian_noise", "std": 0.001},
    {"op": "clip_tensor_preprocessing"}]


def configs() -> dict:
    clip = copy.deepcopy(load_json(BENCH_DIR / "configs" / "clip_vitb32.json"))
    clip.update(CLIP, name="tiny_clip")
    clip["train"].update(batch_size=8, epochs=4, milestones=[3], specs=CLIP_TRAIN_SPECS,
                         compute_dtype="float32")
    clip["serve"].update(batch_size=8, specs=[{"op": "clip_pil_preprocessing", "resolution": 32},
                                              {"op": "clip_tensor_preprocessing"}])
    wrn = copy.deepcopy(load_json(BENCH_DIR / "configs" / "wrn_cbam.json"))
    wrn.update(name="tiny_wrn", crop_size=32)
    wrn["train"].update(batch_size=8, epochs=4, milestones=[3], specs=WRN_TRAIN_SPECS)
    return {"tiny_clip": clip, "tiny_wrn": wrn}


TRAFFIC = {
    "tiny_class_seed": {"kind": "train_class_seed", "n_normal": 20, "n_oe": 8, "raw_size": 40,
                        "channels": 3, "classes": 30,
                        "content": {"grid": [2, 8], "level": [0.2, 0.8], "amplitude": [0.05, 0.4],
                                    "noise": [0.02, 0.3]},
                        "oe_content": {"grid": [2, 16], "level": [0.05, 0.95],
                                       "amplitude": [0.1, 0.6], "noise": [0.05, 0.5]}},
    "tiny_lots": {"kind": "closed_loop", "class": 0, "raw_size": 8, "channels": 3,
                  "sizes": {"log_uniform": [1, 20], "count": 8}, "pool": 64,
                  "content": {"grid": [2, 4], "level": [0.1, 0.9], "amplitude": [0.05, 0.5],
                              "noise": [0.02, 0.4]}},
}
CLIP_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "update_gap": 1e-3,
               "window_loss_gap": 1e-4, "window_grad_gap": 1e-4}
# Adam turns round-off of near-zero gradients into lr-sized moves: the median leaf
WRN_LIMITS = {"loss_gap_first": 1e-4, "grad_gap": 1e-4, "update_gap_median": 1e-3,
              "window_loss_gap": 1e-4, "window_grad_gap_median": 1e-4}
CELLS = {
    "tiny_clip-train": {"config": "tiny_clip", "traffic": "tiny_class_seed", "chips": 1,
                        "why": "test", "trace_epochs": 1, "control": "bf16",
                        "limits": CLIP_LIMITS},
    "tiny_wrn-train": {"config": "tiny_wrn", "traffic": "tiny_class_seed", "chips": 1,
                       "why": "test", "trace_epochs": 1, "control": "bf16",
                       "limits": WRN_LIMITS},
    "tiny_clip-train-dp2": {"config": "tiny_clip", "traffic": "tiny_class_seed", "chips": 2,
                            "why": "test", "trace_epochs": 1, "control": "bf16",
                            "limits": CLIP_LIMITS},
    "tiny_clip-serve": {"config": "tiny_clip", "traffic": "tiny_lots", "chips": 1, "why": "test",
                        "trace_after": 1, "trace_requests": 2, "check_images": 16, "control": "bf16",
                        "limits": {"score_gap": 1e-4}},
}


def write(root: Path) -> tuple:
    """(bench_dir, bench_file) of the tiny cells under ``root``."""
    bench = root / "portbench"
    for kind, items in (("configs", configs()), ("traffic", TRAFFIC), ("cells", CELLS)):
        (bench / kind).mkdir(parents=True, exist_ok=True)
        for name, body in items.items():
            (bench / kind / f"{name}.json").write_text(json.dumps(body))
    for kind in ("metrics", "kinds"):
        shutil.copytree(BENCH_DIR / kind, bench / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    real = load_json(BENCH_DIR.parent / "BENCHMARK.json")
    rename = {"clip_vitb32-train": "tiny_clip-train", "wrn_cbam-train": "tiny_wrn-train",
              "clip_vitb32-serve": "tiny_clip-serve", "clip_vitb32-train-dp4": "tiny_clip-train-dp2"}
    for m in real["end_to_end"] + real["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"] if w in rename]
    (root / "BENCHMARK.json").write_text(json.dumps(real))
    return bench, root / "BENCHMARK.json"
