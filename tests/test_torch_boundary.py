"""The port's boundaries: it imports neither jax nor eoe_tpu, and its entry
points run on CUDA unless the caller asks for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from eoe_tpu_torch import resolve_device
from eoe_tpu_torch.inference import AnomalyScorer
from eoe_tpu_torch.models.clip import CLIP, ClipConfig
from eoe_tpu_torch.training.clip import CIFAR10_LABELS, prompt_center

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import eoe_tpu_torch
names = [m.name for m in pkgutil.walk_packages(eoe_tpu_torch.__path__, "eoe_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "eoe_tpu"))
print(len(names), leaked)
"""


def test_port_imports_neither_jax_nor_eoe_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.split(" ", 1)
    assert int(n_modules) >= 12
    assert leaked.strip() == "[]"


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    tiny = ClipConfig(embed_dim=16, image_resolution=16, vision_layers=1, vision_width=64,
                      vision_patch_size=8, context_length=8, vocab_size=64,
                      transformer_width=64, transformer_heads=1, transformer_layers=1)
    model = CLIP(tiny)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AnomalyScorer(model.state_dict(), model)
    AnomalyScorer(model.state_dict(), model, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prompt_center(model, "cat", CIFAR10_LABELS)
