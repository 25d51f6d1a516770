"""The port's boundaries: it imports neither jax nor eoe_tpu, and its entry
points run on CUDA unless the caller asks for the CPU."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from eoe_tpu_torch import resolve_device
from eoe_tpu_torch.inference import AnomalyScorer
from eoe_tpu_torch.models import AE32, CNN32
from eoe_tpu_torch.models.clip import CLIP, ClipConfig
from eoe_tpu_torch.training import TRAINER
from eoe_tpu_torch.training.clip import CIFAR10_LABELS, prompt_center

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import eoe_tpu_torch
names = [m.name for m in pkgutil.walk_packages(eoe_tpu_torch.__path__, "eoe_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "eoe_tpu"))
native_built = sys.modules["eoe_tpu_torch.native"]._tried
print(json.dumps([names, leaked, native_built]))
"""


def test_port_imports_neither_jax_nor_eoe_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, leaked, native_built = json.loads(out.stdout)
    conv_path = {f"eoe_tpu_torch.{m}" for m in (
        "models.layers", "models.cnn", "models.ae", "models.cbam", "models.resnet",
        "models.convert", "ops.stem", "datasets.cifar", "datasets.mnist")}
    cli = {f"eoe_tpu_torch.main.{m}" for m in (
        "train_cifar", "train_mnist", "train_fmnist", "train_clip_cifar", "train_clip_mnist",
        "train_clip_fmnist", "multiscale_cifar", "train_imagenet", "train_imagenet_fast",
        "train_clip_imagenet", "multiscale_imagenet", "train_mvtec", "train_clip_mvtec",
        "train_dtd", "train_clip_dtd", "train_cub", "train_clip_cub", "train_custom")} | {
        "eoe_tpu_torch.main", "eoe_tpu_torch.ops.filters", "eoe_tpu_torch.datasets.tinyimages"}
    folder = {f"eoe_tpu_torch.{m}" for m in (
        "datasets.folder", "datasets.imagenet", "datasets.imagenetoe", "datasets.mvtec",
        "datasets.dtd", "datasets.cub", "datasets.custom", "native", "utils.caching")}
    evolve_custom = {f"eoe_tpu_torch.{m}" for m in (
        "evolve", "evolve.tree", "models.custom_base", "models.custom",
        "main.evolve_oe_cifar", "main.evolve_oe_imagenet", "main.evolve_oe_custom",
        "main.random_oe_cifar", "main.random_oe_imagenet", "main.train_only_custom",
        "main.inference_custom")}
    imports_and_tools = {f"eoe_tpu_torch.{m}" for m in (
        "models.resnet50", "models.torch_import", "main.import_snapshot", "main.prepare_data",
        "ops.pool")}
    parallel = {"eoe_tpu_torch.parallel", "eoe_tpu_torch.parallel.mesh"}
    assert len(names) >= 67 and conv_path | cli | folder | evolve_custom | imports_and_tools \
        | parallel <= set(names)
    assert leaked == []
    assert not native_built   # the native decoder builds at first use, not at import


@pytest.mark.parametrize("script", ["chip_smoke.py", "profile_train.py", "attention_variants.py",
                                    "augment_variants.py", "dp_scaling.py"])
def test_root_scripts_import_neither_jax_nor_eoe_tpu(script):
    """The scripts that drive the port on the card import only the port:
    every import statement, at any depth, is read from the source."""
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read(), script)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "eoe_tpu_torch" in roots or "chip_smoke" in roots
    assert not roots & {"jax", "jaxlib", "flax", "eoe_tpu"}, sorted(roots)


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


def test_trainers_default_to_cuda(monkeypatch):
    """``Trainer`` and ``ClipTrainer`` run on ``cuda`` unless asked for the
    CPU, and raise where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = ClipConfig(embed_dim=16, image_resolution=16, vision_layers=1, vision_width=64,
                      vision_patch_size=8, context_length=8, vocab_size=64,
                      transformer_width=64, transformer_heads=1, transformer_layers=1)
    kw = dict(dataset="cifar10", oe_dataset=None, datapath="", logger=None, epochs=1, lr=1e-3,
              wdk=0.0, milestones=[], batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRAINER["hsc"](model=CLIP(tiny), train_specs=[], test_specs=[], **kw)
    weights = CLIP(tiny).state_dict()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRAINER["clip"](None, None, None, clip_config=tiny, clip_state_dict=weights, **kw)
    assert TRAINER["hsc"](model=CLIP(tiny), train_specs=[], test_specs=[], device="cpu",
                          **kw).device == torch.device("cpu")
    assert TRAINER["clip"](None, None, None, clip_config=tiny, clip_state_dict=weights,
                           device="cpu", **kw).device == torch.device("cpu")
    monkeypatch.setenv("HOME", "/nonexistent")
    monkeypatch.delenv("EOE_TPU_CLIP_CHECKPOINT", raising=False)
    with pytest.raises(FileNotFoundError):  # no checkpoint file anywhere
        TRAINER["clip"](None, None, None, device="cpu", **kw)
    for name in ("bce", "focal", "dsvdd", "dsad", "ae"):
        model = AE32() if name == "ae" else CNN32(clf=name in ("bce", "focal"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TRAINER[name](model=model, train_specs=[], test_specs=[], **kw)
        assert TRAINER[name](model=model, train_specs=[], test_specs=[], device="cpu",
                             **kw).device == torch.device("cpu")


def test_runners_default_to_cuda(tmp_path, monkeypatch):
    """The CLI runners run on ``cuda`` (``device`` is a keyword of ``main``,
    not a flag) and raise where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from eoe_tpu_torch.main import (multiscale_cifar, train_cifar, train_clip_cifar,
                                    train_clip_imagenet, train_imagenet, train_mvtec)
    base = ["-e", "1", "-it", "1", "--classes", "0", "--datapath", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cifar.main(base)
    for runner in (train_imagenet, train_mvtec):   # before any data is read
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.main(base)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multiscale_cifar.main(base + ["--ms-mode", "lpf+train_nominal", "--magnitudes", "0"])
    tiny = ClipConfig(embed_dim=16, image_resolution=16, vision_layers=1, vision_width=64,
                      vision_patch_size=8, context_length=8, vocab_size=64,
                      transformer_width=64, transformer_heads=1, transformer_layers=1)
    from eoe_tpu_torch.models.clip import to_openai
    torch.save(to_openai(CLIP(tiny).state_dict(), tiny), tmp_path / "ckpt.pt")
    monkeypatch.setenv("EOE_TPU_CLIP_CHECKPOINT", str(tmp_path / "ckpt.pt"))
    for runner in (train_clip_cifar, train_clip_imagenet):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.main(base)


def test_evolve_and_custom_runners_default_to_cuda(tmp_path, monkeypatch):
    """The five evolutionary/random OE runners and the two custom-model
    runners run on ``cuda`` and raise where there is no card, before any
    data is read; the GA's distances default to the card too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import numpy as np
    from eoe_tpu_torch.datasets import DS_CHOICES
    from eoe_tpu_torch.datasets.bases import ArraySource, Subset
    from eoe_tpu_torch.datasets.custom import ADCustomDS
    from eoe_tpu_torch.evolve import mate_individuals, mutate_individual
    from eoe_tpu_torch.main import (evolve_oe_cifar, evolve_oe_custom, evolve_oe_imagenet,
                                    inference_custom, random_oe_cifar, random_oe_imagenet,
                                    train_only_custom)
    for name in ("train_only", "eval_only", "base_folder", "classes"):
        monkeypatch.setattr(ADCustomDS, name, getattr(ADCustomDS, name))
    monkeypatch.setitem(DS_CHOICES, "custom", dict(DS_CHOICES["custom"]))
    base = ["-e", "1", "-it", "1", "--datapath", str(tmp_path), "--superdir", str(tmp_path)]
    for runner in (evolve_oe_cifar, evolve_oe_imagenet, random_oe_cifar, random_oe_imagenet):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.main(base)
    os.makedirs(tmp_path / "datasets" / "custom" / "train" / "a" / "normal")
    os.makedirs(tmp_path / "datasets" / "custom" / "test" / "a" / "normal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evolve_oe_custom.main(base)
    os.makedirs(tmp_path / "flat" / "normal")
    custom = ["--custom-dataset-path", str(tmp_path / "flat"), "--log-path", str(tmp_path)]
    for runner in (train_only_custom, inference_custom):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.main(custom)
    oeds = Subset(ArraySource(np.zeros((4, 2, 2, 3), np.uint8), np.zeros(4)), np.arange(4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mutate_individual([0], oeds, 2, 1.0, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mate_individuals([0], [1], oeds, 2, 1.0, 1)


def test_host_tools_touch_no_card(tmp_path, monkeypatch):
    """``import_snapshot`` and ``prepare_data`` are host tools: they run
    where there is no card and never ask for one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_card(*a, **k):
        raise AssertionError("a host tool asked for the card")
    monkeypatch.setattr(torch.cuda, "init", no_card)
    monkeypatch.setattr(torch.cuda, "current_device", no_card)
    from eoe_tpu_torch.main import import_snapshot, prepare_data
    model = CNN32()
    torch.save({"net": model.state_dict(), "epoch": 1}, tmp_path / "ref.pt")
    out = import_snapshot.main([str(tmp_path / "ref.pt"), str(tmp_path / "out.pt")])
    assert torch.load(out, weights_only=True)["epoch"] == 1
    (tmp_path / "r" / "normal").mkdir(parents=True)
    assert prepare_data.main(["custom", "--check-only", "--train-only", "--custom-root",
                              str(tmp_path / "r"), "--datapath", str(tmp_path)])
