"""The port's CLI (``eoe_tpu_torch.main``) against the JAX package's: each
runner's defaults, pipelines, model and parsed arguments, ``load_setup``,
and the runners end to end on the CPU (the port alone: the JAX runners are
held end to end by tests/test_main.py, a slow module): the CIFAR runners on
synthetic data, ``train_clip_imagenet`` on a tiny tree of blobs and
``train_custom`` on a tiny PNG tree."""

import argparse
import glob
import importlib
import json
import os
import os.path as pt
import subprocess
import sys

import numpy as np
import pytest
import torch

import eoe_tpu.main as jax_main
import eoe_tpu_torch.main as port_main

REPO = pt.dirname(pt.dirname(pt.abspath(__file__)))
RUNNERS = ["train_cifar", "train_mnist", "train_fmnist", "train_clip_cifar",
           "train_clip_mnist", "train_clip_fmnist", "multiscale_cifar", "train_imagenet",
           "train_imagenet_fast", "train_clip_imagenet", "multiscale_imagenet", "train_mvtec",
           "train_clip_mvtec", "train_dtd", "train_clip_dtd", "train_cub", "train_clip_cub",
           "train_custom"]
ARGVS = [
    [],
    ["--ad-mode", "loo", "-oe", "none", "-b", "64", "--oe-size", "100", "-e", "3"],
    ["--compute-dtype", "bfloat16", "--classes", "1", "2", "-it", "3", "--no-vmap-seeds",
     "-o", "bce", "--milestones", "5", "--comment", "{obj}-{admode}", "--superdir", "s"],
    ["-ds", "fmnist", "-oe", "cifar100", "--ad-mode", "ff", "-lr", "0.5", "-wdk", "0",
     "--datapath", "/data", "-d", "1", "--load", "/runs/x"],
]
MS_ARGVS = [["--ms-mode", "lpf+train_nominal", "hpf+test_anomalous", "--magnitudes", "0", "8"],
            ["--ms-mode", "blur+train_oe", "--oe-size", "500", "-o", "dsvdd"],
            ["--ms-mode", "sharpen+test_nominal", "--magnitude", "3"],   # refused
            ["--ms-mode", "lpf+train_oe", "--load", "/runs/y"]]          # refused


def _parsed(mod, argv, monkeypatch):
    """The runner's namespace, as its ``main`` would hand it on (the tail
    that trains is replaced by one that returns the arguments)."""
    tail = "multiscale_experiment" if hasattr(mod, "multiscale_experiment") \
        else "run_default_training"
    monkeypatch.setattr(mod, tail, lambda args, *a, **kw: args)
    try:
        args = mod.main(argv)
    except ValueError as e:   # the runner's own guards
        return type(e), str(e)
    out = dict(vars(args))
    if "ms_mode" in out:
        out["ms_mode"] = [str(m) for m in out["ms_mode"]]
    return out


@pytest.mark.parametrize("runner", RUNNERS)
def test_runner_matches_jax(runner, monkeypatch, capsys):
    """Defaults, pipelines and model as the JAX runner's; for every argv the
    same namespace, comment included, which names the run directory."""
    ours = importlib.import_module(f"eoe_tpu_torch.main.{runner}")
    theirs = importlib.import_module(f"eoe_tpu.main.{runner}")
    assert ours.DEFAULTS == theirs.DEFAULTS
    assert ours.TRAIN_SPECS == theirs.TRAIN_SPECS and ours.TEST_SPECS == theirs.TEST_SPECS
    argvs = MS_ARGVS if runner.startswith("multiscale") else ARGVS
    for argv in argvs:
        got, want = _parsed(ours, argv, monkeypatch), _parsed(theirs, argv, monkeypatch)
        assert got == want, argv
        if runner.startswith("multiscale") or "-oe" in argv:
            continue
        args = argparse.Namespace(**got)
        model, jax_model = ours.build_model(args), theirs.build_model(args)
        assert type(model).__name__ == type(jax_model).__name__
        if model is not None:
            assert model.clf == jax_model.clf


def test_ms_argsparse_matches_jax():
    for argv in (["--ms-mode", "sharpen+test_nominal", "--magnitude", "3"], []):
        ours = port_main.ms_argsparse(lambda s: s, argv=argv)
        theirs = jax_main.ms_argsparse(lambda s: s, argv=argv)
        assert [str(m) for m in ours.ms_mode] == [str(m) for m in theirs.ms_mode]
        assert {k: v for k, v in vars(ours).items() if k != "ms_mode"} == \
            {k: v for k, v in vars(theirs).items() if k != "ms_mode"}
    assert port_main.AD_MODE_MAP == jax_main.AD_MODE_MAP


@pytest.mark.parametrize("runner", RUNNERS)
def test_runner_help_needs_no_card(runner):
    out = subprocess.run([sys.executable, "-m", f"eoe_tpu_torch.main.{runner}", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert "--compute-dtype" in out.stdout and "--vmap-seeds" in out.stdout


def _base(tmp_path, extra=()):
    return ["-e", "1", "-it", "1", "--classes", "0", "-b", "32", "--datapath", str(tmp_path),
            *extra]


def test_one_card_flags_raise(tmp_path, monkeypatch):
    """``-d 2`` starts a second rank running the same ``main(argv)`` (the
    ranks themselves: tests/test_torch_parallel.py); ``--vmap-seeds``,
    ``--no-vmap-seeds`` and the default reach ``Trainer.run`` as True, False
    and None."""
    from eoe_tpu_torch.main import train_cifar
    from eoe_tpu_torch.parallel import mesh as meshlib
    from eoe_tpu_torch.training import Trainer

    class Spawned(Exception):
        pass

    def spawn(fn, args, n):
        raise Spawned(fn, args, n)

    monkeypatch.setattr(meshlib, "spawn_ranks", spawn)
    argv = _base(tmp_path, ["-d", "2"])
    with pytest.raises(Spawned) as got:
        train_cifar.main(argv, device="cpu")
    assert got.value.args == (train_cifar.main, (argv, "cpu"), 2)
    seen = []
    monkeypatch.setattr(Trainer, "run", lambda self, *a, vmap_seeds=None: seen.append(vmap_seeds))
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    for flag in (["--vmap-seeds"], ["--no-vmap-seeds"], []):
        train_cifar.main(_base(tmp_path, flag), device="cpu")
    assert seen == [True, False, None]


def _runs(root, pattern="log_*"):
    return sorted(glob.glob(str(root / "results" / "**" / pattern), recursive=True))


def test_train_cifar_runs_and_resumes(tmp_path, monkeypatch):
    """train_cifar on the CPU (synthetic CIFAR-10, Tiny Images as OE), then
    ``--load``: the snapshot re-evaluated into ``<run>---CNTD`` with the same
    AUROC; ``load_setup`` reads the run's setup.json as the JAX package's
    does, and refuses other pipelines, datasets and objectives."""
    from eoe_tpu_torch.main import train_cifar
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    _, res = train_cifar.main(_base(tmp_path), device="cpu")
    assert np.isfinite(res["mean_auc"])
    run = _runs(tmp_path)[0]
    assert pt.basename(run).endswith("_hsc_cifar10_one_vs_rest")
    assert pt.exists(pt.join(run, "snapshots", "snapshot_cls0_it0.pt"))
    assert json.load(open(pt.join(run, "setup.json")))["oe_dataset"] == "tinyimages"

    args = port_main.default_argsparse(lambda s: s, argv=["-ds", "cifar10"])
    jargs = jax_main.default_argsparse(lambda s: s, argv=["-ds", "cifar10"])
    snaps, path = port_main.load_setup(run, args, train_cifar.TRAIN_SPECS,
                                       train_cifar.TEST_SPECS)
    jax_main.load_setup(run, jargs, train_cifar.TRAIN_SPECS, train_cifar.TEST_SPECS)
    assert vars(args) == vars(jargs) and path == run
    assert snaps[0] == [pt.join(run, "snapshots", "snapshot_cls0_it0.pt")]
    assert all(s == [None] for s in snaps[1:])
    for specs, ds, obj, what in ((["normalize", "gcn"], "cifar10", "hsc", "transformation"),
                                 (train_cifar.TRAIN_SPECS, "mnist", "hsc", "dataset"),
                                 (train_cifar.TRAIN_SPECS, "cifar10", "bce", "objective")):
        with pytest.raises(AssertionError, match=what):
            port_main.load_setup(run, argparse.Namespace(dataset=ds, objective=obj), specs,
                                 train_cifar.TEST_SPECS)

    _, res2 = train_cifar.main(_base(tmp_path, ["--load", run]), device="cpu")
    assert pt.isdir(run + "---CNTD")
    assert res2["mean_auc"] == pytest.approx(res["mean_auc"], abs=1e-6)


def test_multiscale_runs_and_reuses_magnitude0(tmp_path, monkeypatch):
    """multiscale_cifar on the CPU: a train_nominal sweep over magnitudes 0
    and 2 trains twice; a test_anomalous sweep trains magnitude 0 only and
    evaluates its snapshot at magnitude 2 with epochs=0."""
    from eoe_tpu_torch.main import multiscale_cifar
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    aucs = multiscale_cifar.main(_base(tmp_path, ["--ms-mode", "lpf+train_nominal",
                                                  "--magnitudes", "0", "2"]), device="cpu")
    assert len(aucs) == 2 and all(np.isfinite(a) for a, _ in aucs)
    aucs = multiscale_cifar.main(_base(tmp_path, ["--ms-mode", "hpf+test_anomalous",
                                                  "--magnitudes", "0", "2"]), device="cpu")
    assert len(aucs) == 2 and all(np.isfinite(a) for a, _ in aucs)
    outer = [d for d in _runs(tmp_path, "log_*_MULTISCALE_*")]
    assert [pt.basename(d).split("_", 2)[2] for d in outer] == [
        "MULTISCALE_hsc_lpf+train_nominal_OEinf", "MULTISCALE_hsc_hpf+test_anomalous_OEinf"]
    res = json.load(open(pt.join(outer[1], "results.json")))
    assert res["magnitudes"] == [0, 2] and res["ms_mode"] == ["hpf+test_anomalous--M2"]
    for d, trained in ((outer[0], (True, True)), (outer[1], (True, False))):
        runs = [glob.glob(pt.join(d, f"log_*_magnitude_{m}"))[0] for m in (0, 2)]
        for run, t in zip(runs, trained):
            printed = open(pt.join(run, "print.txt")).read()
            assert ("epoch 1/1" in printed) == t and ("Loaded snapshot" in printed) != t
    setup = json.load(open(pt.join(runs[1], "setup.json")))
    assert setup["msms"] == ["hpf+test_anomalous--M2"]


def test_train_clip_cifar_from_a_checkpoint_file(tmp_path, monkeypatch):
    """train_clip_cifar on the CPU from a tiny OpenAI-format checkpoint named
    by ``EOE_TPU_CLIP_CHECKPOINT``: finite AUROC, bf16 by default, the raw
    runner specs in setup.json."""
    from eoe_tpu_torch.main import train_clip_cifar
    from eoe_tpu_torch.models.clip import CLIP, ClipConfig, to_openai
    cfg = ClipConfig(embed_dim=32, image_resolution=32, vision_layers=1, vision_width=64,
                     vision_patch_size=8, context_length=77, vocab_size=49408,
                     transformer_width=64, transformer_heads=1, transformer_layers=1)
    ckpt = tmp_path / "ViT-tiny.pt"
    torch.save(to_openai(CLIP(cfg, generator=torch.Generator().manual_seed(0)).state_dict(),
                         cfg), ckpt)
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    monkeypatch.setenv("EOE_TPU_CLIP_CHECKPOINT", str(ckpt))
    _, res = train_clip_cifar.main(_base(tmp_path, ["--oe-size", "64"]), device="cpu")
    assert np.isfinite(res["mean_auc"])
    run = _runs(tmp_path)[0]
    assert pt.basename(run).endswith("_clip_cifar10_one_vs_rest_E1")
    setup = json.load(open(pt.join(run, "setup.json")))
    assert setup["compute_dtype"] == "bfloat16" and setup["oe_limit_samples"] == 64
    assert setup["train_specs"] == train_clip_cifar.TRAIN_SPECS and setup["test_specs"] == []


TINY_CLIP = dict(embed_dim=32, image_resolution=32, vision_layers=1, vision_width=64,
                 vision_patch_size=8, context_length=77, vocab_size=49408,
                 transformer_width=64, transformer_heads=1, transformer_layers=1)


def _imagenet_blobs(root, rng):
    """ImageNet-30 train/val and an ImageNet-21k tree (one wnid of the 1k,
    left out), each decoded into its 256x256 blob."""
    from PIL import Image
    from eoe_tpu_torch.datasets.folder import build_blob

    def write(folder, n):
        os.makedirs(folder, exist_ok=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (24, 24, 3), np.uint8)).save(
                pt.join(folder, f"{i}.png"))

    ds = root / "datasets"
    for cls, n_train in (("acorn", 6), ("airliner", 2), ("banjo", 2)):
        write(ds / "imagenet_ad" / "train" / cls, n_train)
        write(ds / "imagenet_ad" / "val" / cls, 2)
    for wnid in ("n00000001", "n02690373", "n00000002"):
        write(ds / "imagenet22k" / "fall11_whole_extracted" / wnid, 3)
    for folder in ("imagenet_ad/train", "imagenet_ad/val", "imagenet22k/fall11_whole_extracted"):
        build_blob(str(ds / folder), (256, 256))


def test_train_clip_imagenet_from_a_checkpoint_file(tmp_path, monkeypatch, rng):
    """train_clip_imagenet on the CPU on a tiny tree of blobs (ImageNet-21k as
    OE), from a tiny OpenAI-format checkpoint: finite AUROC, and
    ``AnomalyScorer`` on the run's snapshot gives the run's scores to 1e-4."""
    from eoe_tpu_torch.datasets import load_dataset
    from eoe_tpu_torch.datasets.imagenet import AD_CLASSES
    from eoe_tpu_torch.inference import AnomalyScorer
    from eoe_tpu_torch.main import train_clip_imagenet
    from eoe_tpu_torch.models.clip import CLIP, ClipConfig, to_openai
    from eoe_tpu_torch.training.clip import prompt_center
    cfg = ClipConfig(**TINY_CLIP)
    ckpt = tmp_path / "ViT-tiny.pt"
    torch.save(to_openai(CLIP(cfg, generator=torch.Generator().manual_seed(0)).state_dict(),
                         cfg), ckpt)
    monkeypatch.setenv("EOE_TPU_CLIP_CHECKPOINT", str(ckpt))
    _imagenet_blobs(tmp_path, rng)
    _, res = train_clip_imagenet.main(_base(tmp_path, ["-b", "4"]), device="cpu")
    assert np.isfinite(res["mean_auc"])
    run = _runs(tmp_path)[0]
    assert pt.basename(run).endswith("_clip_imagenet_one_vs_rest_E1")
    setup = json.load(open(pt.join(run, "setup.json")))
    assert setup["oe_dataset"] == "imagenet21k" and setup["compute_dtype"] == "bfloat16"
    scores = json.load(open(pt.join(run, "eval_cls0_it0_anomaly_scores.json")))
    scores = np.asarray([scores[k] for k in sorted(scores, key=int)])
    test_set = load_dataset("imagenet", str(tmp_path / "datasets"), [0], 0,
                            train_clip_imagenet.TRAIN_SPECS, []).test_set
    assert len(scores) == len(test_set) == 6
    model = CLIP(cfg, dtype=torch.bfloat16)
    snapshot = torch.load(pt.join(run, "snapshots", "snapshot_cls0_it0.pt"),
                          map_location="cpu", weights_only=True)
    model.load_state_dict(snapshot["params"])
    center = prompt_center(model, AD_CLASSES[0], AD_CLASSES, device="cpu")
    scorer = AnomalyScorer(snapshot, model, objective="clip", batch_size=4, center=center,
                           compute_dtype=torch.bfloat16, device="cpu",
                           test_specs=[{"op": "clip_pil_preprocessing",
                                        "resolution": cfg.image_resolution},
                                       {"op": "clip_tensor_preprocessing"}])
    np.testing.assert_allclose(scorer.score(test_set.gather_all()), scores, rtol=0, atol=1e-4)


def test_train_custom_streams_and_keys_scores_by_file(tmp_path, monkeypatch, rng):
    """train_custom on the CPU on a general-layout PNG tree with the folder
    cache at 0 (the normal half and the test split stream) and the custom
    set as its own OE: finite AUROC, the per-file score keys of the JAX
    package's dataset, the classes read from the folders."""
    from PIL import Image
    from eoe_tpu.datasets.custom import ADCustomDS as JaxCustom
    from eoe_tpu_torch.datasets import DS_CHOICES
    from eoe_tpu_torch.datasets.custom import ADCustomDS
    from eoe_tpu_torch.datasets.folder import FolderSource
    from eoe_tpu_torch.main import train_custom
    for split in ("train", "test"):
        for cls in ("screw", "nut"):
            for sub, n in (("normal", 3), ("anomalous", 2)):
                folder = tmp_path / "datasets" / "custom" / split / cls / sub
                os.makedirs(folder)
                for i in range(n):
                    Image.fromarray(rng.integers(0, 256, (20, 20, 3), np.uint8)).save(
                        str(folder / f"{i}.png"))
    for cls in (ADCustomDS, JaxCustom):
        monkeypatch.setattr(cls, "classes", [])
        monkeypatch.setattr(cls, "ovr", False)
    monkeypatch.setitem(DS_CHOICES, "custom", dict(DS_CHOICES["custom"]))
    monkeypatch.setattr(FolderSource, "DEFAULT_CACHE_BYTES", 0)
    _, res = train_custom.main(_base(tmp_path, ["-b", "2", "-oe", "custom",
                                                "--custom-dataset-default-size", "64"]),
                               device="cpu")
    assert np.isfinite(res["mean_auc"])
    assert DS_CHOICES["custom"]["str_labels"] == ["nut", "screw"]
    run = _runs(tmp_path)[0]
    assert pt.basename(run).endswith("_hsc_custom_")
    scores = json.load(open(pt.join(run, "eval_cls0_it0_anomaly_scores.json")))
    JaxCustom.classes = []
    want = JaxCustom(str(tmp_path / "datasets"), [0], 0, [], [], (8, 8, 3)).test_set
    assert list(scores) == want.sample_keys == [
        "nut/anomalous/0.png", "nut/anomalous/1.png", "nut/normal/0.png", "nut/normal/1.png",
        "nut/normal/2.png"]
    assert np.isfinite(list(scores.values())).all()
