"""Reference torch snapshots into the port: ``models.resnet50``,
``models.torch_import`` and ``main.import_snapshot`` against the JAX
package's.

The reference's torch modules are not in the repository, so the reference
snapshots are written here under the reference's names (torch's layouts,
its c-major flatten before CNN32's fc1, torch's ``num_batches_tracked``
counters) from port models drawn from a seed, with batch norms carrying
numpy-drawn averages. Both packages import each file; the port's result
must equal the JAX package's carried across with ``from_flax`` exactly
(both are plain copies) and the source weights after the name map.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from eoe_tpu.models.resnet50 import (WideResNet50Pretrained as JaxWRN50,
                                     load_torchvision_state_dict as jax_load_tv)
from eoe_tpu.models.torch_import import import_torch_snapshot as jax_import
from eoe_tpu_torch.models import CNN32, WideResNet, WideResNet50Pretrained
from eoe_tpu_torch.models import convert
from eoe_tpu_torch.models.clip import CLIP, ClipConfig, to_openai
from eoe_tpu_torch.models.clip import from_flax as clip_from_flax
from eoe_tpu_torch.models.layers import BatchNorm
from eoe_tpu_torch.models.resnet50 import load_torchvision_state_dict
from eoe_tpu_torch.models.torch_import import import_torch_snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = {"mean": torch.tensor([0.5, 0.4, 0.3]), "std": torch.tensor([0.2, 0.25, 0.3])}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomise_bn(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.running_mean.shape[0]
                pairs = [(m.running_mean, -0.1, 0.1), (m.running_var, 0.5, 1.5)]
                if m.weight is not None:
                    pairs += [(m.weight, 0.5, 1.5), (m.bias, -0.2, 0.2)]
                for t, lo, hi in pairs:
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32)))
    return model


def _with_counters(sd):
    """torch's BatchNorm keeps a ``num_batches_tracked`` beside its averages."""
    out = dict(sd)
    for k in sd:
        if k.endswith(".running_mean"):
            out[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(7)
    return out


def _reference_cnn32(model):
    """The reference CNN32's state dict: fc1 takes the NCHW flatten."""
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    w = sd["fc1.weight"]
    sd["fc1.weight"] = w.reshape(w.shape[0], 4, 4, 128).permute(0, 3, 1, 2).reshape(
        w.shape[0], -1).contiguous()
    return _with_counters(sd)


_WRN_NAMES = [(r"layer(\d)_block(\d)", r"layer\1.\2"), (r"down_conv", "downsample.0"),
              (r"down_bn", "downsample.1"), (r"channel_gate\.mlp_hidden", "ChannelGate.mlp.1"),
              (r"channel_gate\.mlp_out", "ChannelGate.mlp.3"),
              (r"spatial_gate\.spatial_conv", "SpatialGate.spatial.conv"),
              (r"spatial_gate\.spatial_bn", "SpatialGate.spatial.bn")]
_TV_NAMES = [(r"^layer(\d)_(\d+)", r"layer\1.\2"), (r"down_conv", "downsample.0"),
             (r"down_bn", "downsample.1")]


def _renamed(sd, rules):
    out = {}
    for k, v in sd.items():
        for pattern, repl in rules:
            k = re.sub(pattern, repl, k)
        out[k] = v.clone()
    return _with_counters(out)


def _torchvision(layers, seed=3):
    """A torchvision-named wide_resnet50_2 state dict (its 1000-way fc
    included) from a port trunk drawn from ``seed``."""
    model = WideResNet50Pretrained(layers=layers)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = _randomise_bn(model, seed)
    sd = {k: v for k, v in model.state_dict().items() if not k.startswith("fc.")}
    sd = _renamed(sd, _TV_NAMES)
    rng = np.random.default_rng(seed)
    sd["fc.weight"] = torch.from_numpy(rng.normal(0, 0.01, (1000, 2048)).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def _jax_payload(path, tmp_path):
    out = jax_import(str(path), str(tmp_path / "jax.msgpack"))
    with open(out, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _assert_equal(ours: dict, theirs: dict):
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == torch.float32 and torch.equal(ours[k], theirs[k]), k


# ------------------------------------------------------------ WideResNet50


def test_wide_resnet50_matches_jax():
    """``layers=(1, 1, 1, 1)``: ``load_torchvision_state_dict`` equals the
    JAX converter's trunk carried over exactly, and the model with the JAX
    variables (fresh head included) gives the JAX forward: eval 1e-5,
    train 1e-4, and the train step's new running averages 1e-4."""
    layers = (1, 1, 1, 1)
    sd = _torchvision(layers)
    trunk = load_torchvision_state_dict(sd, layers)
    jtrunk = jax_load_tv(sd, layers)
    _assert_equal(trunk, convert.from_flax(jtrunk))

    jm = JaxWRN50(rep_dim=16, layers=layers)
    init = jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False)
    variables = {"params": {**init["params"], **jtrunk["params"]},
                 "batch_stats": jtrunk["batch_stats"]}
    model = WideResNet50Pretrained(rep_dim=16, layers=layers)
    model.load_state_dict(convert.from_flax(jax.device_get(variables)))
    assert torch.equal(model.conv1.weight, trunk["conv1.weight"])
    x = np.random.default_rng(5).normal(0, 1, (4, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ours_eval = model.eval()(torch.from_numpy(x)).numpy()
        ours_train = model.train()(torch.from_numpy(x)).numpy()
    theirs_eval = jm.apply(variables, jnp.asarray(x), train=False)
    theirs_train, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    np.testing.assert_allclose(ours_eval, np.asarray(theirs_eval), atol=1e-5)
    np.testing.assert_allclose(ours_train, np.asarray(theirs_train), atol=1e-4)
    moved = convert.from_flax({"batch_stats": jax.device_get(mutated["batch_stats"])})
    for k, v in moved.items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(), atol=1e-4,
                                   err_msg=k)


# ------------------------------------------------------------ import_torch_snapshot


def _snapshots(tmp_path):
    """(name, reference snapshot path, the port model the import loads into,
    the port source state dict the import must give back)."""
    out = []
    cnn = CNN32(rep_dim=64)
    cnn.reset_parameters(torch.Generator().manual_seed(1))
    cnn = _randomise_bn(cnn, 1)
    path = tmp_path / "cnn32.pt"
    torch.save({"net": _reference_cnn32(cnn), "opt": {"state": {}}, "sched": None, "epoch": 7,
                "ds_statistics": STATS}, path)
    out.append(("cnn32", path, CNN32(rep_dim=64), cnn.state_dict()))

    wrn = _randomise_bn(WideResNet(rep_dim=32, layers=(1, 1, 1, 1)), 2)
    path = tmp_path / "wrn.pt"
    torch.save({"net": _renamed(wrn.state_dict(), _WRN_NAMES), "epoch": 3}, path)
    out.append(("wrn_cbam", path, WideResNet(rep_dim=32, layers=(1, 1, 1, 1)),
                wrn.state_dict()))

    layers = (1, 2)
    tv = _torchvision(layers)
    path = tmp_path / "wide_resnet50_2.pt"
    torch.save(tv, path)
    trunk = WideResNet50Pretrained(layers=layers)
    out.append(("wrn50_trunk", path, trunk, load_torchvision_state_dict(tv, layers)))

    cfg = ClipConfig(embed_dim=32, image_resolution=32, vision_layers=1, vision_width=64,
                     vision_patch_size=8, context_length=77, transformer_width=64,
                     transformer_heads=1, transformer_layers=1)
    clip = CLIP(cfg, generator=torch.Generator().manual_seed(4))
    path = tmp_path / "clip.pt"
    torch.save({"net": to_openai(clip.state_dict(), cfg, torch.float32), "epoch": 2,
                "ds_statistics": None}, path)
    out.append(("clip", path, CLIP(cfg), clip.state_dict()))
    return out


@pytest.mark.parametrize("which", ["cnn32", "wrn_cbam", "wrn50_trunk", "clip"])
def test_import_equals_jax_and_the_source(tmp_path, which):
    name, path, model, source = next(s for s in _snapshots(tmp_path) if s[0] == which)
    out = import_torch_snapshot(str(path), str(tmp_path / "port.pt"))
    payload = torch.load(out, weights_only=True)
    theirs = _jax_payload(path, tmp_path)
    if which == "clip":
        carried = clip_from_flax(theirs["params"], theirs.get("batch_stats") or None)
    else:
        carried = convert.from_flax({k: theirs[k] for k in ("params", "batch_stats")
                                     if theirs.get(k)})
    _assert_equal(payload["params"], carried)
    _assert_equal(payload["params"], {k: source[k].float() for k in payload["params"]})
    assert payload["epoch"] == theirs["epoch"] and payload["opt_state"] == {}
    assert payload["ds_statistics"] == theirs["ds_statistics"]
    assert payload["setup"] == {"imported_from": str(path)}
    if which == "wrn50_trunk":   # a trunk: every module but the fresh head
        assert {k.split(".")[0] for k in payload["params"]} < {
            k.split(".")[0] for k in model.state_dict()}
        assert not any(k.startswith("fc.") for k in payload["params"])
    else:
        model.load_state_dict(payload["params"])   # strict: every key and shape


def test_cnn32_fc1_takes_the_reference_flatten(tmp_path):
    """The reference flattens NCHW (c-major) before fc1, the port (h, w, c):
    the imported fc1 applied to the port's flatten equals the reference fc1
    applied to the c-major flatten of the same activations, and the whole
    forward equals the JAX CNN32's with the JAX import's variables."""
    from eoe_tpu.models.cnn import CNN32 as JaxCNN32
    _, path, model, _ = _snapshots(tmp_path)[0]
    out = import_torch_snapshot(str(path), str(tmp_path / "port.pt"))
    model.load_state_dict(torch.load(out, weights_only=True)["params"])
    model.eval()
    ref_fc1 = torch.load(path, weights_only=False)["net"]["fc1.weight"]
    seen = {}
    model.fc1.register_forward_hook(lambda m, a, y: seen.update(x=a[0], y=y))
    x = np.random.default_rng(6).normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    nchw = seen["x"].reshape(4, 4, 4, 128).permute(0, 3, 1, 2).reshape(4, -1)
    with torch.no_grad():
        ref_y = nchw @ ref_fc1.T + model.fc1.bias
    np.testing.assert_allclose(seen["y"].numpy(), ref_y.numpy(), atol=1e-5)
    theirs = _jax_payload(path, tmp_path)
    jm = JaxCNN32(rep_dim=64)
    want = jm.apply({"params": theirs["params"], "batch_stats": theirs["batch_stats"]},
                    jnp.asarray(x), train=False)
    np.testing.assert_allclose(ours, np.asarray(want), atol=1e-5)


def test_import_raises_as_jax(tmp_path):
    cases = {
        "unknown": ({"net": {"foo.weight": torch.zeros(2)}}, "Cannot sniff"),
        "bare": ({"conv1.weight": torch.zeros(2), "fc1.weight": torch.zeros(2)},
                 "bare feature-model"),
        "no_net": ({"epoch": 3, "weights": [1, 2]}, "no 'net' entry"),
    }
    for name, (obj, match) in cases.items():
        path = tmp_path / f"{name}.pt"
        torch.save(obj, path)
        for fn, out in ((import_torch_snapshot, "port.pt"), (jax_import, "jax.msgpack")):
            with pytest.raises(ValueError, match=match):
                fn(str(path), str(tmp_path / out))


def test_cli_then_runner_load(tmp_path, monkeypatch):
    """``python -m eoe_tpu_torch.main.import_snapshot`` into a run
    directory's snapshot, then ``train_cifar --load`` on that run: the
    imported CNN32 (epoch 1 of 1) is evaluated without training and
    snapshotted again unchanged."""
    from eoe_tpu_torch.main import train_cifar
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    base = ["-e", "1", "--classes", "0", "-it", "1", "-b", "32", "--oe-size", "64",
            "--datapath", str(tmp_path), "--no-vmap-seeds"]
    train_cifar.main(base, device="cpu")
    runs = sorted(d for d, _, files in os.walk(tmp_path / "results") if "setup.json" in files)
    run = runs[0]
    ref = _randomise_bn(CNN32(), 8)
    torch.save({"net": _reference_cnn32(ref), "epoch": 1, "ds_statistics": STATS},
               tmp_path / "ref.pt")
    target = os.path.join(run, "snapshots", "snapshot_cls0_it0.pt")
    proc = subprocess.run([sys.executable, "-m", "eoe_tpu_torch.main.import_snapshot",
                           str(tmp_path / "ref.pt"), target], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"Wrote {target}"
    _, res = train_cifar.main(["--load", run, "--datapath", str(tmp_path)], device="cpu")
    assert np.isfinite(res["mean_auc"])
    cont = run + "---CNTD"
    again = torch.load(os.path.join(cont, "snapshots", "snapshot_cls0_it0.pt"),
                       weights_only=True)
    assert again["epoch"] == 1
    for k, v in ref.state_dict().items():
        assert torch.equal(again["params"][k], v), k
