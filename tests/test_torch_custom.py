"""The port's custom models (``models.custom_base.CustomNet``,
``models.custom.WideResNetCustom``), the Trainer's freeze and its
feature-model-only and trunk-only snapshot loads, against the JAX package's
on the CPU; then ``train_only_custom`` and ``inference_custom`` end to end on
a small PNG tree (the port alone: the JAX runners are held end to end by
tests/test_main.py, a slow module).

Weights cross with ``models.convert`` (the CustomNet tree is the
``feature_model`` subtree and ``final_linear``). The held step uses the
trainers' own optimizer, Adam, with the feature model frozen; a test-local
CustomNet over a narrow CNN32 keeps the JAX step's compile small."""

import glob
import json
import os
import os.path as pt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from eoe_tpu.datasets import bases as JB
from eoe_tpu.models.cnn import CNN32 as JaxCNN32
from eoe_tpu.models.custom import WideResNetCustom as JaxWRNCustom
from eoe_tpu.models.custom_base import CustomNet as JaxCustomNet
from eoe_tpu.training.trainer import Trainer as JaxTrainer, TrainState as JaxState
from eoe_tpu.utils.logger import Logger as JaxLogger
from eoe_tpu_torch.datasets import bases as B
from eoe_tpu_torch.models import CNN32
from eoe_tpu_torch.models.convert import from_flax, to_flax_numpy
from eoe_tpu_torch.models.custom import WideResNetCustom
from eoe_tpu_torch.models.custom_base import CustomNet, frozen_param_labels
from eoe_tpu_torch.training import TRAINER

BATCH, N_NORMAL, N_OE, N_TEST = 8, 16, 16, 8
STATS = {"mean": [0.45, 0.5, 0.55], "std": [0.25, 0.3, 0.2], "mode": 0}
COMMON = dict(dataset="cifar10", oe_dataset="cifar100", datapath="", lr=1e-3, wdk=1e-2,
              milestones=[], batch_size=BATCH, epochs=1)


class SmallCustom(CustomNet):
    feature_dim = 32

    def build_feature_model(self):
        return CNN32(rep_dim=32)


class JaxSmallCustom(JaxCustomNet):
    feature_dim: int = 32

    def features(self, x, train: bool = True):
        return JaxCNN32(rep_dim=32, name=self.FEATURE_COLLECTION)(x, train)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _random_variables(jax_model, x, seed=1):
    """Flax variables of ``jax_model`` (the tree of its ``init``, by
    ``eval_shape``) filled from a seeded numpy generator: kernels scaled by
    their fan-in, BN affines and running averages away from their init."""
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.key(0), x, train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])), leaf.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape)
        return rng.normal(0, 0.1, leaf.shape)

    return jax.tree_util.tree_map_with_path(lambda p, v: fill(p, v).astype(np.float32), shapes)


@pytest.mark.parametrize("head,clf", [(True, False), (True, True), (False, False)])
def test_wrn_custom_matches_jax(head, clf):
    """WideResNetCustom from the JAX package's variables: the same features in
    eval mode (fp32, 1e-4 of the largest) and the same modules. (Train mode
    is held on the WideResNet itself, tests/test_torch_conv_models.py, and on
    a CustomNet below.)"""
    x = np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32)
    jm = JaxWRNCustom(prediction_head=head, clf=clf)
    variables = _random_variables(jm, jnp.asarray(x))
    assert set(variables["params"]) == ({"feature_model", "final_linear"} if head
                                        else {"feature_model"})
    model = WideResNetCustom(prediction_head=head, clf=clf)
    sd = from_flax(variables)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    got = model.eval()(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    assert got.shape == want.shape == (2, 1 if clf else 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_custom_net_train_mode_matches_jax():
    """A CustomNet in train mode: the features and the feature model's
    updated batch statistics, from the JAX package's variables."""
    x = np.random.default_rng(0).normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    jm = JaxSmallCustom()
    variables = _random_variables(jm, jnp.asarray(x))
    model = SmallCustom()
    model.load_state_dict(from_flax(variables))
    got = model.train()(torch.from_numpy(x)).detach().numpy()
    want, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())
    stats = dict(_flat(to_flax_numpy(model.state_dict())["batch_stats"]))
    for k, v in _flat(jax.device_get(mut["batch_stats"])):
        np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-5)


def test_no_head_classification_error_matches_jax():
    x = np.zeros((1, 32, 32, 3), np.float32)
    with pytest.raises(ValueError) as theirs:
        JaxWRNCustom(prediction_head=False, clf=True).init(jax.random.key(0), jnp.asarray(x))
    with pytest.raises(ValueError) as ours:
        WideResNetCustom(prediction_head=False, clf=True)(torch.from_numpy(x))
    assert str(ours.value) == str(theirs.value)
    assert str(ours.value).startswith("WideResNetCustom is used with a classification loss")


def test_custom_net_head_init():
    """final_linear is nn.Linear's init: weight and bias uniform within
    1/sqrt(feature_dim); 1 output for classification, 256 otherwise."""
    for clf in (False, True):
        m = SmallCustom(clf=clf)
        bound = 1 / np.sqrt(32)
        assert m.final_linear.weight.shape == (1 if clf else 256, 32)
        for p in (m.final_linear.weight, m.final_linear.bias):
            assert p.abs().max() <= bound and p.abs().max() > 0.5 * bound
    labels = frozen_param_labels(SmallCustom(freeze=True), True)
    assert {k.split(".")[0] for k, v in labels.items() if v == "frozen"} == {"feature_model"}
    assert set(frozen_param_labels(SmallCustom(), False).values()) == {"trainable"}


def _data():
    rng = np.random.default_rng(0)
    return tuple(rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
                 for n in (N_NORMAL, N_OE, N_TEST))


def _combined(mod):
    x, xo, xt = _data()
    kw = dict(root="", train_specs=["normalize"], test_specs=["normalize"], n_classes=2,
              raw_shape=(32, 32, 3), ds_statistics=STATS)
    normal = mod.GenericADDataset(mod.ArraySource(x, np.zeros(N_NORMAL)),
                                  mod.ArraySource(xt, np.arange(N_TEST) % 2),
                                  normal_classes=(0,), nominal_label=0, **kw)
    oe = mod.GenericADDataset(mod.ArraySource(xo, np.ones(N_OE)), None,
                              normal_classes=(1,), nominal_label=1, **kw)
    return mod.CombinedDataset(normal, oe)


def _jax_state(jt, variables, steps=2):
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    tx = jt.make_optimizer(steps)
    return tx, JaxState(params=variables["params"], batch_stats=variables["batch_stats"],
                        opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))


def test_frozen_adam_step_matches_jax():
    """One Adam step (weight decay on) with the feature model frozen: its
    parameters stay bit for bit, its batch statistics move as the JAX step's
    (1e-5), and final_linear takes the JAX step's update (1e-5)."""
    model = SmallCustom(freeze=True)
    port = TRAINER["hsc"](model=model, train_specs=["normalize"], test_specs=["normalize"],
                          logger=None, device="cpu", **COMMON)
    ds = _combined(B)
    state = port.init_state(3, ds, 2)
    init = to_flax_numpy(model.state_dict())
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert trainable == ["final_linear.weight", "final_linear.bias"]
    assert model.feature_model.training is True   # freezing keeps train mode
    x, xo, _ = _data()
    i_n, i_o, w = (a[0] for a in B.BalancedEpochSampler(N_NORMAL, N_OE, BATCH, 7).epoch())
    loss, *_ = port.train_step(state, ds, torch.from_numpy(x[i_n]),
                               torch.zeros(BATCH, dtype=torch.int64), torch.from_numpy(xo[i_o]),
                               torch.ones(BATCH, dtype=torch.int64), torch.from_numpy(w), None)
    after = dict(_flat(to_flax_numpy(model.state_dict())))

    jt = JaxTrainer(model=JaxSmallCustom(freeze=True), train_specs=["normalize"],
                    test_specs=["normalize"], logger=JaxLogger("", active=False),
                    objective="hsc", **COMMON)
    tx, jstate = _jax_state(jt, init)
    step = jax.jit(jt._train_step_core(_combined(JB), tx, True))
    jstate, (jloss, *_) = step(jstate, jnp.asarray(x[i_n]), jnp.zeros(BATCH, jnp.int32),
                               jnp.asarray(xo[i_o]), jnp.ones(BATCH, jnp.int32), jnp.asarray(w),
                               jax.random.key(0), None, None)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = dict(_flat({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    before = dict(_flat(init))
    assert after.keys() == want.keys() == before.keys()
    for key in after:
        if key[0] == "params" and key[1] == "feature_model":
            np.testing.assert_array_equal(after[key], before[key])
            np.testing.assert_array_equal(np.asarray(want[key]), before[key])
        else:
            np.testing.assert_allclose(after[key], want[key], rtol=1e-5, atol=1e-5)
            assert not np.array_equal(after[key], before[key]), key   # it moved


def _loaded(side, payload_kind, snap, init, tmp_path, capsys):
    """A fresh state (weights ``init``) after loading the ``snap`` weights as
    a ``payload_kind`` snapshot, as Flax variables, with the epoch and what
    the trainer printed."""
    feature_params = {"params": snap["params"]["feature_model"]}
    feature_stats = {"batch_stats": snap["batch_stats"]["feature_model"]}
    if side == "port":
        port = TRAINER["hsc"](model=SmallCustom(), train_specs=["normalize"],
                              test_specs=["normalize"], logger=None, device="cpu", **COMMON)
        state = port.init_state(0, _combined(B), 2)
        state.model.load_state_dict(from_flax(init))
        fm = {k.split(".", 1)[1]: v for k, v in from_flax(snap).items()
              if k.startswith("feature_model.")}
        if payload_kind == "features":
            payload = {k: v for k, v in fm.items() if not k.startswith("running")
                       and ".running_" not in k}
        elif payload_kind == "features_with_stats":
            payload = fm
        else:
            payload = {"params": {f"feature_model.{k}": v for k, v in fm.items()}}
        torch.save(payload, tmp_path / "snap.pt")
        state, epoch = port.load(str(tmp_path / "snap.pt"), state)
        out = to_flax_numpy(state.model.state_dict())
    else:
        jt = JaxTrainer(model=JaxSmallCustom(), train_specs=["normalize"],
                        test_specs=["normalize"], logger=JaxLogger("", active=False),
                        objective="hsc", **COMMON)
        _, state = _jax_state(jt, init)
        payload = (feature_params["params"] if payload_kind == "features" else
                   {"params": {"feature_model": feature_params["params"]},
                    "batch_stats": {"feature_model": feature_stats["batch_stats"]}})
        with open(tmp_path / "snap.msgpack", "wb") as f:
            f.write(serialization.msgpack_serialize(payload))
        state, epoch = jt.load(str(tmp_path / "snap.msgpack"), state)
        out = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    return dict(_flat(out)), epoch, capsys.readouterr().out


@pytest.mark.parametrize("kind", ["features", "trunk"])
def test_snapshot_loads_match_jax(kind, tmp_path, capsys):
    """A feature-model-only state dict loads into ``feature_model`` (epoch 0,
    the head and, with parameters alone, the batch statistics kept); a
    trunk-only snapshot restores the feature model's parameters and batch
    statistics and keeps the head's fresh init. As the JAX package does,
    with its message."""
    init = to_flax_numpy(SmallCustom().state_dict())
    other = SmallCustom()
    other.reset_parameters(torch.Generator().manual_seed(5))
    for m in other.modules():   # batch statistics that differ from a fresh init
        if hasattr(m, "running_mean"):
            m.running_mean.uniform_(-1, 1)
            m.running_var.uniform_(0.5, 2)
    snap = to_flax_numpy(other.state_dict())
    got, ep, printed = _loaded("port", kind, snap, init, tmp_path, capsys)
    want, jep, jprinted = _loaded("jax", kind, snap, init, tmp_path, capsys)
    assert ep == jep == 0
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])
        source = snap if key[1] == "feature_model" and (
            key[0] == "params" or kind == "trunk") else init
        np.testing.assert_array_equal(got[key], dict(_flat(source))[key])
    message = ("Loaded pre-trained weights for feature model of CustomNet." if kind == "features"
               else "Loaded trunk-only snapshot; fresh init kept for ['final_linear']")
    assert message in printed and message in jprinted
    if kind == "features":   # a full state dict also brings its batch statistics
        got, _, _ = _loaded("port", "features_with_stats", snap, init, tmp_path, capsys)
        for key in got:
            source = snap if key[1] == "feature_model" else init
            np.testing.assert_array_equal(got[key], dict(_flat(source))[key])


def _write_splitless_custom(root, rng, n_normal=10, n_anom=4):
    for folder, n, col in (("normal", n_normal, 40), ("anomalous", n_anom, 200)):
        os.makedirs(pt.join(root, folder), exist_ok=True)
        for i in range(n):
            arr = np.full((40, 40, 3), col, np.uint8) + rng.integers(0, 30, (40, 40, 3),
                                                                     dtype=np.uint8)
            Image.fromarray(arr).save(pt.join(root, folder, f"{i}.png"))


@pytest.fixture
def custom_classes(monkeypatch):
    """The runners set ADCustomDS's class attributes; restore them."""
    from eoe_tpu_torch.datasets import DS_CHOICES
    from eoe_tpu_torch.datasets.custom import ADCustomDS
    for name in ("train_only", "eval_only", "base_folder", "classes"):
        monkeypatch.setattr(ADCustomDS, name, getattr(ADCustomDS, name))
    monkeypatch.setitem(DS_CHOICES, "custom", dict(DS_CHOICES["custom"]))
    return ADCustomDS


def test_train_only_and_inference_custom(tmp_path, rng, custom_classes):
    """tests/test_main.py's case in the port: train_only_custom on 14 PNGs
    without a test, then inference_custom on its snapshot: AUROC above 0.9
    on separable colours, scores keyed by relative file path."""
    from eoe_tpu_torch.main import inference_custom, train_only_custom
    data = str(tmp_path / "data")
    _write_splitless_custom(data, rng)
    _, res = train_only_custom.main([
        "-e", "2", "--iterations", "1", "-b", "8", "--custom-dataset-path", data,
        "--log-path", str(tmp_path / "train"), "--image-resize", "32", "--image-crop", "28",
        "28"], device="cpu")
    assert np.isnan(res["mean_auc"])   # no test
    assert custom_classes.train_only and custom_classes.classes == ["data"]
    snaps = glob.glob(str(tmp_path / "train" / "**" / "snapshot_cls0_it0.pt"), recursive=True)
    assert snaps
    run = pt.dirname(pt.dirname(snaps[0]))
    assert pt.exists(pt.join(run, "training_cls0-data_preview.png"))
    custom_classes.train_only = False
    custom_classes.base_folder = "custom"
    custom_classes.classes = []
    _, res = inference_custom.main([
        "-b", "8", "--custom-dataset-path", data, "--log-path", str(tmp_path / "infer"),
        "--custom-model-snapshot", snaps[0], "--image-resize", "32", "--image-crop", "28",
        "28"], device="cpu")
    assert res["mean_auc"] > 0.9
    sfiles = glob.glob(str(tmp_path / "infer" / "**" / "eval_cls0_it0_anomaly_scores.json"),
                       recursive=True)
    scores = json.load(open(sfiles[0]))
    assert len(scores) == 14 and all("/" in k for k in scores)
    assert sorted(scores)[:2] == ["anomalous/0.png", "anomalous/1.png"]
    assert pt.exists(pt.join(pt.dirname(sfiles[0]), "eval_cls0-data_preview.png"))


def test_train_only_custom_freeze_from_a_feature_snapshot(tmp_path, rng, custom_classes):
    """--custom-model-freeze from a feature-model state dict: the feature
    model's parameters end as loaded, the head moves, and the feature
    model's batch statistics move."""
    from eoe_tpu_torch.main import train_only_custom
    data = str(tmp_path / "data")
    _write_splitless_custom(data, rng)
    features = WideResNetCustom().feature_model
    features.reset_parameters(torch.Generator().manual_seed(3))
    torch.save(features.state_dict(), tmp_path / "features.pt")
    train_only_custom.main([
        "-e", "1", "--iterations", "1", "-b", "8", "--custom-dataset-path", data,
        "--log-path", str(tmp_path / "train"), "--image-resize", "32", "--image-crop", "28",
        "28", "--custom-model-freeze", "--custom-model-add-prediction-head",
        "--custom-model-snapshot", str(tmp_path / "features.pt")], device="cpu")
    snap = glob.glob(str(tmp_path / "train" / "**" / "snapshot_cls0_it0.pt"), recursive=True)[0]
    params = torch.load(snap, weights_only=True)["params"]
    fresh = WideResNetCustom(prediction_head=True).state_dict()
    for k, v in features.state_dict().items():
        got = params[f"feature_model.{k}"]
        if "running" in k:
            assert not torch.equal(got, v), k
        else:
            assert torch.equal(got, v), k
    for k in ("final_linear.weight", "final_linear.bias"):
        assert not torch.equal(params[k], fresh[k])
    with open(pt.join(pt.dirname(pt.dirname(snap)), "print.txt")) as f:
        assert "Loaded pre-trained weights for feature model of CustomNet." in f.read()
