"""The conv models of the port (CNN28, CNN32, AE32, CBAM, WideResNet) against
the JAX package's Flax modules, on the CPU at small sizes.

The port initialises the weights; ``models.convert.to_flax_numpy`` carries
them (params and batch_stats) to the Flax module. Both sides take the same
numpy-seeded NHWC inputs, in eval mode (running averages) and in train mode
(batch statistics, after which both update their running averages). The
``_unfused`` case runs both packages' WideResNet stems as plain compositions
under ``EOE_TPU_FUSED_STEM=0``, which both read at every forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.models.ae import AE32 as JaxAE32
from eoe_tpu.models.cbam import CBAM as JaxCBAM
from eoe_tpu.models.cnn import CNN28 as JaxCNN28, CNN32 as JaxCNN32
from eoe_tpu.models.resnet import WideResNet as JaxWideResNet
from eoe_tpu_torch.models import AE32, CNN28, CNN32, WideResNet
from eoe_tpu_torch.models.cbam import CBAM
from eoe_tpu_torch.models.convert import from_flax, to_flax_numpy
from eoe_tpu_torch.models.layers import BatchNorm, with_compute_dtype

TOL = 1e-5         # forward outputs, of their largest magnitude
STATS_TOL = 1e-6   # running averages after one train-mode call

# (name, port model, JAX model, input shape)
MODELS = [
    ("cnn28", lambda: CNN28(), lambda: JaxCNN28(), (8, 28, 28, 1)),
    ("cnn32", lambda: CNN32(), lambda: JaxCNN32(), (8, 32, 32, 3)),
    ("cnn32_clf", lambda: CNN32(clf=True), lambda: JaxCNN32(clf=True), (8, 32, 32, 3)),
    ("cnn32_nobias", lambda: CNN32(bias=False), lambda: JaxCNN32(bias=False), (8, 32, 32, 3)),
    ("ae32", lambda: AE32(), lambda: JaxAE32(), (8, 32, 32, 3)),
    ("wrn", lambda: WideResNet(layers=(1, 1, 1, 1)),
     lambda: JaxWideResNet(layers=(1, 1, 1, 1)), (4, 64, 64, 3)),
    ("wrn_clf_unfused", lambda: WideResNet(layers=(1, 1, 1, 1), clf=True),
     lambda: JaxWideResNet(layers=(1, 1, 1, 1), clf=True), (4, 32, 32, 3)),
]
# Where fp32 itself does not reach TOL or STATS_TOL in train mode, measured
# against an fp64 run of the same weights and inputs, both packages alike:
# AE32's sigmoid output (port 1.07e-5 off fp64, JAX 1.36e-5: the decoder
# amplifies the encoder's batch-statistics BNs), and the deep layers' batch
# variances of the WideResNet (port and JAX ~3e-6 and ~6e-6 off at the
# output). The unbiased-variance trap is 1/(n-1) of a variance, 1e-4 of a
# running average or more at every layer of these inputs.
TRAIN_TOL = {"ae32": 3e-5}
TRAIN_STATS_TOL = {"wrn": 1e-5, "wrn_clf_unfused": 1e-5}


def _stem_switch(name, monkeypatch):
    if name.endswith("_unfused"):
        monkeypatch.setenv("EOE_TPU_FUSED_STEM", "0")


def _inputs(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _jax_vars(sd):
    return jax.tree_util.tree_map(jnp.asarray, to_flax_numpy(sd))


def _perturb_bn(model, seed=1):
    """Running averages and BN affines away from their init, so that eval
    mode tests them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                if m.weight is not None:
                    m.weight.uniform_(0.5, 1.5, generator=g)
                    m.bias.normal_(0, 0.1, generator=g)


def _close(ours, theirs, tol=TOL):
    """Within ``tol`` of the reference's largest magnitude: a batch-statistics
    BN over 8 samples amplifies the summation-order differences of the convs
    before it (oneDNN against XLA) to ~5e-6 of an output of size ~3."""
    assert ours.shape == theirs.shape
    err = np.abs(ours - theirs).max() / max(np.abs(theirs).max(), 1e-30)
    assert err <= tol, err


def _leaves(tree):
    return {tuple(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name,port,jax_model,shape", MODELS, ids=[m[0] for m in MODELS])
def test_forward_eval_matches_jax(name, port, jax_model, shape, monkeypatch):
    _stem_switch(name, monkeypatch)
    model = port().eval()
    _perturb_bn(model)
    x = _inputs(shape)
    ours = model(torch.from_numpy(x)).detach().numpy()
    theirs = np.asarray(jax_model().apply(_jax_vars(model.state_dict()), jnp.asarray(x),
                                          train=False))
    _close(ours, theirs)


@pytest.mark.parametrize("name,port,jax_model,shape", MODELS, ids=[m[0] for m in MODELS])
def test_forward_train_and_running_averages_match_jax(name, port, jax_model, shape,
                                                      monkeypatch):
    """Train mode normalises with the batch statistics; the running averages
    then move by Flax's momentum with the biased batch variance (torch's
    ``BatchNorm`` would take the unbiased one: at CNN32's bn1d1 with 8
    samples that is 14% off)."""
    _stem_switch(name, monkeypatch)
    model = port().train()
    assert getattr(model, "uses_fused_stem", lambda: False)() == (name == "wrn")
    x = _inputs(shape, seed=2)
    variables = _jax_vars(model.state_dict())
    ours = model(torch.from_numpy(x)).detach().numpy()
    theirs, mut = jax_model().apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
    _close(ours, np.asarray(theirs), TRAIN_TOL.get(name, TOL))
    stats_tol = TRAIN_STATS_TOL.get(name, STATS_TOL)
    got = _leaves(to_flax_numpy(model.state_dict())["batch_stats"])
    want = _leaves(mut["batch_stats"])
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=stats_tol, rtol=stats_tol, err_msg=str(k))
        if k[-1] == "var":
            assert not np.allclose(v, 1.0)   # the batch moved them


def test_cbam_matches_jax():
    """CBAM alone, NCHW in the port and NHWC in JAX, both modes; the spatial
    gate's BN uses Flax momentum 0.99 and starts with a zero scale."""
    x = _inputs((2, 8, 8, 32), seed=3)
    port = CBAM(32, 16)
    assert torch.all(port.spatial_gate.spatial_bn.weight == 0)
    assert port.spatial_gate.spatial_bn.momentum == 0.99
    for train in (False, True):
        port.train(train)
        variables = _jax_vars(port.state_dict())
        ours = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if train:
            theirs, mut = JaxCBAM(32, 16).apply(variables, jnp.asarray(x), train=True,
                                                mutable=["batch_stats"])
            got = to_flax_numpy(port.state_dict())["batch_stats"]
            for k, v in _leaves(mut["batch_stats"]).items():
                np.testing.assert_allclose(_leaves(got)[k], v, atol=STATS_TOL)
        else:
            theirs = JaxCBAM(32, 16).apply(variables, jnp.asarray(x), train=False)
        _close(ours.detach().numpy(), np.asarray(theirs))


@pytest.mark.parametrize("name,port,jax_model,shape", MODELS, ids=[m[0] for m in MODELS])
def test_parameter_counts_and_names_equal_jax(name, port, jax_model, shape):
    """The same parameters and statistics as the Flax module's ``init``
    (tests/test_models.py:37 counts CNN32's against the reference), and the
    carrier is lossless both ways."""
    model = port()
    variables = jax.eval_shape(lambda: jax_model().init(
        jax.random.key(0), jnp.zeros((1, *shape[1:])), train=False))
    want = {c: {tuple(p.key for p in path): v.shape
                for path, v in jax.tree_util.tree_leaves_with_path(variables[c])}
            for c in variables}
    tree = to_flax_numpy(model.state_dict())
    got = {c: {k: v.shape for k, v in _leaves(tree[c]).items()} for c in tree}
    assert got == want
    n_jax = sum(int(np.prod(v)) for v in want["params"].values())
    assert sum(p.numel() for p in model.parameters()) == n_jax
    back = from_flax(jax.tree_util.tree_map(lambda v: np.zeros(v.shape, v.dtype), variables))
    assert back.keys() == model.state_dict().keys()
    model.load_state_dict(back)


def test_cnn32_fc1_carries_without_permutation():
    """The port flattens CNN32's last conv map in (h, w, c) order (it
    permutes the NCHW activation back before the flatten), so ``fc1``'s
    weight is the plain transpose of the Flax kernel, rows unpermuted."""
    model = CNN32()
    kernel = to_flax_numpy(model.state_dict())["params"]["fc1"]["kernel"]
    np.testing.assert_array_equal(kernel, model.fc1.weight.detach().numpy().T)
    x = _inputs((2, 32, 32, 3), seed=4)
    model.eval()
    feats = {}
    model.fc1.register_forward_hook(lambda m, i, o: feats.update(inp=i[0]))
    with torch.no_grad():
        model(torch.from_numpy(x))
        h = torch.from_numpy(x).permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            h = torch.nn.functional.max_pool2d(torch.nn.functional.leaky_relu(
                getattr(model, f"bn2d{i}")(getattr(model, f"conv{i}")(h))), 2)
    assert h.shape == (2, 128, 4, 4)
    np.testing.assert_array_equal(feats["inp"].numpy(),
                                  h.permute(0, 2, 3, 1).reshape(2, -1).numpy())


def test_ae32_deconv_is_an_unflipped_cross_correlation():
    """Flax's stride-1 ``ConvTranspose`` with padding 2 equals the port's
    5x5 ``Conv`` with padding 2 on the same HWIO kernel, not flipped."""
    import flax.linen as nn
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    kernel = rng.normal(size=(5, 5, 8, 16)).astype(np.float32)
    theirs = nn.ConvTranspose(16, (5, 5), padding=2, use_bias=False).apply(
        {"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))
    w = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    ours = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, padding=2)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(theirs),
                               atol=1e-5, rtol=1e-5)


def test_compute_dtype_reaches_every_layer_built_without_one():
    """``with_compute_dtype`` is the JAX trainer's ``model.clone(dtype=)``:
    every layer of a model built with ``dtype=None`` computes in it, but the
    CNN head (built without the dtype in Flax) stays fp32, and a model
    without a ``dtype`` (AE32) is left alone."""
    model = with_compute_dtype(CNN32(clf=True), torch.bfloat16)
    assert model.conv1.dtype == model.bn1d1.dtype == model.fc2.dtype == torch.bfloat16
    assert model.linear.dtype == torch.float32
    assert model(torch.zeros(2, 32, 32, 3)).dtype == torch.float32
    ae = with_compute_dtype(AE32(), torch.bfloat16)
    assert ae.encoder.conv1.dtype is None
    wrn = with_compute_dtype(WideResNet(layers=(1, 1, 1, 1)), torch.bfloat16)
    assert wrn.layer1_block0.cbam.spatial_gate.spatial_bn.dtype == torch.bfloat16
    assert wrn.eval()(torch.zeros(1, 32, 32, 3)).dtype == torch.bfloat16
