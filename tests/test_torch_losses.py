"""The port's objectives against the JAX package's: values and gradients
(``jax.grad`` against autograd) on the same numpy inputs, with 0/1 weight
masks and unlabeled (-1) rows; HSC and CLIP to 1e-6, the conv models'
objectives (bce, focal, dsvdd, dsad, ae) and the DSVDD centre to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.ops import losses as jax_losses
from eoe_tpu_torch.ops import losses as L


def _inputs(seed, n=12, dim=16, prompts=4):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (n, dim)).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.int64)
    labels[:2] = -1                      # unlabeled rows
    weights = (rng.random(n) > 0.25).astype(np.float32) * (labels >= 0)
    text = rng.normal(0, 1, (prompts, dim)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return feats, labels, weights, text


def _both(port_fn, jax_fn, feats, *args, **kw):
    """(port value, port gradient), (JAX value, JAX gradient) w.r.t. feats."""
    f = torch.from_numpy(feats).requires_grad_()
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    value = port_fn(f, *targs, **tkw)
    value.backward()
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jv, jg = jax.value_and_grad(lambda x: jax_fn(x, *jargs, **jkw))(jnp.asarray(feats))
    return (value.item(), f.grad.numpy()), (float(jv), np.asarray(jg))


@pytest.mark.parametrize("nominal_label", [0, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_hsc_loss_matches_jax(nominal_label, masked):
    feats, labels, weights, _ = _inputs(0)
    kw = {"weights": weights} if masked else {}
    (v, g), (jv, jg) = _both(L.hsc_loss, jax_losses.hsc_loss, feats, labels, None,
                             nominal_label=nominal_label, **kw)
    assert abs(v - jv) <= 1e-6 * max(1.0, abs(jv))
    np.testing.assert_allclose(g, jg, atol=1e-6)
    np.testing.assert_allclose(L.hsc_score(torch.from_numpy(feats)).numpy(),
                               np.asarray(jax_losses.hsc_score(jnp.asarray(feats))), atol=1e-6)


@pytest.mark.parametrize("ad_mode", ["one_vs_rest", "leave_one_out"])
@pytest.mark.parametrize("masked", [False, True])
def test_clip_loss_matches_jax(ad_mode, masked):
    feats, labels, weights, text = _inputs(1, prompts=2 if ad_mode == "one_vs_rest" else 5)
    kw = {"weights": weights} if masked else {}
    (v, g), (jv, jg) = _both(L.clip_loss, jax_losses.clip_loss, feats, labels, text,
                             ad_mode=ad_mode, **kw)
    assert abs(v - jv) <= 1e-6 * max(1.0, abs(jv))
    np.testing.assert_allclose(g, jg, atol=1e-6)


def test_all_masked_batch_is_zero_not_nan():
    feats, labels, _, _ = _inputs(2)
    loss = L.hsc_loss(torch.from_numpy(feats), torch.from_numpy(labels),
                      weights=torch.zeros(len(labels)))
    assert loss.item() == 0.0


def test_objectives_registry():
    """All seven objectives, with the JAX registry's flags, each pairing the
    port's own loss and score of that name."""
    assert set(L.OBJECTIVES) == set(jax_losses.OBJECTIVES)
    for name, theirs in jax_losses.OBJECTIVES.items():
        ours = L.OBJECTIVES[name]
        flags = ("needs_center", "clf_head", "uses_inputs", "is_clip")
        assert ours.name == name
        assert [getattr(ours, f) for f in flags] == [getattr(theirs, f) for f in flags]
        assert ours.loss is getattr(L, f"{name}_loss") and ours.score is getattr(L, f"{name}_score")
    with pytest.raises(NotImplementedError):
        L.clip_loss(torch.ones(2, 3), torch.zeros(2), torch.ones(2, 3), ad_mode="fifty_fifty")


# ---------------------------------------------------------------- conv objectives

CONV_TOL = 1e-5


def _conv_case(name, seed):
    """(loss args after feats, score args after feats, extra kwargs) of one
    objective: a one-neuron head for bce and focal, a centre for dsvdd, the
    reconstructed inputs for ae."""
    feats, labels, weights, _ = _inputs(seed)
    rng = np.random.default_rng(seed + 100)
    if name in ("bce", "focal"):
        feats = feats[:, :1] * 3.0
        return feats, (labels.clip(0), None), (None,), {}, weights
    if name == "dsvdd":
        center = rng.normal(0, 1, feats.shape[1]).astype(np.float32)
        return feats, (labels, center), (center,), {}, weights
    if name == "ae":
        inputs = rng.random(feats.shape).astype(np.float32)
        return feats, (labels, None), (None,), {"inputs": inputs}, weights
    return feats, (labels, None), (None,), {}, weights


@pytest.mark.parametrize("name", ["bce", "focal", "dsvdd", "dsad", "ae"])
@pytest.mark.parametrize("nominal_label", [0, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_conv_objectives_match_jax(name, nominal_label, masked):
    feats, loss_args, score_args, extra, weights = _conv_case(name, 3)
    kw = dict(extra, nominal_label=nominal_label, **({"weights": weights} if masked else {}))
    (v, g), (jv, jg) = _both(getattr(L, f"{name}_loss"), getattr(jax_losses, f"{name}_loss"),
                             feats, *loss_args, **kw)
    assert abs(v - jv) <= CONV_TOL * max(1.0, abs(jv)), (v, jv)
    np.testing.assert_allclose(g, jg, atol=CONV_TOL, rtol=CONV_TOL)
    tkw = {k: torch.from_numpy(a) for k, a in extra.items()}
    targs = [None if a is None else torch.from_numpy(a) for a in score_args]
    ours = getattr(L, f"{name}_score")(torch.from_numpy(feats), *targs,
                                       nominal_label=nominal_label, **tkw)
    theirs = getattr(jax_losses, f"{name}_score")(
        jnp.asarray(feats), *[None if a is None else jnp.asarray(a) for a in score_args],
        nominal_label=nominal_label, **{k: jnp.asarray(a) for k, a in extra.items()})
    assert ours.shape == (len(feats),)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=CONV_TOL, rtol=CONV_TOL)


@pytest.mark.parametrize("count", [0, 1, 7])
def test_dsvdd_center_matches_jax(count):
    """Small entries pushed to +-eps by sign, exact zeros kept, the count
    clamped at 1."""
    sums = np.array([0.0, 0.05, -0.05, 0.3, -2.0, 1e-9, -0.7, 0.69], np.float32) * max(count, 1)
    ours = L.dsvdd_center(torch.from_numpy(sums), count)
    theirs = jax_losses.dsvdd_center(jnp.asarray(sums), jnp.asarray(float(count)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=CONV_TOL)
    assert ours[0] == 0.0
