"""The port's HSC and CLIP losses against the JAX package's: values and
gradients (``jax.grad`` against autograd) on the same numpy inputs, with
0/1 weight masks and unlabeled (-1) rows, to 1e-6."""

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
    assert set(L.OBJECTIVES) == {"hsc", "clip"}
    clip = L.OBJECTIVES["clip"]
    assert clip.is_clip and clip.needs_center and not clip.clf_head and not clip.uses_inputs
    hsc = L.OBJECTIVES["hsc"]
    assert (hsc.is_clip, hsc.needs_center, hsc.clf_head, hsc.uses_inputs) == (False,) * 4
    assert hsc.loss is L.hsc_loss and hsc.score is L.hsc_score
    with pytest.raises(NotImplementedError):
        L.clip_loss(torch.ones(2, 3), torch.zeros(2), torch.ones(2, 3), ad_mode="fifty_fifty")
