"""The slice as a whole: CLIP anomaly scoring through the JAX package's
``AnomalyScorer`` and through the port's, on the same weights and images.

A tiny random CLIP is written as a JAX snapshot with flax; the port reads
that snapshot's params through ``convert.from_flax``. 19 raw 24x24 uint8
images are scored with a batch size of 8, so the last chunk is padded, and
resized to the model's 32 px by ``clip_pil_preprocessing``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from eoe_tpu.inference import AnomalyScorer as JaxScorer
from eoe_tpu.models.clip import CLIP as JaxCLIP, ClipConfig as JaxConfig
from eoe_tpu.ops import metrics as jax_metrics
from eoe_tpu.training.clip import ClipTrainer
from eoe_tpu_torch.inference import AnomalyScorer
from eoe_tpu_torch.models.clip import CLIP, ClipConfig, from_flax, to_flax_numpy
from eoe_tpu_torch.ops import metrics
from eoe_tpu_torch.training.clip import CIFAR10_LABELS, prompt_center, prompt_texts

TINY = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
            vision_patch_size=8, context_length=77, vocab_size=49408,
            transformer_width=128, transformer_heads=2, transformer_layers=2,
            vision_heads_override=2)
SPECS = [{"op": "clip_pil_preprocessing", "resolution": 32}, {"op": "clip_tensor_preprocessing"}]


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    params = to_flax_numpy(CLIP(ClipConfig(**TINY)).state_dict())
    path = tmp_path_factory.mktemp("snap") / "snapshot_cls0_it0.msgpack"
    path.write_bytes(serialization.msgpack_serialize(
        {"params": params, "ds_statistics": None, "setup": {"dataset": "cifar10"}}))
    restored = serialization.msgpack_restore(path.read_bytes())
    return str(path), restored


def _port_model(restored):
    model = CLIP(ClipConfig(**TINY))
    model.load_state_dict(from_flax(restored["params"]))
    return model


def _jax_center(params, clsstr, ad_mode):
    """ClipTrainer.prepare_metric itself, on a stand-in trainer."""
    trainer = types.SimpleNamespace(ad_mode=ad_mode, anom_tkn_ptn="a photo of something",
                                    dsstr="cifar10", model=JaxCLIP(JaxConfig(**TINY)))
    state = types.SimpleNamespace(params=params, batch_stats={})
    center = ClipTrainer.prepare_metric(trainer, clsstr, None, state, 0)
    return np.asarray(center), trainer.raw_texts


@pytest.mark.parametrize("ad_mode", ["one_vs_rest", "leave_one_out"])
def test_prompt_center_matches_jax(snapshot, ad_mode):
    _, restored = snapshot
    ref, texts = _jax_center(restored["params"], "cat", ad_mode)
    assert prompt_texts("cat", CIFAR10_LABELS, ad_mode) == texts
    ours = prompt_center(_port_model(restored), "cat", CIFAR10_LABELS, ad_mode,
                         device="cpu").numpy()
    assert ours.shape == ref.shape == (2 if ad_mode == "one_vs_rest" else 10, 64)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("objective", ["clip", "hsc"])
def test_scores_and_auroc_match_jax(snapshot, objective):
    path, restored = snapshot
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (19, 24, 24, 3), dtype=np.uint8)
    labels = np.arange(19) % 2
    model = _port_model(restored)
    center = jcenter = None
    if objective == "clip":
        center = prompt_center(model, "airplane", CIFAR10_LABELS, device="cpu")
        jcenter = jnp.asarray(_jax_center(restored["params"], "airplane", "one_vs_rest")[0])
    ref = JaxScorer(path, JaxCLIP(JaxConfig(**TINY)), objective=objective, test_specs=SPECS,
                    batch_size=8, center=jcenter).score(images)
    ours = AnomalyScorer({"params": from_flax(restored["params"]), "setup": restored["setup"]},
                         model, objective=objective, test_specs=SPECS, batch_size=8,
                         center=center, device="cpu").score(images)
    assert ours.shape == (19,) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    assert abs(metrics.auroc(labels, ours) - jax_metrics.auroc(labels, ref)) <= 1e-6
    assert abs(metrics.average_precision(labels, ours)
               - jax_metrics.average_precision(labels, ref)) <= 1e-6


def test_port_snapshot_file_round_trip(snapshot, tmp_path):
    """A port snapshot on disk scores as the in-memory state_dict does."""
    _, restored = snapshot
    sd = from_flax(restored["params"])
    torch.save({"params": sd, "ds_statistics": None, "setup": {"test_specs": SPECS}},
               tmp_path / "snap.pt")
    images = np.random.default_rng(1).integers(0, 256, (5, 24, 24, 3), dtype=np.uint8)
    a = AnomalyScorer(str(tmp_path / "snap.pt"), CLIP(ClipConfig(**TINY)), device="cpu",
                      batch_size=4).score(images)
    b = AnomalyScorer(sd, CLIP(ClipConfig(**TINY)), test_specs=SPECS, device="cpu",
                      batch_size=4).score(images)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="center"):
        AnomalyScorer(sd, CLIP(ClipConfig(**TINY)), objective="clip", device="cpu")


def test_metrics_match_jax_with_ties():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 2, 200)
    scores = np.round(rng.uniform(0, 1, 200), 1)  # many ties
    a, b = metrics.roc_curve(labels, scores), jax_metrics.roc_curve(labels, scores)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    a, b = metrics.precision_recall_curve(labels, scores), \
        jax_metrics.precision_recall_curve(labels, scores)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
