"""The training slice as a whole: the port's ``Trainer`` and ``ClipTrainer``
against the JAX package's, at a tiny size on the CPU.

One tiny random CLIP (tests/test_torch_clip.py's TINY: 2 layers, width 128,
heads of 64, 32 px images) is initialised by the port and carried to the
JAX package with ``convert.to_flax_numpy``. Both sides take the same raw
uint8 batches (numpy, seeded) and the same sampler plans, and a
deterministic pipeline (CLIP's test preprocessing), so that the steps see
the same inputs.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from eoe_tpu.datasets import bases as JB
from eoe_tpu.models.clip import CLIP as JaxCLIP, ClipConfig as JaxConfig
from eoe_tpu.ops.attention import flash_attention as jax_flash_attention
from eoe_tpu.training.clip import ClipTrainer as JaxClipTrainer
from eoe_tpu.training.trainer import Trainer as JaxTrainer, TrainState as JaxState
from eoe_tpu.utils.logger import Logger as JaxLogger
from eoe_tpu_torch.datasets import bases as B
from eoe_tpu_torch.inference import AnomalyScorer
from eoe_tpu_torch.models.clip import CLIP, ClipConfig, to_flax_numpy
from eoe_tpu_torch.ops import attention as A
from eoe_tpu_torch.ops.losses import OBJECTIVES, Objective, clip_loss, hsc_loss
from eoe_tpu_torch.training import TRAINER, NanGradientsError, TrainState
from eoe_tpu_torch.training.clip import CIFAR10_LABELS, ClipTrainer, prompt_center
from eoe_tpu_torch.utils.logger import Logger

TINY = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
            vision_patch_size=8, context_length=77, vocab_size=49408,
            transformer_width=128, transformer_heads=2, transformer_layers=2,
            vision_heads_override=2)
SPECS = [{"op": "clip_pil_preprocessing", "resolution": 32}, {"op": "clip_tensor_preprocessing"}]
BATCH, N_NORMAL, N_OE, N_TEST = 8, 24, 20, 12
COMMON = dict(dataset="cifar10", oe_dataset="cifar100", datapath="", lr=1e-2, wdk=1e-3,
              milestones=[], batch_size=BATCH)


@pytest.fixture(scope="module")
def weights():
    return CLIP(ClipConfig(**TINY), generator=torch.Generator().manual_seed(0)).state_dict()


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (N_NORMAL, 32, 32, 3), dtype=np.uint8)
    xo = rng.integers(0, 256, (N_OE, 32, 32, 3), dtype=np.uint8)
    xt = rng.integers(0, 256, (N_TEST, 32, 32, 3), dtype=np.uint8)
    return x, xo, xt


def _combined(mod, specs=SPECS, seed=0):
    x, xo, xt = _data(seed)
    kw = dict(root="", train_specs=specs, test_specs=SPECS, n_classes=2, raw_shape=(32, 32, 3))
    normal = mod.GenericADDataset(mod.ArraySource(x, np.zeros(N_NORMAL)),
                                  mod.ArraySource(xt, np.arange(N_TEST) % 2),
                                  normal_classes=(0,), nominal_label=0, **kw)
    oe = mod.GenericADDataset(mod.ArraySource(xo, np.ones(N_OE)), None,
                              normal_classes=(1,), nominal_label=1, **kw)
    return mod.CombinedDataset(normal, oe)


def _plans(steps, seed=7):
    """(normal positions, OE positions, weights) of ``steps`` steps, from the
    sampler both packages share."""
    sampler = B.BalancedEpochSampler(N_NORMAL, N_OE, BATCH, seed)
    idx_n, idx_o, w = sampler.epoch()
    return [(idx_n[s], idx_o[s], w[s]) for s in range(steps)]


def _port_state(trainer, sd):
    trainer.model.load_state_dict(sd)
    params = trainer._mark_trainable(trainer.model)
    return TrainState(trainer.model, trainer.make_optimizer(params, N_NORMAL // BATCH))


def _port_steps(trainer, state, ds, plans, center=None):
    x, xo, _ = (torch.from_numpy(a) for a in _data())
    out = []
    for i_n, i_o, w in plans:
        loss, scores, *_ = trainer.train_step(
            state, ds, x[i_n], torch.zeros(BATCH, dtype=torch.int64), xo[i_o],
            torch.ones(BATCH, dtype=torch.int64), torch.from_numpy(w), None, center)
        out.append((loss.item(), scores.numpy()))
    return out


def _jax_steps(trainer, state, ds, plans, center=None):
    tx = trainer.make_optimizer(N_NORMAL // BATCH)
    step = jax.jit(trainer._train_step_core(ds, tx, True))
    x, xo, _ = _data()
    out = []
    for i_n, i_o, w in plans:
        state, (loss, scores, _, _) = step(
            state, jnp.asarray(x[i_n]), jnp.zeros(BATCH, jnp.int32), jnp.asarray(xo[i_o]),
            jnp.ones(BATCH, jnp.int32), jnp.asarray(w), jax.random.key(0), center, None)
        out.append((float(loss), np.asarray(scores)))
    return out, state


def _compare(port_out, jax_out, port_model, jax_params, init):
    for (l, s), (jl, js) in zip(port_out, jax_out):
        assert abs(l - jl) <= 1e-5 * abs(jl)
        np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-7)
    trained = to_flax_numpy(port_model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_params):
        keys = [p.key for p in path]
        ours = trained
        for k in keys:
            ours = ours[k]
        if keys[0] == "visual":
            np.testing.assert_allclose(ours, np.asarray(leaf), atol=1e-5, err_msg=str(keys))
        else:  # the text tower and logit_scale are not trained on either side
            start = init
            for k in keys:
                start = start[k]
            np.testing.assert_array_equal(ours, start, err_msg=str(keys))
            np.testing.assert_array_equal(np.asarray(leaf), start, err_msg=str(keys))
    assert not np.array_equal(trained["visual"]["proj"], init["visual"]["proj"])


def _hsc_steps_match_jax(weights, steps, port_kw=None, jax_kw=None):
    init = to_flax_numpy(weights)
    plans = _plans(steps)
    port = TRAINER["hsc"](model=CLIP(ClipConfig(**TINY), **(port_kw or {})), train_specs=SPECS,
                          test_specs=SPECS, logger=None, epochs=1, device="cpu", **COMMON)
    state = _port_state(port, weights)
    port_out = _port_steps(port, state, _combined(B), plans)
    assert state.optimizer.count == steps

    jt = JaxTrainer(model=JaxCLIP(JaxConfig(**TINY), **(jax_kw or {})), train_specs=SPECS,
                    test_specs=SPECS, logger=JaxLogger("", active=False), epochs=1,
                    objective="hsc", **COMMON)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    trainable, _ = jt._split_trainable(params)
    tx = jt.make_optimizer(N_NORMAL // BATCH)
    jstate = JaxState(params=params, batch_stats={}, opt_state=tx.init(trainable),
                      step=jnp.zeros((), jnp.int32))
    jax_out, jstate = _jax_steps(jt, jstate, _combined(JB), plans)
    _compare(port_out, jax_out, state.model, jstate.params, init)


def test_hsc_train_step_matches_jax(weights):
    _hsc_steps_match_jax(weights, 3)


def test_hsc_train_step_with_flash_attention_matches_jax(weights):
    """``attention_fn=flash_attention`` on both sides: the JAX Pallas kernel
    in interpret mode and the port's plain version forward, the backward
    through ``default_attention`` on both; the same limits as above."""
    before = A.flash_attention.launches
    _hsc_steps_match_jax(weights, 1, {"attention_fn": A.flash_attention},
                         {"attention_fn": jax_flash_attention})
    assert A.flash_attention.launches == before


@pytest.mark.parametrize("ad_mode", ["one_vs_rest", "leave_one_out"])
def test_clip_train_step_matches_jax(weights, ad_mode):
    """ClipTrainer: the prompt centre, then one step of the CLIP objective."""
    init = to_flax_numpy(weights)
    plans = _plans(1)
    kw = dict(COMMON, ad_mode=ad_mode, epochs=1)
    port = ClipTrainer(None, None, None, logger=None, clip_config=ClipConfig(**TINY),
                       clip_state_dict=weights, device="cpu", **kw)
    state = port.init_state(0, None, N_NORMAL // BATCH)
    center = port.prepare_metric("airplane", None, state, 0)

    jt = JaxClipTrainer(None, None, None, logger=JaxLogger("", active=False),
                        clip_config=JaxConfig(**TINY),
                        clip_variables={"params": jax.tree_util.tree_map(jnp.asarray, init)},
                        **kw)
    jstate = jt.init_state(jax.random.key(0), None, N_NORMAL // BATCH)
    jcenter = jt.prepare_metric("airplane", None, jstate, 0)
    assert port.raw_texts == jt.raw_texts
    np.testing.assert_allclose(center.numpy(), np.asarray(jcenter), atol=1e-5)

    port_out = _port_steps(port, state, _combined(B, port.train_specs), plans, center)
    jax_out, jstate = _jax_steps(jt, jstate, _combined(JB, jt.train_specs), plans, jcenter)
    _compare(port_out, jax_out, state.model, jstate.params, init)


def test_qkv_function_gradients_equal_default_path(weights):
    """On the CPU the autograd Function (plain forward and backward) gives
    the default attention path's gradients."""
    images = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (4, 32, 32, 3))
                              .astype(np.float32))
    labels = torch.tensor([0, 1, 0, 1])
    grads = []
    for kw in ({}, {"qkv_attention": A.fused_qkv_attention}):
        model = CLIP(ClipConfig(**TINY), **kw)
        model.load_state_dict(weights)
        hsc_loss(model(images), labels).backward()
        grads.append({k: p.grad for k, p in model.visual.named_parameters()})
    for k, g in grads[0].items():
        np.testing.assert_allclose(grads[1][k].numpy(), g.numpy(), atol=1e-5, err_msg=k)


def test_prompt_center_enters_clip_loss_with_autograd(weights):
    """The port's prompt centre is an ordinary tensor: ``clip_loss`` saves it
    for backward. (Computed under ``torch.inference_mode`` it raised
    "Inference tensors cannot be saved for backward".)"""
    model = CLIP(ClipConfig(**TINY))
    model.load_state_dict(weights)
    center = prompt_center(model, "cat", CIFAR10_LABELS, device="cpu")
    assert not center.is_inference() and not center.requires_grad
    images = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (4, 32, 32, 3))
                              .astype(np.float32))
    loss = clip_loss(model(images), torch.tensor([0, 1, 0, 1]), center)
    loss.backward()
    assert torch.isfinite(model.visual.proj.grad).all()


# ---------------------------------------------------------------- contract


def _files(root):
    """The run directory's files; a tensorboard event file by its prefix
    (its name carries the time, host and process)."""
    out = set()
    for d, _, names in os.walk(root):
        out |= {re.sub(r"tfevents\..*", "tfevents", os.path.relpath(os.path.join(d, n), root))
                for n in names}
    return out


def _port_trainer(logdir, epochs, objective="hsc"):
    tr = TRAINER["hsc"](model=CLIP(ClipConfig(**TINY)), train_specs=SPECS, test_specs=SPECS,
                        logger=Logger(str(logdir), noname=True, archive_source=False),
                        epochs=epochs, device="cpu", objective=objective,
                        **{**COMMON, "lr": 1e-4})
    tr.ds = _combined(B)
    return tr


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_run_writes_the_jax_run_directory(tmp_path):
    """One class, one seed, two epochs: the port writes the files the JAX
    package writes (tensorboard events are not ported; the previews' grids have
    the JAX package's sizes), and
    its snapshot serves through ``AnomalyScorer`` with ``eval_cls``'s
    scores."""
    jt = JaxTrainer(model=JaxCLIP(JaxConfig(**TINY)), train_specs=SPECS, test_specs=SPECS,
                    logger=JaxLogger(str(tmp_path / "jax"), noname=True, archive_source=False),
                    epochs=2, objective="hsc", **{**COMMON, "lr": 1e-4})
    jt.ds = _combined(JB)
    jt.run(run_classes=[0], run_seeds=1)
    port = _port_trainer(tmp_path / "port", 2)
    _, res = port.run(run_classes=[0], run_seeds=1)
    assert np.isfinite(res["mean_auc"]) and len(port.step_losses) == 2 * N_NORMAL // BATCH

    jax_files = {f.replace(".msgpack", ".pt") for f in _files(tmp_path / "jax")}
    assert "tb/events.out.tfevents" in jax_files
    assert _files(tmp_path / "port") == jax_files
    for name in (f for f in jax_files if f.endswith(".png")):   # previews: other draws
        with Image.open(tmp_path / "port" / name) as got, \
                Image.open(tmp_path / "jax" / name) as want:
            assert got.size == want.size and got.mode == want.mode
    for name in ("results.json", "setup.json", "setup_v1.json",
                 "eval_cls0_it0_anomaly_scores.json"):
        assert _read(tmp_path / "port" / name).keys() == _read(tmp_path / "jax" / name).keys()

    scores = _read(tmp_path / "port" / "eval_cls0_it0_anomaly_scores.json")
    snapshot = str(tmp_path / "port" / "snapshots" / "snapshot_cls0_it0.pt")
    scorer = AnomalyScorer(snapshot, CLIP(ClipConfig(**TINY)), objective="hsc",
                           batch_size=BATCH, device="cpu")
    served = scorer.score(_data()[2])
    np.testing.assert_allclose(served, [scores[str(i)] for i in range(N_TEST)], atol=1e-6)


def test_load_resumes_at_the_saved_epoch(tmp_path):
    first = _port_trainer(tmp_path / "a", 2)
    first.run(run_classes=[0])
    snapshot = str(tmp_path / "a" / "snapshots" / "snapshot_cls0_it0.pt")
    resumed = _port_trainer(tmp_path / "b", 3)
    resumed.run(run_classes=[0], load=[[snapshot]])
    assert len(resumed.epoch_rates) == 1           # only epoch 3 trained
    assert "Loaded snapshot at epoch 2" in (tmp_path / "b" / "print.txt").read_text()
    payload = torch.load(snapshot, map_location="cpu", weights_only=True)
    assert payload["opt_state"]["count"] == 2 * N_NORMAL // BATCH


def test_nan_loss_is_retried(tmp_path):
    """A NaN loss makes NaN parameters, the next step's scores are NaN, the
    epoch raises NanGradientsError and the class-seed starts again."""
    calls = []

    def nan_once(*args, **kw):
        calls.append(1)
        loss = hsc_loss(*args, **kw)
        return loss * float("nan") if len(calls) == 1 else loss

    objective = Objective("hsc", nan_once, OBJECTIVES["hsc"].score)
    tr = _port_trainer(tmp_path, 1, objective)
    with pytest.raises(NanGradientsError):
        tr.train_cls(tr.ds, 0, "airplane", 0, seed=0)
    calls.clear()
    _, res = tr.run(run_classes=[0])
    assert np.isfinite(res["mean_auc"])
    assert "Gradients got NaN" in (tmp_path / "warnings.txt").read_text()
