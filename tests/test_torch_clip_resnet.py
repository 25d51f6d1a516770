"""CLIP's ModifiedResNet tower in the port against the JAX package's.

A small RN-shaped OpenAI state dict is built here: stages of (1, 2, 1, 1)
blocks, so that stride, blur-pool and downsample all run, width 8 (an
attention pool of 256 channels in 4 heads of 64), 64 px images (a 2x2 final
grid), a text tower of width 64 with 2 layers. Its batch norms carry
running averages and affine parameters drawn from a numpy seed. The JAX
side reads it through its own ``config_from_state_dict`` and ``to_flax``,
the port through ``from_openai``.

The training-mode holds take the JAX function in float64
(``jax.enable_x64``; the model, its variables and the trainer's compute
dtype in float64) as the reference: in float32 on the CPU the JAX tower's
batch-norm gradients are up to 11% of a leaf's largest entry off its own
float64 values (its one-pass sums over 16K values a channel and Flax's
E[x^2] - E[x]^2 variance), the port's 8e-6.
"""

import dataclasses
import json
import os
import os.path as pt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.datasets import bases as JB
from eoe_tpu.models.clip import CLIP as JaxCLIP
from eoe_tpu.models.clip.convert import config_from_state_dict as jax_config, to_flax
from eoe_tpu.training.clip import ClipTrainer as JaxClipTrainer
from eoe_tpu.utils.logger import Logger as JaxLogger
from eoe_tpu_torch.datasets import bases as B
from eoe_tpu_torch.inference import AnomalyScorer
from eoe_tpu_torch.models.clip import (CLIP, ClipConfig, config_from_state_dict, from_flax,
                                       from_openai, to_flax_variables, to_openai, tokenize)
from eoe_tpu_torch.models.layers import BatchNorm
from eoe_tpu_torch.training.clip import CIFAR10_LABELS, ClipTrainer

RN_TINY = dict(embed_dim=32, image_resolution=64, vision_layers=(1, 2, 1, 1), vision_width=8,
               vision_patch_size=None, context_length=77, vocab_size=49408,
               transformer_width=64, transformer_heads=1, transformer_layers=2)
HW = RN_TINY["image_resolution"]
SPECS = [{"op": "clip_pil_preprocessing", "resolution": HW}, {"op": "clip_tensor_preprocessing"}]
BATCH, N_NORMAL, N_OE, N_TEST = 8, 16, 16, 12
COMMON = dict(dataset="cifar10", oe_dataset="cifar100", datapath="", lr=1e-2, wdk=1e-3,
              milestones=[], batch_size=BATCH)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small CPU kernels: one thread keeps them fast under the test
    workers and their sums in one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_weights(seed: int = 0) -> dict:
    """A port RN CLIP from ``seed`` whose batch norms carry non-trivial
    scales, shifts and running averages, drawn with numpy."""
    model = CLIP(ClipConfig(**RN_TINY), generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.2, 0.2),
                                  (m.running_mean, -0.1, 0.1), (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32)))
    return model.state_dict()


@pytest.fixture(scope="module")
def openai_sd():
    """The OpenAI-format fp16 state dict, as the published RN checkpoints
    store it (with torch's ``num_batches_tracked`` counters)."""
    sd = to_openai(_port_weights(), ClipConfig(**RN_TINY))
    assert sd["visual.layer2.0.downsample.0.weight"].shape == (64, 32, 1, 1)
    assert sd["visual.attnpool.positional_embedding"].shape == (5, 256)
    assert "visual.layer1.0.bn1.num_batches_tracked" in sd
    return {**sd, "input_resolution": torch.tensor(HW), "context_length": torch.tensor(77),
            "vocab_size": torch.tensor(49408)}


@pytest.fixture(scope="module")
def converted(openai_sd):
    """(port config, port state dict, JAX config, JAX variables)."""
    meta = ("input_resolution", "context_length", "vocab_size")
    cfg = config_from_state_dict({k: v for k, v in openai_sd.items() if k not in meta})
    return cfg, from_openai(openai_sd), jax_config(openai_sd), to_flax(openai_sd)


def _f64(variables):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)


def _port(cfg, sd, dtype=torch.float32):
    model = CLIP(cfg, dtype=dtype)
    model.load_state_dict(sd)
    return model


def _images(seed=0, n=6):
    return np.random.default_rng(seed).normal(0, 1, (n, HW, HW, 3)).astype(np.float32)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_config_and_conversion_equal_jax(converted):
    """``config_from_state_dict`` equals the JAX package's; ``from_openai``
    gives exactly the JAX converter's variables carried over with
    ``from_flax`` (batch statistics included); the carried tree has the JAX
    model's paths and shapes; ``from_flax`` and ``to_flax_variables``
    round-trip exactly."""
    cfg, sd, jcfg, variables = converted
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.vision_layers == (1, 2, 1, 1) and cfg.vision_heads == 4
    theirs = from_flax(variables["params"], variables["batch_stats"])
    assert sd.keys() == theirs.keys() == _port(cfg, sd).state_dict().keys()
    for k in sd:
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], theirs[k]), k

    jm = JaxCLIP(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, HW, HW, 3)),
                                            jnp.zeros((1, 77), jnp.int32),
                                            method=jm.contrastive))
    back = to_flax_variables(sd)
    assert back.keys() == {"params", "batch_stats"}
    for col in ("params", "batch_stats"):
        want = {p: tuple(a.shape) for p, a in _flat(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32), shapes[col]))}
        assert {p: a.shape for p, a in _flat(back[col])} == want
        for path, leaf in _flat(variables[col]):
            node = back[col]
            for k in path:
                node = node[k]
            np.testing.assert_array_equal(node, leaf, err_msg=str(path))
    again = from_flax(back["params"], back["batch_stats"])
    assert all(torch.equal(again[k], sd[k]) for k in sd)


def test_encode_image_eval_matches_jax(converted):
    cfg, sd, jcfg, variables = converted
    images = _images(1)
    with torch.no_grad():
        ours = _port(cfg, sd).eval().encode_image(torch.from_numpy(images)).numpy()
    jm = JaxCLIP(jcfg)
    theirs = jax.jit(lambda v, x: jm.apply(v, x, method=jm.encode_image))(
        variables, jnp.asarray(images))
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-5)


def test_train_forward_updates_averages_as_jax(converted):
    """One training-mode forward at the trainer's batch of 16: the features,
    and every batch norm's new running mean and variance (Flax's momentum
    0.9, biased variance), against the JAX tower in float64."""
    cfg, sd, jcfg, variables = converted
    images = _images(2, n=2 * BATCH)
    model = _port(cfg, sd).train()
    with torch.no_grad():
        ours = model.encode_image(torch.from_numpy(images)).numpy()
    with jax.enable_x64(True):
        jm = JaxCLIP(jcfg, dtype=jnp.float64)
        theirs, mutated = jax.jit(lambda v, x: jm.apply(v, x, True, method=jm.encode_image,
                                                        mutable=["batch_stats"]))(
            _f64(variables), jnp.asarray(images, jnp.float64))
        theirs, mutated = np.asarray(theirs), jax.device_get(mutated["batch_stats"])
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
    stats = to_flax_variables(model.state_dict())["batch_stats"]
    moved = 0
    for path, leaf in _flat(mutated):
        node, start = stats, variables["batch_stats"]
        for k in path:
            node, start = node[k], start[k]
        np.testing.assert_allclose(node, leaf, atol=1e-5, err_msg=str(path))
        moved += not np.array_equal(leaf, start)
    assert moved == len(list(_flat(variables["batch_stats"])))


def test_encode_text_matches_jax(converted):
    cfg, sd, jcfg, variables = converted
    tokens = tokenize(["a photo of a cat", "a photo of something", "hello world"])
    with torch.no_grad():
        ours = _port(cfg, sd).encode_text(torch.from_numpy(tokens).long()).numpy()
    jm = JaxCLIP(jcfg)
    theirs = jax.jit(lambda v, t: jm.apply(v, t, method=jm.encode_text))(
        variables, jnp.asarray(tokens))
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-5)


# ---------------------------------------------------------------- ClipTrainer

def _data(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)
                 for n in (N_NORMAL, N_OE, N_TEST))


def _combined(mod, specs):
    x, xo, xt = _data()
    kw = dict(root="", train_specs=specs, test_specs=SPECS, n_classes=2, raw_shape=(HW, HW, 3))
    normal = mod.GenericADDataset(mod.ArraySource(x, np.zeros(N_NORMAL)),
                                  mod.ArraySource(xt, np.arange(N_TEST) % 2),
                                  normal_classes=(0,), nominal_label=0, **kw)
    oe = mod.GenericADDataset(mod.ArraySource(xo, np.ones(N_OE)), None,
                              normal_classes=(1,), nominal_label=1, **kw)
    return mod.CombinedDataset(normal, oe)


def test_clip_trainer_epoch_matches_jax(converted):
    """One ``ClipTrainer`` epoch (2 steps of 8 + 8) from the RN weights on
    both sides, the sampler's plans shared, CLIP's deterministic test
    preprocessing, the JAX trainer in float64: losses, parameters and batch
    statistics within 1e-5, the eval scores (running averages) within 1e-4;
    the text tower and ``logit_scale`` untouched on both sides."""
    cfg, sd, jcfg, variables = converted
    steps = N_NORMAL // BATCH
    sampler = B.BalancedEpochSampler(N_NORMAL, N_OE, BATCH, 7)
    plans = list(zip(*sampler.epoch()))
    kw = dict(COMMON, epochs=1)
    port = ClipTrainer(None, None, None, logger=None, clip_config=cfg, clip_state_dict=sd,
                       device="cpu", **kw)
    state = port.init_state(0, None, steps)
    center = port.prepare_metric("airplane", None, state, 0)
    ds = _combined(B, port.train_specs)
    x, xo, xt = _data()
    labels = np.arange(N_TEST) % 2
    losses = []
    for i_n, i_o, w in plans:
        loss, *_ = port.train_step(
            state, ds, torch.from_numpy(x[i_n]), torch.zeros(BATCH, dtype=torch.int64),
            torch.from_numpy(xo[i_o]), torch.ones(BATCH, dtype=torch.int64),
            torch.from_numpy(w), None, center)
        losses.append(loss.item())
    assert state.optimizer.count == steps
    scores = port.eval_step(state, ds, torch.from_numpy(xt), torch.from_numpy(labels), center)

    with jax.enable_x64(True):
        jt = JaxClipTrainer(None, None, None, logger=JaxLogger("", active=False),
                            clip_config=jcfg, clip_variables=_f64(variables),
                            compute_dtype=jnp.float64, **kw)
        jstate = jt.init_state(jax.random.key(0), None, steps)
        jcenter = jt.prepare_metric("airplane", None, jstate, 0)
        jds = _combined(JB, jt.train_specs)
        step = jax.jit(jt._train_step_core(jds, jt.make_optimizer(steps), True))
        jlosses = []
        for i_n, i_o, w in plans:
            jstate, (jloss, *_) = step(
                jstate, jnp.asarray(x[i_n]), jnp.zeros(BATCH, jnp.int32), jnp.asarray(xo[i_o]),
                jnp.ones(BATCH, jnp.int32), jnp.asarray(w), jax.random.key(0), jcenter, None)
            jlosses.append(float(jloss))
        jscores = np.asarray(jax.jit(jt._eval_step_core(jds))(
            jstate, jnp.asarray(xt), jnp.asarray(labels), jcenter, None))
        jcenter, jtrained = np.asarray(jcenter), jax.device_get(
            {"params": jstate.params, "batch_stats": jstate.batch_stats})
    np.testing.assert_allclose(center.numpy(), jcenter, atol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)

    trained = to_flax_variables(state.model.state_dict())
    for col in ("params", "batch_stats"):
        for path, leaf in _flat(jtrained[col]):
            ours, start = trained[col], variables[col]
            for k in path:
                ours, start = ours[k], start[k]
            if path[0] == "visual":
                np.testing.assert_allclose(ours, leaf, atol=1e-5, err_msg=str(path))
            else:
                np.testing.assert_array_equal(ours, start, err_msg=str(path))
                np.testing.assert_allclose(leaf, start, atol=0, rtol=0, err_msg=str(path))
    assert not np.array_equal(trained["batch_stats"]["visual"]["bn1"]["mean"],
                              variables["batch_stats"]["visual"]["bn1"]["mean"])
    np.testing.assert_allclose(scores.numpy(), jscores, atol=1e-4)


def test_vmapped_seeds_equal_sequential(converted):
    """``vmap_seeds=True`` on an RN ClipTrainer: every member starts from the
    same weights and batch statistics (JAX's broadcast init), trains its
    seed's plans and keeps its own averages; its losses and AUROCs equal
    the sequential seeds' within 1e-5."""
    cfg, sd, _, _ = converted
    port = ClipTrainer(None, None, None, logger=None, clip_config=cfg, clip_state_dict=sd,
                       device="cpu", **dict(COMMON, epochs=1))
    stack = port.init_states_stacked([11, 12, 13], 2)
    assert stack.tensors.keys() == sd.keys()
    for k, v in sd.items():   # every member, running averages included
        assert all(torch.equal(stack.tensors[k][m], v) for m in range(3)), k
    out = []
    for vmap_seeds in (True, False):
        port = ClipTrainer(None, None, None, logger=None, clip_config=cfg, clip_state_dict=sd,
                           device="cpu", **dict(COMMON, epochs=1))
        port.ds = _combined(B, port.train_specs)
        _, res = port.run(run_classes=[0], run_seeds=2, vmap_seeds=vmap_seeds)
        assert port._last_grid_vmapped == vmap_seeds
        out.append((np.array(port.step_losses), np.array(res["cls_aucs"][0], float)))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    np.testing.assert_allclose(out[0][1], out[1][1], atol=1e-5)
    assert not np.array_equal(out[0][0][:2], out[0][0][2:])   # the seeds' own plans


def test_train_clip_cifar_trains_rn_from_its_checkpoint(tmp_path, monkeypatch, openai_sd):
    """``train_clip_cifar`` takes the RN tower from the checkpoint's shapes
    (no flag), trains it in bf16 and snapshots its batch statistics, which
    ``AnomalyScorer`` serves back: the run's scores within 1e-4."""
    from eoe_tpu_torch.main import train_clip_cifar
    from eoe_tpu_torch.training.clip import prompt_center
    ckpt = tmp_path / "RN-tiny.pt"
    torch.save(openai_sd, ckpt)
    monkeypatch.setenv("EOE_TPU_FAKE_DATA", "1")
    monkeypatch.setenv("EOE_TPU_CLIP_CHECKPOINT", str(ckpt))
    _, res = train_clip_cifar.main(["-e", "1", "--classes", "0", "-it", "1", "-b", "16",
                                    "--oe-size", "32", "--datapath", str(tmp_path)],
                                   device="cpu")
    assert np.isfinite(res["mean_auc"])
    run = [d for d, _, files in os.walk(tmp_path / "results") if "results.json" in files][0]
    with open(pt.join(run, "eval_cls0_it0_anomaly_scores.json")) as f:
        scores = json.load(f)
    snapshot = torch.load(pt.join(run, "snapshots", "snapshot_cls0_it0.pt"), weights_only=True)
    cfg = ClipConfig(**RN_TINY)
    start = from_openai(openai_sd)
    moved = snapshot["params"]["visual.layer1_0.bn1.running_mean"]
    assert not torch.equal(moved, start["visual.layer1_0.bn1.running_mean"])
    assert torch.equal(snapshot["params"]["transformer.blocks.0.attn.qkv.weight"],
                       start["transformer.blocks.0.attn.qkv.weight"])
    model = CLIP(cfg, dtype=torch.bfloat16)
    model.load_state_dict(snapshot["params"])
    center = prompt_center(model, CIFAR10_LABELS[0], CIFAR10_LABELS, device="cpu")
    scorer = AnomalyScorer(snapshot, model, objective="clip", batch_size=16, center=center,
                           compute_dtype=torch.bfloat16, device="cpu",
                           test_specs=[{"op": "clip_pil_preprocessing", "resolution": HW},
                                       {"op": "clip_tensor_preprocessing"}])
    from eoe_tpu_torch.datasets import load_dataset
    test_set = load_dataset("cifar10", str(tmp_path / "datasets"), [0], 0, [], []).test_set
    served = scorer.score(test_set.gather_all())
    want = np.array([scores[str(i)] for i in test_set.indices])
    np.testing.assert_allclose(served, want, atol=1e-4)
