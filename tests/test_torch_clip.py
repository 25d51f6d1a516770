"""The port's CLIP, weight bridge and tokenizer against the JAX package's.

One tiny random CLIP (embed 64, 32 px, patch 8 so s=17, vision and text
width 128 with 2 heads of 64 and 2 layers, context 77) is initialised by the
port, carried to a Flax params tree with ``convert.to_flax_numpy`` and run
by both packages on the same inputs made with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.models.clip import CLIP as JaxCLIP, ClipConfig as JaxConfig
from eoe_tpu.models.clip import tokenize as jax_tokenize
from eoe_tpu_torch.models.clip import CLIP, ClipConfig, from_flax, to_flax_numpy, tokenize
from eoe_tpu_torch.ops.attention import fused_qkv_attention_ref
from eoe_tpu_torch.training.clip import CIFAR10_LABELS

TINY = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
            vision_patch_size=8, context_length=77, vocab_size=49408,
            transformer_width=128, transformer_heads=2, transformer_layers=2,
            vision_heads_override=2)
# tests/test_clip.py's golden prompts, then the CIFAR-10 one-vs-rest prompts
PROMPTS = (["a photo of a cat", "a photo of something", "a photo of a airplane", "hello world"]
           + [f"a photo of a {c}" for c in CIFAR10_LABELS])


@pytest.fixture(scope="module")
def tiny():
    sd = CLIP(ClipConfig(**TINY), generator=torch.Generator().manual_seed(0)).state_dict()
    return to_flax_numpy(sd), sd


def _port(sd, dtype=torch.float32, **kw):
    model = CLIP(ClipConfig(**TINY), dtype=dtype, **kw)
    model.load_state_dict(sd)
    return model.eval()


def _jax(params, method, *args, dtype=jnp.float32):
    jm = JaxCLIP(JaxConfig(**TINY), dtype=dtype)
    fn = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=getattr(jm, method)))
    out = fn(params, *args)
    return tuple(np.asarray(o, np.float32) for o in out) if isinstance(out, tuple) \
        else np.asarray(out, np.float32)


def _inputs(seed=0, n=3):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (n, 32, 32, 3)).astype(np.float32)
    tokens = tokenize(PROMPTS[:n])
    return images, tokens


def test_bridge_round_trip_is_exact(tiny):
    params, sd = tiny
    # the carried tree has exactly the JAX model's paths and shapes
    jm = JaxCLIP(JaxConfig(**TINY))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                            jnp.zeros((1, 77), jnp.int32),
                                            method=jm.contrastive))["params"]
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == \
        jax.tree_util.tree_map(lambda a: a.shape, params)
    back = from_flax(params)
    assert back.keys() == sd.keys()
    assert all(torch.equal(sd[k], back[k]) for k in sd)
    again = to_flax_numpy(back)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                                 jax.tree_util.tree_leaves_with_path(again)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    _port(back)  # loads strictly: every key and shape matches the module


@pytest.mark.parametrize("attention", ["dispatch", "fused_ref"])
def test_encoders_match_jax_fp32(tiny, attention):
    """atol 2e-4, tests/test_clip.py's convention. ``fused_ref`` runs every
    block through the kernel's plain version instead of the CPU dispatch."""
    params, sd = tiny
    kw = {"qkv_attention": fused_qkv_attention_ref} if attention == "fused_ref" else {}
    model = _port(sd, **kw)
    images, tokens = _inputs()
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(images)).numpy()
        txt = model.encode_text(torch.from_numpy(tokens).long()).numpy()
        li, lt = (t.numpy() for t in model.contrastive(torch.from_numpy(images),
                                                       torch.from_numpy(tokens).long()))
    np.testing.assert_allclose(img, _jax(params, "encode_image", jnp.asarray(images)), atol=2e-4)
    np.testing.assert_allclose(txt, _jax(params, "encode_text", jnp.asarray(tokens)), atol=2e-4)
    jli, jlt = _jax(params, "contrastive", jnp.asarray(images), jnp.asarray(tokens))
    # logits are 100/7 x cosines: 2e-4 on the features is ~2e-3 here
    np.testing.assert_allclose(li, jli, atol=2e-3)
    np.testing.assert_allclose(lt, jlt, atol=2e-3)


def test_encoders_match_jax_bf16(tiny):
    """bf16 compute, fp32 params, on both sides. The two frameworks round the
    dense layers' outputs at other places (flax adds the bias after rounding
    the product, torch's addmm before), so the features (|f| ~ 1-4) drift by
    a few bf16 ulps per layer: held to 0.1, tests/test_clip.py's bf16 bound."""
    params, sd = tiny
    model = _port(sd, dtype=torch.bfloat16)
    images, tokens = _inputs(seed=1)
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(images)).float().numpy()
        txt = model.encode_text(torch.from_numpy(tokens).long()).float().numpy()
    jimg = _jax(params, "encode_image", jnp.asarray(images), dtype=jnp.bfloat16)
    jtxt = _jax(params, "encode_text", jnp.asarray(tokens), dtype=jnp.bfloat16)
    assert np.abs(img - jimg).max() < 0.1
    assert np.abs(txt - jtxt).max() < 0.1


def test_tokenizer_ids_match_jax():
    np.testing.assert_array_equal(tokenize(PROMPTS), jax_tokenize(PROMPTS))
    np.testing.assert_array_equal(tokenize("a photo of a cat")[0, :7],
                                  [49406, 320, 1125, 539, 320, 2368, 49407])


def test_unported_variants_raise():
    with pytest.raises(NotImplementedError):
        CLIP(ClipConfig(vision_layers=(3, 4, 6, 3), vision_width=64, vision_patch_size=None))


# ---------------------------------------------------------------- OpenAI checkpoints

def _openai_sd():
    """A tiny OpenAI-format state dict in fp16, as the published checkpoints
    store it (heads of 64: the loader derives width // 64), from seed 1."""
    from eoe_tpu_torch.models.clip import to_openai
    cfg = ClipConfig(**dict(TINY, vision_heads_override=None))
    sd = to_openai(CLIP(cfg, generator=torch.Generator().manual_seed(1)).state_dict(), cfg)
    assert {v.dtype for v in sd.values()} == {torch.float16}
    assert sd["visual.transformer.resblocks.0.attn.in_proj_weight"].shape == (384, 128)
    assert sd["visual.conv1.weight"].shape == (128, 3, 8, 8)
    return {**sd, "input_resolution": torch.tensor(32), "context_length": torch.tensor(77),
            "vocab_size": torch.tensor(49408)}


def test_openai_conversion_equals_jax():
    """``config_from_state_dict`` equals the JAX package's, and
    ``from_openai`` gives exactly the weights of the JAX converter
    (``to_flax``) carried over with ``from_flax``."""
    import dataclasses

    from eoe_tpu.models.clip.convert import config_from_state_dict as jax_config, to_flax
    from eoe_tpu_torch.models.clip import config_from_state_dict, from_openai
    sd = _openai_sd()
    meta = ("input_resolution", "context_length", "vocab_size")
    cfg = config_from_state_dict({k: v for k, v in sd.items() if k not in meta})
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config(sd))
    ours, theirs = from_openai(sd), from_flax(to_flax(sd)["params"])
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == torch.float32 and torch.equal(ours[k], theirs[k]), k
    with pytest.raises(KeyError, match="unexpected"):
        from_openai({**sd, "visual.extra": torch.zeros(1)})
    resnet = {k: v for k, v in sd.items() if k != "visual.proj"}
    with pytest.raises(NotImplementedError, match="ModifiedResNet is not ported yet"):
        config_from_state_dict(resnet)


def test_openai_checkpoint_features_match_jax(tmp_path):
    """The checkpoint file through ``load_checkpoint`` and ``from_openai``:
    CLIP's image and text features at 1e-4 against the JAX CLIP with the
    JAX converter's variables, and one image block's and one text block's
    attention output (the joint q|k|v rows read per head) at 1e-5."""
    from eoe_tpu.models.clip.convert import to_flax
    from eoe_tpu.models.clip.model import MultiHeadAttention as JaxMHA
    from eoe_tpu_torch.models.clip import config_from_state_dict, from_openai, load_checkpoint
    path = str(tmp_path / "ViT-tiny.pt")
    torch.save(_openai_sd(), path)
    sd = load_checkpoint(path)
    model = CLIP(config_from_state_dict(sd))
    model.load_state_dict(from_openai(sd))
    params = to_flax(sd)["params"]
    images, tokens = _inputs(seed=2)
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(images)).numpy()
        txt = model.encode_text(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(img, _jax(params, "encode_image", jnp.asarray(images)), atol=1e-4)
    np.testing.assert_allclose(txt, _jax(params, "encode_text", jnp.asarray(tokens)), atol=1e-4)
    x = np.random.default_rng(3).normal(0, 1, (3, 17, 128)).astype(np.float32)
    for tower, block, causal in (("visual", model.visual.transformer.blocks[0], False),
                                 ("text", model.transformer.blocks[0], True)):
        p = (params["visual"]["transformer"] if tower == "visual" else params["transformer"])
        mask = torch.full((17, 17), float("-inf")).triu(1) if causal else None
        with torch.no_grad():
            ours = block.attn(torch.from_numpy(x), mask, causal).numpy()
        ref = JaxMHA(128, 2).apply({"params": p["block0"]["attn"]}, jnp.asarray(x),
                                   None if mask is None else jnp.asarray(mask.numpy()), causal)
        np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-5)


def test_clip_trainer_finds_its_checkpoint(tmp_path, monkeypatch):
    """``checkpoint_path``, then ``$EOE_TPU_CLIP_CHECKPOINT``, then
    ``~/.cache/clip/ViT-B-32.pt``; none of them: FileNotFoundError."""
    from eoe_tpu_torch.models.clip import from_openai
    from eoe_tpu_torch.training import TRAINER
    from eoe_tpu_torch.training.clip import resolve_checkpoint
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("EOE_TPU_CLIP_CHECKPOINT", raising=False)
    kw = dict(dataset="cifar10", oe_dataset=None, datapath="", logger=None, epochs=0, lr=1e-3,
              wdk=0.0, milestones=[], batch_size=4, device="cpu")
    with pytest.raises(FileNotFoundError, match="EOE_TPU_CLIP_CHECKPOINT"):
        TRAINER["clip"](None, None, None, **kw)
    sd = _openai_sd()
    default = tmp_path / "home" / ".cache" / "clip" / "ViT-B-32.pt"
    default.parent.mkdir(parents=True)
    torch.save(sd, default)
    env, arg = tmp_path / "env.pt", tmp_path / "arg.pt"
    torch.save(sd, env)
    torch.save(sd, arg)
    assert resolve_checkpoint() == str(default)
    monkeypatch.setenv("EOE_TPU_CLIP_CHECKPOINT", str(env))
    assert resolve_checkpoint() == str(env)
    assert resolve_checkpoint(str(arg)) == str(arg)
    assert resolve_checkpoint(str(tmp_path / "missing.pt")) == str(env)
    trainer = TRAINER["clip"](None, None, None, checkpoint_path=str(arg), **kw)
    assert trainer.model.config.vision_width == 128 and trainer.model.config.vision_heads == 2
    weights = from_openai(sd)
    assert all(torch.equal(trainer._clip_state_dict[k], weights[k]) for k in weights)
