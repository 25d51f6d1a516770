"""CLIP ViT-L/14 and the long attention pair on the CPU.

``VIT_L14``'s shapes; the port's CLIP against the benchmark's plain
reference (``portbench/reference/clip_vit.py``) at a small ViT whose
sequence is over 128 tokens; ``long_qkv_attention``'s plain forward and
backward (what a CPU tensor runs) against autograd of
``default_attention`` and against the JAX package's ``default_attention``
under ``jax.vjp``; and the route that sends a long bf16 sequence on the card
to the pair. The CUDA kernels themselves are held to the plain versions by
tests/test_torch_kernels.py on a card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoe_tpu.models.clip.model import default_attention as jax_default_attention
from eoe_tpu_torch.models.clip import CLIP, VIT_L14, ClipConfig
from eoe_tpu_torch.models.clip import model as clip_model
from eoe_tpu_torch.ops import attention as A
from portbench.harness import weights
from portbench.reference import clip_vit as reference
from portbench.reference.precision import Precision

# width 128 in 2 heads of 64 over 4-px patches of a 48-px image: 144 patches
# and the class token, s = 145
SMALL = dict(embed_dim=32, image_resolution=48, vision_layers=2, vision_width=128,
             vision_patch_size=4, context_length=16, vocab_size=64, transformer_width=64,
             transformer_heads=1, transformer_layers=1)
SEQS = (129, 145, 257)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_vit_l14_parameter_counts():
    """OpenAI's ViT-L/14: 303,966,208 parameters in the image tower,
    427,616,513 in all (the published 428 M)."""
    assert (VIT_L14.vision_width, VIT_L14.vision_layers, VIT_L14.vision_patch_size,
            VIT_L14.vision_heads, VIT_L14.embed_dim) == (1024, 24, 14, 16, 768)
    with torch.device("meta"):
        model = CLIP(VIT_L14, dtype=torch.bfloat16)
    assert sum(p.numel() for p in model.visual.parameters()) == 303_966_208
    assert sum(p.numel() for p in model.parameters()) == 427_616_513
    assert model.visual.positional_embedding.shape == (257, 1024)


def _small_model(seed: int):
    w = weights.make(reference.param_specs(SMALL), seed, "cpu")
    model = CLIP(ClipConfig(**SMALL))
    model.load_state_dict(w)
    return model, w


def _images(seed: int, n: int = 3) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 48, 48, 3, generator=g)


@pytest.mark.parametrize("route", ["default", "pair"])
def test_small_long_vit_against_the_reference(route, monkeypatch):
    """fp32 at s = 145: the image features and one training step's loss and
    image-tower gradients of the port against the plain reference on the
    same seeded weights, through the CPU's route (``default_attention``)
    and through the pair's plain versions (the gate opened to CPU
    tensors). Products and softmax run in other orders on the two sides, so
    features and loss agree to 1e-5, gradients to 1e-4 of their leaf's
    largest entry (a leaf's gradient sums 3 x 145 rows of them)."""
    if route == "pair":
        monkeypatch.setattr(clip_model, "long_qkv_ok",
                            lambda n, s, heads, d, sample=None, masked=False: not masked
                            and A.MAX_SEQ < s <= A.MAX_SINGLE_BLOCK)
    model, w = _small_model(11)
    x = _images(3)
    P = Precision("fp32")
    with torch.no_grad():
        assert torch.allclose(model(x), reference.encode_image(w, x, SMALL, P),
                              atol=1e-5, rtol=1e-5)
    centre = torch.nn.functional.normalize(torch.randn(2, 32, generator=torch.Generator()
                                                       .manual_seed(5)), dim=-1)
    labels = torch.tensor([0, 1, 0])
    before = A.long_qkv_attention.launches
    loss = reference.loss_terms(model(x), labels, centre).mean()
    loss.backward()
    assert A.long_qkv_attention.launches == before   # a CPU tensor launches nothing
    leaves = {n: t.clone().requires_grad_(n.startswith("visual.")) for n, t in w.items()}
    ref = reference.loss_terms(reference.encode_image(leaves, x, SMALL, P), labels, centre).mean()
    ref.backward()
    assert loss.item() == pytest.approx(ref.item(), rel=1e-5)
    for name, p in model.named_parameters():
        if name.startswith("visual."):
            want = leaves[name].grad
            assert (p.grad - want).abs().max() <= 1e-4 * want.abs().max(), name


def _qkv(n, s, heads, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, s, 3 * heads * d, generator=g).to(dtype),
            torch.randn(n, s, heads * d, generator=g).to(dtype))


def _ulp(x: torch.Tensor) -> float:
    """A bf16 unit in the last place at the largest magnitude of ``x``."""
    return 2.0 ** (math.floor(math.log2(x.abs().max().item())) - 7)


def _tolerances(dtype, out, grad):
    """fp32: both sides compute the same function in fp32 with other sums
    (measured up to 1.4e-6 at these shapes). bf16: P is rounded before P.V
    on both sides, the output once after an fp32 sum, so they differ by one
    rounding of the output; the backward rounds dP where autograd does and
    dS where the pair does, so the gradients differ by up to a rounding of
    a bf16 gradient: two units in the last place at its largest value."""
    if dtype == torch.float32:
        return 1e-5, 1e-5
    return 2 * _ulp(out), 2 * _ulp(grad)


def _split(qkv, heads):
    n, s, F = qkv.shape
    d = F // 3 // heads
    return [t.reshape(n, s, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_long_pair_against_default_attention(s, d, dtype):
    heads = 2
    qkv, dout = _qkv(2, s, heads, d, dtype, s + d)
    x = qkv.clone().requires_grad_(True)
    out = A.long_qkv_attention(x, heads)
    out.backward(dout)
    y = qkv.clone().requires_grad_(True)
    ref = A.default_attention(*_split(y, heads), None).transpose(1, 2).reshape(out.shape)
    ref.backward(dout)
    atol_out, atol_grad = _tolerances(dtype, ref.float(), y.grad.float())
    assert out.dtype == x.grad.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= atol_out
    assert (x.grad.float() - y.grad.float()).abs().max().item() <= atol_grad


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_long_pair_against_jax(s, dtype):
    """The JAX package's plain path: its ``default_attention`` and
    ``jax.vjp`` of it, in the same dtype; tolerances as against the port's
    ``default_attention``."""
    heads, d = 2, 64
    qkv, dout = _qkv(2, s, heads, d, dtype, 7 * s)
    x = qkv.clone().requires_grad_(True)
    out = A.long_qkv_attention(x, heads)
    out.backward(dout)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    n = qkv.shape[0]

    def f(z):
        q, k, v = (t.reshape(n, s, heads, d).transpose(0, 2, 1, 3) for t in jnp.split(z, 3, -1))
        return jax_default_attention(q, k, v, None).transpose(0, 2, 1, 3).reshape(n, s, -1)

    jout, vjp = jax.vjp(f, jnp.asarray(qkv.float().numpy(), jdt))
    (jgrad,) = vjp(jnp.asarray(dout.float().numpy(), jdt))
    jout = torch.from_numpy(np.array(jout, np.float32))
    jgrad = torch.from_numpy(np.array(jgrad, np.float32))
    atol_out, atol_grad = _tolerances(dtype, jout, jgrad)
    assert (out.float() - jout).abs().max().item() <= atol_out
    assert (x.grad.float() - jgrad).abs().max().item() <= atol_grad


def test_long_pair_saves_its_projection_output_and_statistics():
    """Under autograd the pair keeps qkv, the output and the fp32 row
    statistics, nothing else: no (s, s) tensor."""
    qkv, _ = _qkv(2, 145, 2, 64, torch.bfloat16, 1)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        A.long_qkv_attention(qkv.requires_grad_(True), 2)
    assert sorted(tuple(t.shape) for t in saved) == [(2, 2, 145, 2), (2, 145, 128), (2, 145, 384)]


def test_long_pair_rejects():
    with pytest.raises(ValueError, match="128 < s <= 1024"):
        A.long_qkv_attention(torch.zeros(1, 128, 3 * 128), 2)
    with pytest.raises(ValueError, match="128 < s <= 1024"):
        A.long_qkv_attention(torch.zeros(1, 1025, 3 * 128), 2)
    with pytest.raises(ValueError, match="d in"):
        A.long_qkv_attention(torch.zeros(1, 200, 3 * 64), 2)


class _Sample:
    """What the gate reads of a projection: its device and dtype."""

    def __init__(self, cuda: bool, dtype):
        self.is_cuda, self.dtype = cuda, dtype


@pytest.mark.parametrize("case,taken", [
    (dict(s=257), True), (dict(s=1024), True), (dict(d=128), True),
    (dict(s=128), False), (dict(s=1025), False), (dict(d=32), False),
    (dict(dtype=torch.float32), False), (dict(cuda=False), False), (dict(masked=True), False),
    (dict(env="0"), False)])
def test_long_route_gate(case, taken, monkeypatch):
    """The pair takes a CUDA bf16 projection without a mask at
    128 < s <= 1024 and d in (64, 128); fp32 (the scorer) and the CPU keep
    ``default_attention``, as does ``EOE_TPU_FUSED_ATTN=0``."""
    c = {**dict(s=257, d=64, dtype=torch.bfloat16, cuda=True, masked=False, env="1"), **case}
    monkeypatch.setenv("EOE_TPU_FUSED_ATTN", c["env"])
    sample = _Sample(c["cuda"], c["dtype"])
    assert A.long_qkv_ok(256, c["s"], 16, c["d"], sample, masked=c["masked"]) is taken
    assert not A.long_qkv_ok(256, c["s"], 16, c["d"], None)


def test_cpu_route_counts_through_the_function(monkeypatch):
    """With the gate opened to CPU tensors, every image block of the small
    ViT calls the pair's Function (its plain forward once a block, its
    plain backward once a block) and the text tower does not; the features
    and gradients are those of the CPU's ``default_attention`` route to
    fp32 rounding."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = A.long_qkv_attention_fwd_ref, A.long_qkv_attention_bwd_ref

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    model, _ = _small_model(2)
    x = _images(4, 2)
    plain = model(x)
    plain.sum().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad()
    monkeypatch.setattr(A, "long_qkv_attention_fwd_ref", count("fwd", fwd))
    monkeypatch.setattr(A, "long_qkv_attention_bwd_ref", count("bwd", bwd))
    monkeypatch.setattr(clip_model, "long_qkv_ok",
                        lambda n, s, heads, d, sample=None, masked=False: not masked
                        and A.MAX_SEQ < s <= A.MAX_SINGLE_BLOCK)
    routed = model(x)
    routed.sum().backward()
    model.encode_text(torch.randint(0, 64, (2, 16)))   # s = 16: not the pair's
    assert calls == {"fwd": SMALL["vision_layers"], "bwd": SMALL["vision_layers"]}
    assert torch.allclose(routed, plain, atol=1e-5)
    for n, g in grads.items():
        assert (dict(model.named_parameters())[n].grad - g).abs().max() <= 1e-4 * g.abs().max()


def test_fp32_scorer_is_unchanged(monkeypatch):
    """The fp32 model (the scorer's) at s = 145 gives the same bits through
    the normal route as with the fused kernels switched off: it never
    reaches the pair."""
    model, _ = _small_model(6)
    x = _images(8, 2)
    with torch.no_grad():
        got = model(x)
        monkeypatch.setenv("EOE_TPU_FUSED_ATTN", "0")
        assert torch.equal(got, model(x))


def test_long_pair_vmap_folds_the_members():
    """Under ``torch.func.vmap`` the forward and the backward run once on the
    members folded into the image axis, with each member's own result."""
    heads, K = 2, 3
    qkv, dout = _qkv(K * 2, 145, heads, 64, torch.float32, 9)
    qkv, dout = qkv.reshape(K, 2, *qkv.shape[1:]), dout.reshape(K, 2, *dout.shape[1:])
    calls = []
    fwd, bwd = A.long_qkv_attention_fwd_ref, A.long_qkv_attention_bwd_ref

    def vjp_of(z, g):
        out, pull = torch.func.vjp(lambda t: A._LongAttention.apply(
            t, heads, lambda *a: calls.append(("fwd", a[0].shape[0])) or fwd(*a),
            lambda *a: calls.append(("bwd", a[0].shape[0])) or bwd(*a))[0], z)
        return out, pull(g)[0]

    out, grad = torch.func.vmap(vjp_of)(qkv, dout)
    assert calls == [("fwd", K * 2), ("bwd", K * 2)]
    for m in range(K):
        x = qkv[m].clone().requires_grad_(True)
        o = A.long_qkv_attention(x, heads)
        o.backward(dout[m])
        assert torch.allclose(out[m], o, atol=1e-6)
        assert torch.allclose(grad[m], x.grad, atol=1e-6)
