"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and nvcc and skips elsewhere. The file
imports neither jax nor eoe_tpu, so it also runs where only the port's
dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""

import pytest
import torch

from eoe_tpu_torch.models.clip.model import MultiHeadAttention
from eoe_tpu_torch.ops import attention as A


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (n, s, heads, d, causal): both CLIP encoders, a ragged causal case, d=128,
# and the longest sequence one tile takes (fp32 d=128 at s=128 needs 198 KB
# of shared memory, bf16 204 KB); then the bf16 design's padding and tile
# edges (rows padded to 32, 64, 80 or 128), causal and full
EDGES = [(2, s, 2, d, causal) for s in (1, 16, 17, 64, 80, 127) for d in (64, 128)
         for causal in (False, True)]
CASES = [(4, 50, 12, 64, False), (4, 77, 8, 64, True), (3, 21, 4, 64, True),
         (2, 10, 2, 128, True), (2, 128, 2, 128, False)] + EDGES


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_fused_qkv_attention_matches_ref(cuda, case, dtype, atol):
    n, s, h, d, causal = case
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(n, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    before = A.fused_qkv_attention.launches
    out = A.fused_qkv_attention(qkv, h, causal)
    torch.cuda.synchronize()
    assert A.fused_qkv_attention.launches == before + 1
    ref = A.fused_qkv_attention_ref(qkv, h, causal)
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_fused_qkv_attention_rejects(cuda):
    qkv = torch.zeros(2, 10, 3 * 128, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        A.fused_qkv_attention(qkv.transpose(0, 1).contiguous().transpose(0, 1), 2, False)
    with pytest.raises(ValueError, match="misaligned"):
        A.fused_qkv_attention(torch.zeros(1 + 10 * 384, device=cuda, dtype=torch.bfloat16)[1:]
                              .view(1, 10, 384), 2, False)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        A.fused_qkv_attention(qkv.half(), 2, False)
    # the backward kernel checks dout as the forward checks qkv
    with pytest.raises(ValueError, match="dout must be"):
        A._bwd_kernel(qkv, torch.zeros(2, 10, 64, device=cuda), 2, False)
    with pytest.raises(ValueError, match="contiguous dout"):
        A._bwd_kernel(qkv, torch.zeros(10, 2, 128, device=cuda).transpose(0, 1), 2, False)


@pytest.mark.cuda
def test_bf16_needs_16_byte_alignment(cuda):
    """The bf16 kernels copy rows in 16-byte pieces: a bf16 qkv or dout view
    whose data is 8 bytes off raises instead of falling back; 16 bytes off
    runs."""
    buf = torch.zeros(8 + 10 * 384, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte pieces; it is misaligned"):
        A.fused_qkv_attention(buf[4:4 + 10 * 384].view(1, 10, 384), 2, False)
    qkv = buf[8:].view(1, 10, 384)
    A.fused_qkv_attention(qkv, 2, False)
    dout = torch.zeros(4 + 10 * 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte pieces; it is misaligned"):
        A._bwd_kernel(qkv, dout[4:].view(1, 10, 128), 2, False)
    with pytest.raises(ValueError, match="16-byte pieces; it is misaligned"):
        A._group_bwd_kernel(qkv, dout[4:].view(1, 10, 128), 2, False)


@pytest.mark.cuda
def test_fp16_attention_on_card_raises(cuda):
    """A dtype the kernel does not take raises on the card; the model does not
    switch to the plain version for it."""
    mha = MultiHeadAttention(128, 2, torch.float16).to(cuda)
    x = torch.zeros(2, 10, 128, device=cuda, dtype=torch.float16)
    with torch.inference_mode(), pytest.raises(ValueError, match="float32 or bfloat16"):
        mha(x)


def _bwd_tol(dtype, ref):
    """fp32: the kernel and the plain version differ in summation order and in
    P's normalisation (by the reciprocal sum, not a division: an ulp of P).
    bf16: an order flip can move dS across a rounding boundary before the
    second products, and the output is rounded once more; 2^-5 of the largest
    gradient covers both."""
    scale = ref.float().abs().max().item()
    return (2e-5 if dtype == torch.float32 else 2 ** -5) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_qkv_attention_bwd_matches_ref(cuda, case, dtype):
    n, s, h, d, causal = case
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(n, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    dout = torch.randn(n, s, h * d, generator=g, device=cuda).to(dtype)
    before = A.fused_qkv_attention.bwd_launches
    dqkv = A._bwd_kernel(qkv, dout, h, causal)
    torch.cuda.synchronize()
    assert A.fused_qkv_attention.bwd_launches == before + 1
    ref = A.fused_qkv_attention_bwd_ref(qkv, dout, h, causal)
    assert dqkv.shape == ref.shape and dqkv.dtype == dtype
    assert (dqkv.float() - ref.float()).abs().max().item() <= _bwd_tol(dtype, ref)


# a model-axis rank's heads at the training batch: ViT-B/32's 12 over two
# ranks, and the text tower's 8 (causal)
RANK_CASES = [(256, 50, 6, 64, False), (64, 77, 4, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", RANK_CASES)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_fused_pair_on_a_rank_heads(cuda, case, dtype, atol):
    """The forward and backward kernels on one rank's heads against their
    plain versions."""
    n, s, h, d, causal = case
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(n, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    dout = torch.randn(n, s, h * d, generator=g, device=cuda).to(dtype)
    before = (A.fused_qkv_attention.launches, A.fused_qkv_attention.bwd_launches)
    out = A.fused_qkv_attention(qkv, h, causal)
    dqkv = A._bwd_kernel(qkv, dout, h, causal)
    torch.cuda.synchronize()
    assert (A.fused_qkv_attention.launches, A.fused_qkv_attention.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    ref = A.fused_qkv_attention_ref(qkv, h, causal)
    assert (out.float() - ref.float()).abs().max().item() <= atol
    dref = A.fused_qkv_attention_bwd_ref(qkv, dout, h, causal)
    assert (dqkv.float() - dref.float()).abs().max().item() <= _bwd_tol(dtype, dref)


@pytest.mark.cuda
def test_attention_gradient_through_the_kernels(cuda):
    """One ViT-B/32 attention layer in fp32: its input and weight gradients
    through the autograd Function (both kernels) against the same layer
    through the plain pair."""
    torch.manual_seed(0)
    mha = MultiHeadAttention(768, 12, torch.float32).to(cuda)
    plain = MultiHeadAttention(768, 12, torch.float32,
                               qkv_attention=A.fused_qkv_attention_ref).to(cuda)
    plain.load_state_dict(mha.state_dict())
    x = torch.randn(8, 50, 768, device=cuda)
    grads = []
    for layer in (mha, plain):
        xi = x.clone().requires_grad_()
        fwd, bwd = A.fused_qkv_attention.launches, A.fused_qkv_attention.bwd_launches
        layer(xi).square().sum().backward()
        launched = (A.fused_qkv_attention.launches - fwd, A.fused_qkv_attention.bwd_launches - bwd)
        assert launched == ((1, 1) if layer is mha else (0, 0))
        grads.append([xi.grad] + [p.grad for p in layer.parameters()])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


# ---------------------------------------------------------------- group grid


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_group_forward_matches_ref_and_monolithic(cuda, case, dtype, atol):
    """The lane-group forward runs the monolithic kernel's per-head code, so
    the two agree bit for bit; the plain version within the forward's
    tolerance."""
    n, s, h, d, causal = case
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(n, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    before = A.fused_qkv_attention.group_launches
    out = A._group_fwd_kernel(qkv, h, causal)
    torch.cuda.synchronize()
    assert A.fused_qkv_attention.group_launches == before + 1
    assert torch.equal(out, A._fwd_kernel(qkv, h, causal))
    ref = A.fused_qkv_attention_fwd_ref(qkv, h, causal)
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_backward_matches_ref_and_monolithic(cuda, case, dtype):
    n, s, h, d, causal = case
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(n, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    dout = torch.randn(n, s, h * d, generator=g, device=cuda).to(dtype)
    before = A.fused_qkv_attention.group_bwd_launches
    dqkv = A._group_bwd_kernel(qkv, dout, h, causal)
    torch.cuda.synchronize()
    assert A.fused_qkv_attention.group_bwd_launches == before + 1
    assert torch.equal(dqkv, A._bwd_kernel(qkv, dout, h, causal))
    ref = A.fused_qkv_attention_bwd_ref(qkv, dout, h, causal)
    assert (dqkv.float() - ref.float()).abs().max().item() <= _bwd_tol(dtype, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(256, 50, 12, 64, False), (64, 77, 8, 64, True)])
def test_group_grid_bf16_is_monolithic_bit_for_bit(cuda, case):
    """In bf16 both grids run the same tensor-core code per head, so the
    group kernels give the monolithic kernels' bits, forward and backward
    (both backwards write the packed d(qkv)), at the main path's full
    batches (the tests above take small ones)."""
    n, s, h, d, causal = case
    g = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn(n, s, 3 * h * d, generator=g, device=cuda).bfloat16()
    dout = torch.randn(n, s, h * d, generator=g, device=cuda).bfloat16()
    assert torch.equal(A._group_fwd_kernel(qkv, h, causal), A._fwd_kernel(qkv, h, causal))
    assert torch.equal(A._group_bwd_kernel(qkv, dout, h, causal),
                       A._bwd_kernel(qkv, dout, h, causal))


@pytest.mark.cuda
def test_attention_gradient_through_the_group_kernels(cuda, monkeypatch):
    """With ``GROUP_GRID`` on, one ViT-B/32 attention layer launches the group
    kernels and not the monolithic ones, and gives the plain pair's
    gradients."""
    monkeypatch.setattr(A, "GROUP_GRID", True)
    torch.manual_seed(0)
    mha = MultiHeadAttention(768, 12, torch.float32).to(cuda)
    plain = MultiHeadAttention(768, 12, torch.float32,
                               qkv_attention=A.fused_qkv_attention_ref).to(cuda)
    plain.load_state_dict(mha.state_dict())
    x = torch.randn(8, 50, 768, device=cuda)
    counters = ("launches", "bwd_launches", "group_launches", "group_bwd_launches")
    grads = []
    for layer in (mha, plain):
        xi = x.clone().requires_grad_()
        before = [getattr(A.fused_qkv_attention, c) for c in counters]
        layer(xi).square().sum().backward()
        moved = [getattr(A.fused_qkv_attention, c) - b for c, b in zip(counters, before)]
        assert moved == ([0, 0, 1, 1] if layer is mha else [0, 0, 0, 0])
        grads.append([xi.grad] + [p.grad for p in layer.parameters()])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 31, 32, 33, 50, 77, 128])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_fp32_forward_tiles_on_both_grids(cuda, s, d, causal):
    """The fp32 forward's register tiles at the edges of a lane's 32-key
    chunks and of the warps' quads of rows: the plain version within 2e-5,
    and the group grid equal to the monolithic one bit for bit (both run
    one per-head function)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(3, s, 3 * 2 * d, generator=g, device=cuda)
    out = A._fwd_kernel(qkv, 2, causal)
    assert torch.equal(out, A._group_fwd_kernel(qkv, 2, causal))
    ref = A.fused_qkv_attention_fwd_ref(qkv, 2, causal)
    assert (out - ref).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 31, 32, 33, 50, 64, 77, 96, 97, 127, 128])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_fp32_backward_tiles_on_both_grids(cuda, s, d, causal):
    """The fp32 backward's register tiles at the edges of the 32-row chunks
    and the quads, and across its two designs (P and dS kept beside four
    tiles up to s=96 at d=64 and s=64 at d=128, which covers both CLIP
    towers; P and dS recomputed above): the design each grid's launcher
    reports, the plain version within 2e-5 of the largest gradient, and the
    group grid equal to the monolithic one bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(6)
    qkv = torch.randn(3, s, 3 * 2 * d, generator=g, device=cuda)
    dout = torch.randn(3, s, 2 * d, generator=g, device=cuda)
    fq = A.fused_qkv_attention
    before = (fq.resident_bwd_launches, fq.recompute_bwd_launches)
    dqkv = A._bwd_kernel(qkv, dout, 2, causal)
    assert torch.equal(dqkv, A._group_bwd_kernel(qkv, dout, 2, causal))
    resident = s <= (96 if d == 64 else 64)
    assert (fq.resident_bwd_launches - before[0], fq.recompute_bwd_launches - before[1]) == (
        (2, 0) if resident else (0, 2))
    ref = A.fused_qkv_attention_bwd_ref(qkv, dout, 2, causal)
    assert (dqkv - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()


@pytest.mark.cuda
def test_fp32_needs_16_byte_alignment(cuda):
    """The fp32 forward copies rows in 16-byte pieces too: a view 4 bytes
    off raises."""
    buf = torch.zeros(4 + 10 * 384, device=cuda)
    with pytest.raises(ValueError, match="16-byte pieces; it is misaligned"):
        A.fused_qkv_attention(buf[1:1 + 10 * 384].view(1, 10, 384), 2, False)
    A.fused_qkv_attention(buf[4:].view(1, 10, 384), 2, False)


# ---------------------------------------------------------------- flash attention

# (n, heads, S, d, mask): both CLIP towers, the JAX tests' d=32, the longest
# single block, d=128 and d=256 with an arbitrary finite mask, a ragged d
# with masked holes, and a head wider than one 256-column chunk
FLASH_CASES = [(2, 12, 50, 64, None), (2, 8, 77, 64, "causal"), (2, 2, 77, 32, "causal"),
               (1, 2, 1024, 64, None), (2, 4, 64, 128, "random"), (1, 2, 100, 256, "random"),
               (2, 3, 33, 40, "holes"), (2, 2, 77, 300, "random")]


def _flash_inputs(case, dtype, device, seed=0):
    n, h, s, d, kind = case
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(n, h, s, d, generator=g, device=device).to(dtype) for _ in range(3))
    if kind is None:
        mask = None
    elif kind == "causal":
        mask = torch.full((s, s), float("-inf"), device=device).triu(1)
    else:
        mask = torch.randn(s, s, generator=g, device=device)
        if kind == "holes":  # -inf off the diagonal: every row keeps one key
            holes = torch.rand(s, s, generator=g, device=device) < 0.3
            mask = mask.masked_fill(holes & ~torch.eye(s, dtype=torch.bool, device=device),
                                    float("-inf"))
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_flash_attention_matches_ref(cuda, case, dtype, atol):
    q, k, v, mask = _flash_inputs(case, dtype, cuda)
    before = A.flash_attention.launches
    out = A.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = A.flash_attention_ref(q, k, v, mask)
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_flash_attention_takes_head_split_views(cuda):
    """The model passes q, k, v as strided views of the joint projection;
    the kernel reads them in place and returns what it returns for
    contiguous copies."""
    n, s, h, d = 3, 50, 12, 64
    qkv = torch.randn(n, s, 3 * h * d, device=cuda)
    q, k, v = (t.reshape(n, s, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    out = A.flash_attention(q, k, v)
    assert torch.equal(out, A.flash_attention(q.contiguous(), k.contiguous(), v.contiguous()))
    assert out.transpose(1, 2).is_contiguous()   # the model's transpose back is free


@pytest.mark.cuda
def test_flash_attention_rejects(cuda):
    q = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        A.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        A.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="mask"):
        A.flash_attention(q, q, q, torch.zeros(16, 15, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 2, 64, 16, device=cuda).transpose(2, 3)
        A.flash_attention(t, t, t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradient_is_default_attentions(cuda, dtype):
    """The backward differentiates ``default_attention`` with the mask, as the
    JAX package's does; no kernel runs in it."""
    q, k, v, mask = _flash_inputs((2, 8, 77, 64, "causal"), dtype, cuda, seed=1)
    g = torch.randn(q.shape, device=cuda).to(dtype)
    grads = []
    for fn in (A.flash_attention, A.default_attention):
        inputs = [t.clone().requires_grad_() for t in (q, k, v)]
        before = A.flash_attention.launches
        fn(*inputs, mask).backward(g)
        assert A.flash_attention.launches == before + (fn is A.flash_attention)
        grads.append([t.grad for t in inputs])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# The flash kernel's variants at their tile edges: S around the 16-row
# fragments, the 32- and 64-key tiles, the 128 rows of one whole-sequence
# block and the longest sequence; d of 32, 64 and 128 (padded to the
# tensor-core and register-tile widths) and 300 (the CUDA cores, in chunks
# of 256 columns).
EDGE_S = [1, 15, 16, 17, 50, 64, 65, 77, 128, 129, 512, 1000, 1024]
EDGE_D = [32, 64, 128, 300]


def _flash_views(n, h, s, d, dtype, device, offset, seed):
    """q, k, v of (n, h, s, d): contiguous, or (offset) views of one buffer
    one element past a 16-byte boundary, which only the CUDA-core variant
    takes."""
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(3 * n * h * s * d + 1, generator=g, device=device).to(dtype)
    buf = buf[1:] if offset else buf[:-1]
    return buf.view(3, n, h, s, d).unbind(0)


def _expected_variant(dtype, d, offset):
    if offset or d > 128:
        return "core"
    return "tc" if dtype == torch.bfloat16 else "tile"


def _flash_counted(q, k, v, mask):
    before = (A.flash_attention.launches, A.flash_attention.tc_launches,
              A.flash_attention.tile_launches)
    out = A.flash_attention(q, k, v, mask)
    launches, tc, tile = (after - b for after, b in zip(
        (A.flash_attention.launches, A.flash_attention.tc_launches,
         A.flash_attention.tile_launches), before))
    assert launches == 1
    return out, {(1, 0): "tc", (0, 1): "tile", (0, 0): "core"}[(tc, tile)]


@pytest.mark.cuda
@pytest.mark.parametrize("s", EDGE_S)
@pytest.mark.parametrize("d", EDGE_D)
@pytest.mark.parametrize("kind", [None, "causal", "random"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
def test_flash_variants_at_tile_edges(cuda, s, d, kind, dtype, atol, offset):
    q, k, v = _flash_views(1, 2, s, d, dtype, cuda, offset, seed=s * 1000 + d)
    g = torch.Generator(device=cuda).manual_seed(s)
    mask = {None: None,
            "causal": torch.full((s, s), float("-inf"), device=cuda).triu(1),
            "random": torch.randn(s, s, generator=g, device=cuda)}[kind]
    out, variant = _flash_counted(q, k, v, mask)
    torch.cuda.synchronize()
    assert variant == _expected_variant(dtype, d, offset)
    ref = A.flash_attention_ref(q, k, v, mask)
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("s", [20, 77, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
def test_flash_fully_masked_row_is_nan(cuda, s, dtype, offset):
    """A row whose every logit is -inf is NaN in every variant, as in the JAX
    kernel (no guard turns it into zeros); the other rows stay finite and
    agree with the plain version."""
    q, k, v = _flash_views(1, 2, s, 64, dtype, cuda, offset, seed=7)
    mask = torch.full((s, s), float("-inf"), device=cuda).triu(1)
    mask[5] = float("-inf")
    out, variant = _flash_counted(q, k, v, mask)
    assert variant == _expected_variant(dtype, 64, offset)
    assert out[:, :, 5].isnan().all()
    rows = torch.arange(s, device=cuda) != 5
    assert out[:, :, rows].isfinite().all()
    ref = A.flash_attention_ref(q, k, v, mask)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (out[:, :, rows].float() - ref[:, :, rows].float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_flash_head_split_views_take_the_fast_variant(cuda, dtype, atol):
    """CLIP's head-split views of the joint projection (16-byte rows) take the
    tensor cores in bf16 and the register tiles in fp32; the same views of a
    projection one element off take the CUDA cores; the two agree."""
    n, s, h, d = 4, 77, 8, 64
    buf = torch.randn(n * s * 3 * h * d + 1, device=cuda).to(dtype)

    def views(t):
        qkv = t.view(n, s, 3 * h * d)
        return [x.reshape(n, s, h, d).transpose(1, 2) for x in qkv.chunk(3, dim=-1)]

    aligned = views(buf[:-1].clone())
    off = buf.clone()
    off[1:] = buf[:-1]
    mask = torch.full((s, s), float("-inf"), device=cuda).triu(1)
    fast, variant = _flash_counted(*aligned, mask)
    assert variant == ("tc" if dtype == torch.bfloat16 else "tile")
    slow, variant = _flash_counted(*views(off[1:]), mask)
    assert variant == "core"
    assert (fast.float() - slow.float()).abs().max().item() <= atol


# ---------------------------------------------------------------- augmentation

# (n, raw h, raw w, channels, crop, padding, flip first, jitter, expand one
# channel to three): the acceptance, ImageNet-30 and CIFAR-10 crop steps at
# small sizes, a one-channel stack, rows whose 16-byte vectors cross a row
# (8 x 8 x 3), and images too ragged for vectors (7 x 5 x 3); then whole
# 16-byte rows (144 B in uint8) with windows starting off a 16-byte boundary
# and a width of 37 (a ragged quad); a mirrored window reaching both paddings
# on every side; crop -> flip with padding at a width of 21; a band of rows
# per cluster block (130 rows for the contrast mean, 90 window rows for the
# guard alone); and 65,537 tiny images, more than gridDim.y could hold
AUG_CASES = [(6, 40, 40, 3, 32, 0, False, True, False), (6, 40, 40, 3, 32, 0, True, False, False),
             (6, 32, 32, 3, 32, 4, True, False, False), (5, 20, 20, 1, 16, 0, False, True, True),
             (4, 8, 8, 3, 5, 2, False, False, False), (4, 7, 5, 3, 4, 0, False, True, False),
             (4, 48, 48, 3, 37, 0, False, True, False), (4, 16, 16, 3, 22, 4, True, False, False),
             (3, 24, 30, 3, 21, 2, False, False, False), (2, 130, 96, 3, 64, 0, False, True, False),
             (3, 100, 100, 3, 90, 0, True, False, False), (65537, 4, 4, 3, 3, 1, True, False, False)]


def _aug_inputs(case, dtype, device, seed=0):
    from eoe_tpu_torch.ops import preprocess as P
    n, h, w, c, size, pad, flip_first, jitter, repeat = case
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, (n, h, w, c), generator=g, device=device, dtype=torch.uint8)
    x[0] = 254 + (torch.arange(w, device=device)[None, :, None] % 2).to(torch.uint8)
    x[1] = 200                     # constant: degenerate where the crop misses the padding
    x = x if dtype == torch.uint8 else x.float() / 255.0
    d = P.draw_random_crop(x, g, size=(size, size), padding=pad)
    flip = P.draw_random_hflip(x, g)["flip"]
    jit = (P.draw_color_jitter(x.float(), g, brightness=0.4, contrast=0.4, saturation=0.4,
                               hue=0.2) if jitter else None)
    cout = 3 if repeat else c
    kw = dict(size=(size, size), padding=pad, flip_first=flip_first, jitter=jit, repeat=repeat,
              noise=torch.randn(n, size, size, cout, generator=g, device=device),
              noise_std=0.05, norm=((0.5, 0.4, 0.3)[:cout], (0.2, 0.3, 0.25)[:cout]))
    return x, d["tops"], d["lefts"], flip, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", AUG_CASES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_augment_kernels_match_ref(cuda, case, dtype):
    """The stats kernel's flags exactly and its means to 1e-6; the apply
    kernel and the pair to 1e-5 of [0, 1], 1e-5/0.2 after the
    normalisation; each wrapper counts its launch."""
    from eoe_tpu_torch.ops import augment as Aug
    x, tops, lefts, flip, kw = _aug_inputs(case, dtype, cuda)
    jit = kw["jitter"]
    skw = dict(size=kw["size"], padding=kw["padding"], flip_first=kw["flip_first"], guard=True,
               contrast=jit is not None, brightness=jit["brightness"] if jit else None)
    before = (Aug.launches, Aug.stats_launches)
    mean, deg = Aug.crop_stats(x, tops, lefts, flip, **skw)
    mean_r, deg_r = Aug.crop_stats_ref(x, tops, lefts, flip, **skw)
    assert torch.equal(deg, deg_r) and (bool(deg[1]) or kw["padding"] > 0)
    if jit is not None:
        assert (mean - mean_r).abs().max().item() <= 1e-6
    out = Aug.crop_apply(x, tops, lefts, flip, mean_r, deg_r, **kw)
    ref = Aug.crop_apply_ref(x, tops, lefts, flip, mean_r, deg_r, **kw)
    assert out.dtype == torch.float32 and (out - ref).abs().max().item() <= 1e-5 / 0.2
    step = Aug.crop_augment(x, tops, lefts, flip, guard=True, **kw)
    step_ref = Aug.crop_augment_ref(x, tops, lefts, flip, guard=True, **kw)
    assert (step - step_ref).abs().max().item() <= 1e-5 / 0.2
    torch.cuda.synchronize()
    assert (Aug.launches, Aug.stats_launches) == (before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_augment_stats_is_deterministic(cuda, dtype):
    """The cluster's blocks combine in rank order, without atomics: two calls
    at the acceptance stack's shape give the same mean bits and flags."""
    from eoe_tpu_torch.ops import augment as Aug
    x, tops, lefts, flip, kw = _aug_inputs((8, 256, 256, 3, 224, 0, False, True, False),
                                           dtype, cuda)
    skw = dict(size=kw["size"], padding=0, flip_first=False, guard=True, contrast=True,
               brightness=kw["jitter"]["brightness"])
    assert Aug.stats_geometry(256, 224, True) == Aug.MAX_CLUSTER
    first = Aug.crop_stats(x, tops, lefts, flip, **skw)
    second = Aug.crop_stats(x, tops, lefts, flip, **skw)
    torch.cuda.synchronize()
    assert torch.equal(first[0].view(torch.int32), second[0].view(torch.int32))
    assert torch.equal(first[1], second[1])
    mean_r = Aug.crop_stats_ref(x, tops, lefts, flip, **skw)[0]
    assert (first[0] - mean_r).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_augment_kernels_reject(cuda):
    """What the kernels do not take raises; nothing falls back."""
    from eoe_tpu_torch.ops import augment as Aug
    x, tops, lefts, flip, kw = _aug_inputs(AUG_CASES[0], torch.uint8, cuda)
    with pytest.raises(ValueError, match="uint8 or float32"):
        Aug.crop_augment(x.half(), tops, lefts, flip, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        Aug.crop_augment(x.transpose(1, 2), tops, lefts, flip, **kw)
    with pytest.raises(ValueError, match="padding-0 crop -> flip"):
        Aug.crop_augment(x, tops, lefts, flip, **{**kw, "padding": 2})
    with pytest.raises(ValueError, match="noise must be"):
        Aug.crop_augment(x, tops, lefts, flip, **{**kw, "noise": kw["noise"][:, :4]})
    with pytest.raises(ValueError, match="tops must hold"):
        Aug.crop_augment(x, tops[:2], lefts, flip, **kw)
    with pytest.raises(ValueError, match="normalisation"):
        Aug.crop_augment(x, tops, lefts, flip, **{**kw, "norm": ((0.5,), (0.2,))})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_pipeline_on_the_card_is_the_cpus(cuda, dtype):
    """The acceptance stack compiled once, run on the card (the kernels) and
    on the CPU (the plain versions) with the card's draws."""
    from eoe_tpu_torch.ops import augment as Aug
    from eoe_tpu_torch.ops import preprocess as P
    specs = [{"op": "resize", "size": 40},
             {"op": "color_jitter", "brightness": 0.01, "contrast": 0.01, "saturation": 0.01,
              "hue": 0.01},
             {"op": "random_crop", "size": 32, "resample_degenerate": True},
             {"op": "random_hflip", "p": 0.5}, {"op": "clip_pil_preprocessing", "resolution": 32},
             {"op": "gaussian_noise", "std": 0.001}, {"op": "clip_tensor_preprocessing"}]
    x = _aug_inputs(AUG_CASES[0], dtype, cuda)[0]
    f = P.compile_pipeline(specs)
    draws = f.draw(x, generator=torch.Generator(device=cuda).manual_seed(1))
    before = Aug.launches
    card = f(x, draws=draws)
    assert Aug.launches == before + 1
    cpu = f(x.cpu(), draws=[{k: v.cpu() for k, v in d.items()} for d in draws])
    assert (card.cpu() - cpu).abs().max().item() <= 1e-5 / min(P.CLIP_STD)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 32), (16, 8, 6, 6)])
def test_all_reduce_batchnorm_matches_native(cuda, shape):
    """The data mesh's batch norm (``BatchNorm._global``: per-channel sums,
    sums of squares and counts through ``all_reduce_sum``) on a group of one
    rank on the card, against the one-process ``native_batch_norm`` path:
    output, running averages and gradients within 1e-5."""
    import torch.distributed as dist
    from eoe_tpu_torch.models.layers import BatchNorm
    from eoe_tpu_torch.parallel import mesh as meshlib

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(*shape, generator=g, device=cuda) * 3 + 1
    dy = torch.randn(*shape, generator=g, device=cuda)
    gamma = torch.rand(shape[1], generator=g, device=cuda) + 0.5
    beta = torch.rand(shape[1], generator=g, device=cuda) - 0.5
    outs = []
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{meshlib.free_port()}",
                                world_size=1, rank=0)
    try:
        mesh = meshlib.Mesh(dist.group.WORLD, "gloo", 0, 1, cuda)
        for on_mesh in (False, True):
            bn = BatchNorm(shape[1], eps=1e-5).to(cuda).train()
            with torch.no_grad():
                bn.weight.copy_(gamma)
                bn.bias.copy_(beta)
            xi = x.clone().requires_grad_()
            y = bn._global(xi, mesh) if on_mesh else bn(xi)
            (y * dy).sum().backward()
            outs.append([y.detach(), bn.running_mean, bn.running_var, xi.grad, bn.weight.grad,
                         bn.bias.grad])
    finally:
        if started:
            dist.destroy_process_group()
    for name, a, b in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"), *outs):
        torch.testing.assert_close(b, a, atol=1e-5 * max(a.abs().max().item(), 1), rtol=0,
                                   msg=name)


# ---------------------------------------------------------------- the resident epoch

CIFAR_STACK = [{"op": "color_jitter", "brightness": 0.01, "contrast": 0.01,
                "saturation": 0.01, "hue": 0.01},
               {"op": "random_hflip", "p": 0.5},
               {"op": "random_crop", "size": 32, "padding": 4},
               {"op": "gaussian_noise", "std": 0.001}, "normalize"]
RESIDENT_STATS = {"mean": [0.45, 0.5, 0.55], "std": [0.25, 0.3, 0.2], "mode": 0}


def _resident_ds(specs, n=64, n_test=16, side=32, seed=0):
    import numpy as np
    from eoe_tpu_torch.datasets import bases as B
    rng = np.random.default_rng(seed)
    x, xo, xt = (rng.integers(0, 256, (k, side, side, 3), dtype=np.uint8)
                 for k in (n, n, n_test))
    kw = dict(root="", train_specs=specs, test_specs=["normalize"], n_classes=2,
              raw_shape=(side, side, 3), ds_statistics=RESIDENT_STATS)
    normal = B.GenericADDataset(B.ArraySource(x, np.zeros(n)),
                                B.ArraySource(xt, np.arange(n_test) % 2),
                                normal_classes=(0,), nominal_label=0, **kw)
    oe = B.GenericADDataset(B.ArraySource(xo, np.ones(n)), None, normal_classes=(1,),
                            nominal_label=1, **kw)
    return B.CombinedDataset(normal, oe)


def _resident_trainer(model, specs, per_step, epochs=2, batch=16, dtype=torch.float32,
                      milestones=(1,)):
    from eoe_tpu_torch.training import TRAINER
    tr = TRAINER["hsc"](model=model, train_specs=specs, test_specs=["normalize"],
                        dataset="cifar10", oe_dataset="cifar100", datapath="", logger=None,
                        epochs=epochs, lr=1e-3, wdk=1e-3, milestones=list(milestones),
                        batch_size=batch, compute_dtype=dtype)
    tr._per_step = per_step
    tr.ds = _resident_ds(specs)
    return tr


def _counts():
    from eoe_tpu_torch.training import graphs
    return graphs.read_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_graph_epoch_equals_eager_cnn32_fp32(cuda, optimizer):
    """CNN32 fp32 (TF32 off) on the CIFAR-10 stack, 2 epochs of 4 steps with a
    milestone between them: the captured epochs against the eager loop,
    every step's loss and the parameters within 1e-5 (of max(1, |max|)), the
    train AUROC too; the crop kernel counts one launch a pipeline call both
    ways (replays add their capture's launches); the first chunk ran
    eagerly, a graph was captured for each learning rate (the milestone
    moves it) and replayed for the rest. cuDNN deterministic, so that both
    runs sum alike. With Adam the eager control is capturable too: the
    runner makes the graph's so, and its bias correction is then computed
    on the card in fp32 (a float's difference on a near-zero gradient
    becomes a +-lr update)."""
    import numpy as np
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.training import graphs
    from eoe_tpu_torch.training.optim import make_optimizer
    made = []
    real = graphs.ResidentSteps

    class Recorded(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    def optimizer_of(tr):
        def build(params, steps):
            opt = make_optimizer(optimizer, params, tr.lr, tr.wdk, tr.milestones, steps)
            if optimizer == "adam":
                opt.make_capturable()
            return opt
        return build

    graphs.ResidentSteps = Recorded
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for per_step in (True, False):
            tr = _resident_trainer(CNN32(), CIFAR_STACK, per_step)
            tr.make_optimizer = optimizer_of(tr)
            assert tr.resident_epoch(tr.ds) is not per_step
            before = _counts()
            state, roc = tr.train_cls(tr.ds, 0, "airplane", 0, seed=5)
            torch.cuda.synchronize()
            launched = [b - a for a, b in zip(before, _counts())]
            out[per_step] = (np.array(tr.step_losses), {k: v.float().cpu() for k, v in
                                                       state.model.state_dict().items()},
                             roc.auc, launched)
    finally:
        graphs.ResidentSteps = real
        torch.backends.cudnn.deterministic = deterministic
    (losses, params, auc, launched), (g_losses, g_params, g_auc, g_launched) = \
        out[True], out[False]
    assert len(losses) == 8
    np.testing.assert_allclose(g_losses, losses, rtol=1e-5, atol=1e-6)
    for k, v in params.items():
        err = ((g_params[k] - v).abs().max() / v.abs().max().clamp(min=1)).item()
        assert err <= 1e-5, (k, err)
    assert abs(g_auc - auc) <= 1e-5
    assert g_launched == launched and sum(launched) == 2 * 8   # the crop, both halves
    runner, = made
    c = runner.chunk
    assert runner.captures == (1 if c == 4 else 2) and runner.replays == (8 - c) // c


@pytest.mark.cuda
def test_graph_draws_are_the_eager_draws(cuda):
    """A registered generator draws in a replay what the eager steps would:
    step 2's noise differs from step 1's and equals the eager step 2's, and
    the generator's offset moves as the eager steps move it."""
    from eoe_tpu_torch.training import graphs
    g_eager = torch.Generator(device=cuda).manual_seed(7)
    eager = [torch.randn(5, generator=g_eager, device=cuda) for _ in range(3)]
    g = torch.Generator(device=cuda).manual_seed(7)
    out = torch.zeros(3, 5, device=cuda)
    cursor = torch.zeros(1, dtype=torch.int64, device=cuda)

    def step():
        out.index_copy_(0, cursor, torch.randn(1, 5, generator=g, device=cuda))
        cursor.add_(1)

    runner = graphs.ResidentSteps(step, cuda, 1, [g])
    runner.run(3)   # one eager step, a capture, two replays
    torch.cuda.synchronize()
    assert runner.captures == 1 and runner.replays == 2
    assert not torch.equal(out[1], out[0]) and not torch.equal(out[2], out[1])
    for k in range(3):
        assert torch.equal(out[k], eager[k]), k
    assert torch.equal(torch.randn(5, generator=g, device=cuda),
                       torch.randn(5, generator=g_eager, device=cuda))
    runner.close()


@pytest.mark.cuda
def test_graph_counters_add_captured_launches_per_replay(cuda):
    """The kernels' counters count at capture and not at replay: the helper
    takes the capture's increments back and adds them at each replay, so a
    runner of 1 eager + 4 replayed steps of 2 fused launches each counts 10,
    as many as the card's trace of the run shows."""
    from eoe_tpu_torch.training import graphs
    qkv = torch.randn(2, 50, 3 * 2 * 64, device=cuda)

    def step():
        A.fused_qkv_attention(qkv, 2, False)
        A.fused_qkv_attention(qkv, 2, False)

    before = A.fused_qkv_attention.launches
    runner = graphs.ResidentSteps(step, cuda, 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        runner.run(5)
        torch.cuda.synchronize()
    assert A.fused_qkv_attention.launches - before == 10
    assert runner.replays == 4
    traced = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and "fused_qkv_fwd_kernel" in e.name]
    assert len(traced) == 10, traced
    runner.close()


@pytest.mark.cuda
def test_graph_tiny_clip_bf16(cuda, monkeypatch):
    """A tiny CLIP image tower in bf16 through the fused kernels: 3 steps of
    the resident runner (one eager, a capture, two replays) against 3 eager
    steps from the same weights: each loss within 2^-8, the last step's
    gradients within 2^-4 of their max, and one forward and one backward
    launch a layer and step both ways."""
    import numpy as np
    from eoe_tpu_torch.models.clip import CLIP, ClipConfig
    from eoe_tpu_torch.training import graphs
    cfg = ClipConfig(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
                     vision_patch_size=8, context_length=77, vocab_size=49408,
                     transformer_width=128, transformer_heads=2, transformer_layers=2,
                     vision_heads_override=2)
    specs = [{"op": "random_hflip"}, {"op": "gaussian_noise", "std": 0.05}, "normalize"]
    res = {}
    for captured in (False, True):
        tr = _resident_trainer(CLIP(cfg, generator=torch.Generator().manual_seed(0)), specs,
                               per_step=not captured, epochs=1, dtype=torch.bfloat16,
                               milestones=())
        ds = tr.ds
        state = tr.init_state(1, ds, 3)
        steps = 3
        sampler_plans = [graphs.pack_plan(np.arange(16) + 16 * s % 48,
                                          np.arange(16) + 16 * s % 48,
                                          np.ones(16)) for s in range(steps)]
        Xn = tr._to_device(ds.train_set.gather_all())
        Ln = torch.zeros(len(Xn), dtype=torch.int64, device=cuda)
        Xo = tr._to_device(ds.oe.train_set.gather_all())
        Lo = torch.ones(len(Xo), dtype=torch.int64, device=cuda)
        gen = torch.Generator(device=cuda).manual_seed(3)
        before = (A.fused_qkv_attention.launches, A.fused_qkv_attention.bwd_launches)
        if captured:
            plans = graphs.DevicePlans([p[:, None] for p in sampler_plans], 1, cuda)
            monkeypatch.setenv("EOE_TPU_CHUNK", "1")
            runner, out = tr.make_train_epoch_resident(state, ds, (Xn, Ln, Xo, Lo), plans,
                                                       steps, gen, None, tr._rt_stats(ds))
            assert runner.chunk == 1
            runner.run(steps)
            torch.cuda.synchronize()
            losses = out[:, 0].cpu().numpy()
        else:
            losses = []
            for p in sampler_plans:
                p = torch.from_numpy(p.astype(np.int64)).to(cuda)
                losses.append(tr.train_step(state, ds, Xn[p[0]], Ln[p[0]], Xo[p[1]], Lo[p[1]],
                                            p[2].float(), gen, None, tr._rt_stats(ds))[0].item())
        grads = {n: p.grad.float().clone() for n, p in state.model.named_parameters()
                 if p.grad is not None}
        launched = (A.fused_qkv_attention.launches - before[0],
                    A.fused_qkv_attention.bwd_launches - before[1])
        res[captured] = (np.asarray(losses), grads, launched)
        if captured:
            runner.close()
    (losses, grads, launched), (g_losses, g_grads, g_launched) = res[False], res[True]
    np.testing.assert_allclose(g_losses, losses, atol=2 ** -8, rtol=0)
    assert grads.keys() == g_grads.keys() and grads
    for n, v in grads.items():
        assert (g_grads[n] - v).abs().max().item() <= 2 ** -4 * max(v.abs().max().item(), 1e-12)
    assert g_launched == launched == (3 * 2, 3 * 2)


@pytest.mark.cuda
def test_graph_frozen_model_updates_only_batch_statistics(cuda):
    """Nothing trainable (``loss.requires_grad`` False, an empty optimizer):
    the graph moves the batch-norm averages as the eager steps do and
    leaves every parameter as it was."""
    import numpy as np
    from eoe_tpu_torch.models import CNN32
    out = {}
    for per_step in (True, False):
        tr = _resident_trainer(CNN32(), ["normalize"], per_step)
        tr.trainable_param_keys = lambda: frozenset()
        tr.init_weights(5)
        init = {k: v.clone() for k, v in tr.model.named_parameters()}
        state, _ = tr.train_cls(tr.ds, 0, "airplane", 0, seed=5)
        out[per_step] = ({k: v.float().cpu() for k, v in state.model.state_dict().items()},
                         np.array(tr.step_losses))
        for k, v in state.model.named_parameters():
            assert torch.equal(v.cpu(), init[k].cpu()), k
    (eager, e_losses), (graph, g_losses) = out[True], out[False]
    np.testing.assert_allclose(g_losses, e_losses, rtol=1e-5)
    for k, v in eager.items():
        torch.testing.assert_close(graph[k], v, rtol=1e-5, atol=1e-6, msg=k)


@pytest.mark.cuda
def test_graph_memory_is_freed_after_train_cls(cuda):
    """After ``train_cls`` returns, its graph and the graph's private pool
    are gone: from one class-seed to the next, the memory allocated is back
    at its level before the run, within one step's outputs and the trained
    state that the run returns (Adam's moments and step counts); no
    gradient is left."""
    from eoe_tpu_torch.models import CNN32
    tr = _resident_trainer(CNN32(), CIFAR_STACK, False)
    state, _ = tr.train_cls(tr.ds, 0, "airplane", 0, seed=5)   # first calls' caches
    del state
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state, _ = tr.train_cls(tr.ds, 0, "airplane", 1, seed=6)
    torch.cuda.synchronize()
    moments = sum(t.numel() * t.element_size() for st in state.optimizer.optimizer.state.values()
                  for t in st.values() if torch.is_tensor(t))
    step_outputs = 16 * 1024 * 4   # a step's loss, scores, labels and weights, generously
    assert torch.cuda.memory_allocated() - base <= moments + step_outputs
    assert all(p.grad is None for p in state.model.parameters())


@pytest.mark.cuda
def test_out_of_memory_in_a_capture_ends_it(cuda):
    """An out-of-memory error raised inside a capture reaches the caller as
    one, after the capture was ended: the card then captures and replays a
    new graph, and the memory is back at its level before."""
    from eoe_tpu_torch.training import graphs
    x = torch.ones(1024, device=cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()

    def step():
        if torch.cuda.is_current_stream_capturing():
            torch.empty(1 << 46, dtype=torch.uint8, device=cuda)
        x.mul_(2)

    runner = graphs.ResidentSteps(step, cuda, 1)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        runner.run(2)
    runner.close()
    assert not torch.cuda.is_current_stream_capturing()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base

    def ok():
        x.mul_(2)

    fine = graphs.ResidentSteps(ok, cuda, 1)
    fine.run(3)
    torch.cuda.synchronize()
    assert fine.replays == 2 and x[0].item() == 2 ** 4
    fine.close()


# ---------------------------------------------------------------- long attention

# ViT-L/14's image tower (s = 257), its 336-px sequence, and the longest
# sequence at d = 128
LONG_CASES = [(8, 257, 16, 64), (4, 577, 16, 64), (2, 1024, 8, 128)]


def _long_inputs(case, cuda, seed=3):
    n, s, h, d = case
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(n, s, 3 * h * d, generator=g, device=cuda).bfloat16()
    dout = torch.randn(n, s, h * d, generator=g, device=cuda).bfloat16()
    return qkv, dout


@pytest.mark.cuda
@pytest.mark.parametrize("case", LONG_CASES)
def test_long_attention_kernels_match_ref(cuda, case):
    """The forward against its plain version (output to one bf16 rounding,
    2e-2 as the fused kernels'; the rows' max to fp32 rounding of a sum
    order, their sum of exp to 1e-5 relative), the backward from the
    kernel's own output and statistics against its plain version from the
    same (``_bwd_tol``), and both through autograd against
    ``default_attention``'s gradient."""
    n, s, h, d = case
    qkv, dout = _long_inputs(case, cuda)
    before = (A.long_qkv_attention.launches, A.long_qkv_attention.bwd_launches)
    out, stats = A._long_fwd_kernel(qkv, h)
    dqkv = A._long_bwd_kernel(qkv, out, stats, dout, h)
    torch.cuda.synchronize()
    assert (A.long_qkv_attention.launches, A.long_qkv_attention.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    ref, ref_stats = A.long_qkv_attention_fwd_ref(qkv, h)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert torch.allclose(stats[..., 0], ref_stats[..., 0], rtol=0, atol=1e-4)
    assert torch.allclose(stats[..., 1], ref_stats[..., 1], rtol=1e-5, atol=0)
    dref = A.long_qkv_attention_bwd_ref(qkv, out, stats, dout, h)
    assert dqkv.shape == dref.shape and dqkv.dtype == torch.bfloat16
    assert (dqkv.float() - dref.float()).abs().max().item() <= _bwd_tol(torch.bfloat16, dref)
    x = qkv.clone().requires_grad_(True)
    A.long_qkv_attention(x, h).backward(dout)
    y = qkv.clone().requires_grad_(True)
    q, k, v = (t.reshape(n, s, h, d).transpose(1, 2) for t in y.chunk(3, dim=-1))
    A.default_attention(q, k, v, None).transpose(1, 2).reshape(n, s, h * d).backward(dout)
    assert (x.grad.float() - y.grad.float()).abs().max().item() <= _bwd_tol(torch.bfloat16,
                                                                           y.grad)


@pytest.mark.cuda
def test_long_attention_rejects(cuda):
    """The route refuses a mask, fp32 and sequences outside 128 < s <= 1024;
    the Function refuses fp32 on the card and the lengths outside it."""
    qkv = torch.zeros(2, 257, 3 * 128, device=cuda, dtype=torch.bfloat16)
    assert A.long_qkv_ok(2, 257, 2, 64, qkv)
    assert not A.long_qkv_ok(2, 257, 2, 64, qkv, masked=True)
    assert not A.long_qkv_ok(2, 257, 2, 64, qkv.float())
    assert not A.long_qkv_ok(2, 128, 2, 64, qkv[:, :128])
    assert not A.long_qkv_ok(2, 1025, 2, 64, qkv)
    with pytest.raises(ValueError, match="bfloat16 on the card"):
        A.long_qkv_attention(qkv.float(), 2)
    for s in (128, 1025):
        with pytest.raises(ValueError, match="128 < s <= 1024"):
            A.long_qkv_attention(torch.zeros(1, s, 3 * 128, device=cuda, dtype=torch.bfloat16),
                                 2)


@pytest.mark.cuda
def test_long_attention_backward_is_deterministic(cuda):
    """No atomics: two backward runs give the same bits."""
    qkv, dout = _long_inputs(LONG_CASES[0], cuda, seed=4)
    out, stats = A._long_fwd_kernel(qkv, 16)
    a = A._long_bwd_kernel(qkv, out, stats, dout, 16)
    b = A._long_bwd_kernel(qkv, out, stats, dout, 16)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_long_attention_under_a_cuda_graph(cuda):
    """The pair, forward and backward, captured in a CUDA graph and replayed
    on new inputs gives what the eager calls give."""
    case = (4, 257, 16, 64)
    qkv, dout = _long_inputs(case, cuda, seed=5)
    x = qkv.clone().requires_grad_(True)
    g_in = dout.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up outside the capture
        A.long_qkv_attention(x, 16).backward(g_in)
    torch.cuda.current_stream().wait_stream(side)
    x.grad = None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.long_qkv_attention(x, 16)
        out.backward(g_in)
    new_qkv, new_dout = _long_inputs(case, cuda, seed=6)
    with torch.no_grad():
        x.copy_(new_qkv)
    g_in.copy_(new_dout)
    graph.replay()
    torch.cuda.synchronize()
    y = new_qkv.clone().requires_grad_(True)
    want = A.long_qkv_attention(y, 16)
    want.backward(new_dout)
    assert torch.equal(out, want) and torch.equal(x.grad, y.grad)
