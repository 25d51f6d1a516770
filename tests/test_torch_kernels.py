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
# of shared memory)
CASES = [(4, 50, 12, 64, False), (4, 77, 8, 64, True), (3, 21, 4, 64, True),
         (2, 10, 2, 128, True), (2, 128, 2, 128, False)]


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
    with pytest.raises(NotImplementedError):
        A.fused_qkv_attention(qkv.requires_grad_(), 2, False)


@pytest.mark.cuda
def test_fp16_attention_on_card_raises(cuda):
    """A dtype the kernel does not take raises on the card; the model does not
    switch to the plain version for it."""
    mha = MultiHeadAttention(128, 2, torch.float16).to(cuda)
    x = torch.zeros(2, 10, 128, device=cuda, dtype=torch.float16)
    with torch.inference_mode(), pytest.raises(ValueError, match="float32 or bfloat16"):
        mha(x)
