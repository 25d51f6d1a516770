"""The arithmetic of the plain reference and of its controls.

Every product of the reference (dense layers, the patch embedding,
convolutions) goes through one ``Precision``:

* ``fp32``: float32 with TF32 off for cuBLAS and cuDNN (the reference);
* ``tf32``: the same calls with TF32 on (the control of a float32 model
  whose products run with TF32 off);
* ``bf16``: operands rounded to bfloat16, products accumulated in float32
  (the control of a float32 model that lets cuDNN take TF32);
* ``fp8``: operands scaled per tensor and rounded to float8 e4m3 in the
  forward pass and, for the gradients, e5m2 (the control of a bfloat16
  model): an FP8 GEMM's inputs, with its float32 accumulation.

Everything else (norms, softmax, the losses) stays float32. ``flags`` sets
the TF32 switches the precision needs for the block it wraps and restores
them after.
"""

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round_fp8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` scaled so that its largest magnitude is ``top``, rounded to
    ``dtype`` and scaled back, in float32."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / top
    return (t.float() / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa = _round_fp8(a, torch.float8_e4m3fn, E4M3_MAX)
        qb = _round_fp8(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round_fp8(g, torch.float8_e5m2, E5M2_MAX)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        # a batched ``a`` against a shared ``b``: sum the batch into b's gradient
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


class Precision:
    def __init__(self, name: str = "fp32"):
        assert name in ("fp32", "tf32", "bf16", "fp8"), name
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` (``b`` a 2-d weight), result in float32."""
        if self.name == "bf16":
            return (a.bfloat16() @ b.bfloat16()).float()
        if self.name == "fp8":
            return _Fp8Matmul.apply(a.float(), b.float())
        return a.float() @ b.float()

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        """A dense layer with a torch-layout weight ``(out, in)``."""
        y = self.mm(x, w.t())
        return y if b is None else y + b.float()

    def conv(self, x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
        if self.name == "bf16":
            return F.conv2d(x.bfloat16(), w.bfloat16(), None, stride, padding).float()
        if self.name == "fp8":
            x = x + (_round_fp8(x, torch.float8_e4m3fn, E4M3_MAX) - x).detach()
            w = w + (_round_fp8(w, torch.float8_e4m3fn, E4M3_MAX) - w).detach()
        return F.conv2d(x.float(), w.float(), None, stride, padding)

    @contextlib.contextmanager
    def flags(self):
        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn
