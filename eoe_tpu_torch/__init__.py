"""eoe_tpu_torch: the PyTorch and CUDA port of eoe_tpu, for an NVIDIA H100.

It grows slice by slice beside ``eoe_tpu``, which stays the unchanged JAX
reference. This package imports ``torch`` and never ``jax`` or ``eoe_tpu``.
The first slice is CLIP ViT-B/32 anomaly scoring (``inference.AnomalyScorer``)
with the fused-QKV attention forward as a hand-written CUDA kernel
(``ops.attention``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from eoe_tpu_torch.device import resolve_device  # noqa: F401
