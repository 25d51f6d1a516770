"""eoe_tpu_torch: the PyTorch and CUDA port of eoe_tpu, for an NVIDIA H100.

It grows slice by slice beside ``eoe_tpu``, which stays the unchanged JAX
reference. This package imports ``torch`` and never ``jax`` or ``eoe_tpu``.
The first slice is CLIP ViT-B/32 anomaly scoring (``inference.AnomalyScorer``),
the second HSC and CLIP fine-tuning (``training.Trainer``,
``training.clip.ClipTrainer``); the fused-QKV attention forward and backward
are hand-written CUDA kernels (``ops.attention``). The command-line runners
are ``eoe_tpu_torch.main`` (``python -m eoe_tpu_torch.main.train_cifar``);
the evolutionary OE search is ``evolve`` (``main.evolve_oe_cifar`` and its
siblings), and plug-in models subclass ``models.custom_base.CustomNet``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from eoe_tpu_torch.device import resolve_device  # noqa: F401
