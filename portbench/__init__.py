"""The benchmark of eoe_tpu_torch on NVIDIA H100 cards (``run.py``)."""
