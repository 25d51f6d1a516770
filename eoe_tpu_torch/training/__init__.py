"""Training-side helpers of the port (the CLIP prompt centre so far)."""
