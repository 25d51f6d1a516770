"""Bytes a WideResNet+CBAM training step must move through CBAM's gates and
each BasicBlock's tail (the residual add and the ReLU), whatever computes
them. Per block, the forward reads o (the bn2 output) and the residual and
writes the block's output y; the backward reads y's gradient and o and
writes the gradients of o and of the residual: 7 tensors of the block's
output shape, each byte counted once. The gates' small maps (a channel
vector and a pixel map an image) are left out. The blocks' shapes follow
``counts/model_flops.wrn_forward_layers``: the stem's conv 7x7 stride 2 and
max pool 3x3 stride 2, then each stage's first block at its stride."""

ELEM_BYTES = {"bfloat16": 2, "float32": 4}
TENSORS = 7   # forward: o, residual, y; backward: dy, o, do, d(residual)


def block_shapes(cfg: dict, res: int) -> list:
    """(channels, side) of each BasicBlock's output, for an image of side ``res``."""
    hw = (res + 2 * 3 - 7) // 2 + 1
    hw = (hw + 2 - 3) // 2 + 1
    out = []
    for stage, (planes, n) in enumerate(zip(cfg["stage_widths"], cfg["blocks_per_stage"]),
                                        start=1):
        for b in range(n):
            stride = (1 if stage == 1 else 2) if b == 0 else 1
            hw = (hw - 1) // stride + 1
            out.append((planes, hw))
    return out


def chain_bytes(cfg: dict, rows: int, dtype: str) -> int:
    """The compulsory bytes of one training step of ``rows`` images."""
    return TENSORS * rows * ELEM_BYTES[dtype] * sum(
        c * hw * hw for c, hw in block_shapes(cfg, cfg["crop_size"]))
