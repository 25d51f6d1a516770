"""Model FLOPs an image needs, counted from the published shapes: the
products (dense layers, convolutions, attention's two products), 2
operations a multiply-add; norms, activations and the loss are left out.
Training is forward plus backward without recomputation: the backward
takes two products for each forward one (input and weight gradient),
less the input gradient of the first layer, whose input (the images) needs
none."""


def vit_image_forward(cfg: dict) -> int:
    """One image through a CLIP ViT image tower."""
    p, w, res = cfg["vision_patch_size"], cfg["vision_width"], cfg["image_resolution"]
    patches = (res // p) ** 2
    s = patches + 1
    embed = 2 * patches * (p * p * 3) * w
    layer = 2 * s * w * 3 * w + 2 * s * w * w + 2 * 2 * s * w * 4 * w + 2 * 2 * s * s * w
    return embed + cfg["vision_layers"] * layer + 2 * w * cfg["embed_dim"]


def vit_image_train(cfg: dict) -> int:
    p, w, res = cfg["vision_patch_size"], cfg["vision_width"], cfg["image_resolution"]
    embed = 2 * (res // p) ** 2 * (p * p * 3) * w
    return 3 * vit_image_forward(cfg) - embed


def _conv(cin: int, cout: int, k: int, out_hw: int) -> int:
    return 2 * cin * cout * k * k * out_hw * out_hw


def wrn_forward_layers(cfg: dict, res: int) -> list:
    """The products of one image of side ``res``: (name, FLOPs)."""
    out = []
    hw = (res + 2 * 3 - 7) // 2 + 1                # conv 7x7 stride 2 padding 3
    out.append(("stem", _conv(3, cfg["stem_width"], 7, hw)))
    hw = (hw + 2 - 3) // 2 + 1                     # max pool 3x3 stride 2 padding 1
    cin, r = cfg["stem_width"], cfg["cbam_reduction"]
    for stage, (planes, n) in enumerate(zip(cfg["stage_widths"], cfg["blocks_per_stage"]),
                                        start=1):
        for b in range(n):
            stride = (1 if stage == 1 else 2) if b == 0 else 1
            hw_out = (hw - 1) // stride + 1
            f = _conv(cin, planes, 3, hw_out) + _conv(planes, planes, 3, hw_out)
            if b == 0 and (stride != 1 or cin != planes):
                f += _conv(cin, planes, 1, hw_out)
            f += 2 * 2 * (planes * (planes // r) * 2)   # the shared MLP on two pooled vectors
            f += _conv(2, 1, 7, hw_out)                 # the spatial gate
            out.append((f"layer{stage}_block{b}", f))
            cin, hw = planes, hw_out
    out.append(("fc", 2 * cin * cfg["rep_dim"]))
    return out


def wrn_forward(cfg: dict) -> int:
    return sum(f for _, f in wrn_forward_layers(cfg, cfg["crop_size"]))


def wrn_train(cfg: dict) -> int:
    stem = wrn_forward_layers(cfg, cfg["crop_size"])[0][1]
    return 3 * wrn_forward(cfg) - stem


FORWARD = {"clip_vit": vit_image_forward, "wrn_cbam": wrn_forward}
TRAIN = {"clip_vit": vit_image_train, "wrn_cbam": wrn_train}
