"""The yardstick's counts against hand counts at small shapes, the
attention counts against ``chip_smoke.py``'s, and the interval union."""

import importlib.util
import math
from pathlib import Path

import pytest

from portbench.counts import attention, augment, intervals, model_flops, peaks
from portbench.counts.kernel_class import kernel_class
from portbench.harness.common import BENCH_DIR, load_json


def _chip_smoke():
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_counts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_attention_by_hand():
    # n=1, s=2, H=1, d=4, bf16: read 3 * 4, write 4 values of 2 bytes a row
    assert attention.attention_bytes(1, 2, 1, 4, "bfloat16", False) == 2 * (3 * 4 + 4) * 2
    assert attention.attention_ops(1, 2, 1, 4, False, False) == 2 * (2 * 2 * 2 * 4)
    assert attention.attention_ops(1, 2, 1, 4, True, False) == 2 * 2 * 3 * 4
    assert attention.attention_bytes(1, 2, 1, 4, "float32", True) == 2 * 7 * 4 * 4
    assert attention.attention_ops(1, 2, 1, 4, False, True) == 5 * (2 * 2 * 2 * 4)


@pytest.mark.parametrize("shape", [(256, 50, 12, 64, False), (64, 77, 8, 64, True),
                                   (128, 50, 12, 64, False)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("backward", [False, True])
def test_attention_equals_chip_smoke(shape, dtype, backward):
    n, s, h, d, causal = shape
    ms, _ = _chip_smoke().attention_bound_ms(n, s, h, d, causal, f"torch.{dtype}", backward)
    ours = peaks.bound_s(attention.attention_bytes(n, s, h, d, dtype, backward),
                         attention.attention_ops(n, s, h, d, causal, backward), dtype) * 1e3
    assert ours == pytest.approx(ms, rel=1e-12)


def test_augment_by_hand():
    # 2 images, raw 4, crop 2, 3 channels: contrast reads the whole raw image
    assert augment.pair_bytes(2, 4, 2, 3, 1, 4, True, True) == 2 * (16 * 3 + 2 * 4 * 3 * 4)
    assert augment.pair_bytes(2, 4, 2, 3, 1, 4, False, False) == 2 * (4 * 3 + 4 * 3 * 4)
    specs = load_json(BENCH_DIR / "configs" / "clip_vitb32.json")["train"]["specs"]
    assert augment.stack_shape(specs) == (224, True, True)
    specs = load_json(BENCH_DIR / "configs" / "wrn_cbam.json")["train"]["specs"]
    assert augment.stack_shape(specs) == (224, False, False)


def test_vit_flops_by_hand():
    cfg = {"vision_patch_size": 2, "vision_width": 4, "image_resolution": 4, "vision_layers": 1,
           "embed_dim": 3}
    s, w = 5, 4                       # 4 patches and the class token
    embed = 2 * 4 * (2 * 2 * 3) * w
    layer = 2 * s * w * 3 * w + 2 * s * w * w + 2 * (2 * s * w * 4 * w) + 2 * (2 * s * s * w)
    assert model_flops.vit_image_forward(cfg) == embed + layer + 2 * w * 3
    assert model_flops.vit_image_train(cfg) == 3 * (embed + layer + 2 * w * 3) - embed


def test_published_sizes():
    vit = load_json(BENCH_DIR / "configs" / "clip_vitb32.json")
    assert 8.7e9 < model_flops.vit_image_forward(vit) < 8.9e9
    wrn = load_json(BENCH_DIR / "configs" / "wrn_cbam.json")
    assert 3.5e9 < model_flops.wrn_forward(wrn) < 3.8e9   # ResNet-18 at 224: 1.82 GMACs


def test_wrn_flops_by_hand():
    cfg = {"stem_width": 2, "stage_widths": [2, 4], "blocks_per_stage": [1, 1],
           "cbam_reduction": 2, "rep_dim": 3, "crop_size": 8}
    layers = dict(model_flops.wrn_forward_layers(cfg, 8))
    assert layers["stem"] == 2 * 3 * 2 * 49 * 4 * 4          # 8 -> 4
    # 4 -> pool 2; stage 1 at 2 x 2, no projection; stage 2 at 1 x 1 with one
    assert layers["layer1_block0"] == 2 * (2 * 2 * 2 * 9 * 4) + 2 * 2 * (2 * 1 * 2) + 2 * 2 * 49 * 4
    assert layers["layer2_block0"] == (2 * 2 * 4 * 9 + 2 * 4 * 4 * 9 + 2 * 2 * 4
                                       + 2 * 2 * (4 * 2 * 2) + 2 * 2 * 49)
    assert layers["fc"] == 2 * 4 * 3


def test_union_and_gaps():
    assert intervals.union_seconds([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-6)
    assert intervals.gaps([(0, 10), (5, 20), (30, 40)], 0, 50) == [(20, 30), (40, 50)]
    assert math.isclose(intervals.union_seconds([]), 0.0)


def test_kernel_classes():
    assert kernel_class("void (anonymous namespace)::fused_qkv_bwd_kernel_tc<64>") \
        == "attention backward (port kernel)"
    assert kernel_class("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "collectives (NCCL)"
    assert kernel_class("nvjet_tst_128x160_64x5_2x4_h_bz_NNT") == "matrix products (cuBLAS)"
