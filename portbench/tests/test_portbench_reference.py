"""The plain reference agrees with the port at tiny widths on the CPU: the
CLIP towers, the prompt loss and score, the WideResNet + CBAM forward in
training mode, the two training stacks (degenerate crops included) and the
optimizers' updates. (The test imports both; the reference imports none of
the program.)"""

import numpy as np
import pytest
import torch

from portbench.families import clip_vit as clip_family
from portbench.harness import weights
from portbench.reference import augment, clip_vit, wrn_cbam
from portbench.reference.precision import Precision
from portbench.reference.train import Optimizer
from portbench.tests import tiny

P = Precision("fp32")


def test_clip_towers_loss_and_score():
    from eoe_tpu_torch.models.clip import CLIP
    from eoe_tpu_torch.ops.losses import clip_loss, clip_score
    cfg = tiny.configs()["tiny_clip"]
    w = weights.make(clip_vit.param_specs(cfg), 3, "cpu")
    model = CLIP(clip_family.program_config(cfg))
    model.load_state_dict(w)
    x = torch.randn(6, 32, 32, 3)
    tokens = clip_family.prompt_tokens(cfg, "imagenet", 4, "cpu")
    with torch.no_grad():
        fi, ri = model(x), clip_vit.encode_image(w, x, cfg, P)
        ft, rt = model.encode_text(tokens), clip_vit.encode_text(w, tokens, cfg, P)
    assert torch.allclose(fi, ri, atol=1e-5, rtol=1e-5)
    assert torch.allclose(ft, rt, atol=1e-5, rtol=1e-5)
    c = clip_vit.prompt_centre(w, tokens, cfg, P)
    labels, wt = torch.tensor([0, 1, 0, 1, 1, 0]), torch.tensor([1., 1, 1, 0, 1, 1])
    assert clip_loss(ri, labels, c, weights=wt).item() == pytest.approx(
        clip_vit.masked_mean(clip_vit.loss_terms(ri, labels, c), wt).item(), rel=1e-6)
    assert torch.allclose(clip_score(ri, c), clip_vit.score(ri, c), atol=1e-6)


def test_wrn_forward_in_training():
    from eoe_tpu_torch.models import WideResNet
    from eoe_tpu_torch.ops.losses import hsc_loss
    cfg = tiny.configs()["tiny_wrn"]
    w = weights.make(wrn_cbam.param_specs(cfg), 4, "cpu")
    model = WideResNet(rep_dim=cfg["rep_dim"])
    model.load_state_dict(w)
    model.train()
    x = torch.rand(6, 32, 32, 3)
    with torch.no_grad():
        got, ref = model(x), wrn_cbam.forward(w, x, cfg, P)
    assert torch.allclose(got, ref, atol=1e-4, rtol=1e-4)
    labels, wt = torch.tensor([0, 1, 0, 1, 1, 0]), torch.ones(6)
    assert hsc_loss(ref, labels, weights=wt).item() == pytest.approx(
        clip_vit.masked_mean(wrn_cbam.loss_terms(ref, labels), wt).item(), rel=1e-6)


@pytest.mark.parametrize("stack", ["clip", "wrn"])
@pytest.mark.parametrize("guard", [False, True])
def test_training_stacks(stack, guard):
    from eoe_tpu_torch.ops.preprocess import DatasetStats, compile_pipeline
    specs = (tiny.CLIP_TRAIN_SPECS if stack == "clip" else tiny.WRN_TRAIN_SPECS)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (6, 40, 40, 3),
                                                          dtype=np.uint8))
    x[1] = 17          # a constant image: its crop is degenerate
    x[2, :, :20] = 200  # half constant: some crops are
    stats = augment.channel_stats(x)
    fn = compile_pipeline(specs, DatasetStats(stats[0], stats[1], 0), guard)
    draws = fn.draw(x, None, generator=torch.Generator().manual_seed(5))
    got = fn(x, None, draws=draws)
    ref = augment.apply(x, specs, draws, guard, stats)
    assert torch.allclose(got, ref, atol=2e-5), (got - ref).abs().max()


def test_channel_stats():
    from eoe_tpu_torch.ops.metrics import channel_stats
    x = np.random.default_rng(1).integers(0, 256, (5, 8, 8, 3), dtype=np.uint8)
    mean, std = channel_stats(x)
    rmean, rstd = augment.channel_stats(torch.from_numpy(x))
    assert np.allclose(mean, rmean, atol=1e-7) and np.allclose(std, rstd, atol=1e-7)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_optimizers(kind):
    from eoe_tpu_torch.training.optim import make_optimizer
    torch.manual_seed(0)
    p = torch.nn.Parameter(torch.randn(5, 4))
    ref = {"p": p.detach().clone()}
    opt = make_optimizer(kind, [p], 0.1, 0.01, [], 1)
    mine = Optimizer(kind, 0.1, 0.01)
    for _ in range(3):
        g = torch.randn(5, 4)
        p.grad = g.clone()
        opt.step()
        mine.step(ref, {"p": g})
    assert torch.allclose(p.detach(), ref["p"], atol=1e-6)


def test_fp8_control_rounds_its_products():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    exact = a @ b
    for name, lo in (("bf16", 1e-4), ("fp8", 1e-2)):
        got = Precision(name).mm(a, b)
        rel = float((got - exact).norm() / exact.norm())
        assert lo < rel < 0.2, (name, rel)
