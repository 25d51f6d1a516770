"""CBAM's gates and a BasicBlock's tail through ``ops.cbam``: the fused
autograd Functions against the plain composition, and on a card the
kernels against their plain versions.

On the CPU the Functions run the kernels' plain versions (``ops.cbam.REF``)
and are held, forward and every gradient, to autograd of
``relu(cbam(x) + residual)``. The tests marked ``cuda`` need an NVIDIA GPU
and nvcc and skip elsewhere; the file imports neither jax nor eoe_tpu, so on
the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cbam.py -m cuda
"""

import copy
import functools

import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call, grad, vmap

from eoe_tpu_torch.models import WideResNet
from eoe_tpu_torch.models.cbam import CBAM
from eoe_tpu_torch.models.layers import collect_averages
from eoe_tpu_torch.models.resnet import BasicBlock
from eoe_tpu_torch.ops import cbam as C

RTOL = 1e-5   # fp32: the plain versions differ from autograd's only in summation order

# (n, c, h, w): each WideResNet stage's width at a small side, a ragged
# side, a width whose pieces do not fill 32 lanes, and a one-pixel map
SHAPES = [(3, 64, 8, 8), (2, 128, 5, 7), (2, 256, 4, 4), (2, 512, 2, 3), (3, 24, 6, 5),
          (4, 32, 1, 1)]


def _channels_last(*shape, generator, scale=1.0):
    n, c, h, w = shape
    return (torch.randn(n, h, w, c, generator=generator) * scale).permute(0, 3, 1, 2)


def _module(c: int, seed: int = 0) -> CBAM:
    """A CBAM in train mode with every weight drawn (the spatial BN's scale
    starts at 0, which would stop sg's gradient)."""
    m = CBAM(c, min(16, c // 2)).train()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        m.spatial_gate.spatial_bn.weight.fill_(0.8)
    return m


def _plain_and_fused(m: CBAM, x, r, gy):
    """Outputs, input/residual/parameter gradients and the spatial BN's new
    averages of the plain composition and of the fused path, from two copies
    of ``m``."""
    out = []
    for fused in (False, True):
        mod = copy.deepcopy(m)
        xi, ri = x.clone().requires_grad_(), r.clone().requires_grad_()
        y = mod.fused_gate_tail(xi, ri) if fused else F.relu(mod(xi) + ri)
        grads = torch.autograd.grad(y, [xi, ri, *mod.parameters()], gy)
        bn = mod.spatial_gate.spatial_bn
        out.append((y, grads, (bn.running_mean.clone(), bn.running_var.clone())))
    return out


def _close(a, b, rtol=RTOL, what=""):
    a, b = a.detach(), b.detach()
    scale = max(float(b.abs().max()), 1e-30)
    assert float((a - b).abs().max()) <= rtol * scale, what


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_matches_plain_composition(shape):
    """Forward, the gradients of the input, the residual and every parameter
    (the MLP, the spatial conv, the spatial BN) and BN's new averages."""
    g = torch.Generator().manual_seed(sum(shape))
    x = _channels_last(*shape, generator=g)
    r = _channels_last(*shape, generator=g)
    gy = _channels_last(*shape, generator=g)
    m = _module(shape[1])
    (y0, g0, s0), (y1, g1, s1) = _plain_and_fused(m, x, r, gy)
    _close(y1, y0, what="forward")
    names = ["x", "residual"] + [n for n, _ in m.named_parameters()]
    for name, a, b in zip(names, g1, g0):
        _close(a, b, what=name)
    for a, b in zip(s1, s0):
        _close(a, b)


def test_ties_split_the_gradient_evenly():
    """Every pixel of a channel equal (a tie over the pixels of every max)
    and cg equal over the channels (the MLP's output layer zero), so that
    x1 ties over the channels too: the fused path's gradients equal those of
    the plain composition, whose ``amax`` splits evenly; and the plain
    versions of the kernels split a max's gradient into equal shares."""
    n, c, h, w = 2, 32, 4, 4
    m = _module(c)
    with torch.no_grad():
        m.channel_gate.mlp_out.weight.zero_()
        m.channel_gate.mlp_out.bias.zero_()
    level = torch.tensor([1.5, -0.5]).reshape(n, 1, 1, 1)
    x = level.expand(n, c, h, w).contiguous(memory_format=torch.channels_last)
    r = torch.ones(n, c, h, w).contiguous(memory_format=torch.channels_last)
    gy = torch.ones(n, c, h, w).contiguous(memory_format=torch.channels_last)
    (y0, g0, _), (y1, g1, _) = _plain_and_fused(m, x, r, gy)
    _close(y1, y0)
    for a, b in zip(g1, g0):
        _close(a, b)
    cg = torch.full((n, c), 0.5)
    _, mx, mx_ties = C.channel_pool_ref(x)
    _, cmax, ties = C.spatial_pool_ref(x, cg)
    assert torch.equal(mx_ties, torch.full((n, c), float(h * w)))
    assert torch.equal(ties, torch.full((n, h, w), float(c)))
    zero, one = torch.zeros_like(x), torch.ones(n, c)
    gc_max = torch.stack([torch.ones(n, h, w), torch.zeros(n, h, w)], dim=1)
    # the max over the pixels alone: 1 / (h w) at every pixel
    (go,) = C.input_bwd_ref(zero, x, cg, torch.zeros_like(gc_max), cmax, ties, mx, mx_ties,
                            one, 0 * one)
    assert torch.equal(go, torch.full_like(go, 1.0 / (h * w)))
    # the max over the channels alone: x1's gradient 1 / c, o's 0.5 / c
    (go,) = C.input_bwd_ref(zero, x, cg, gc_max, cmax, ties, mx, mx_ties, 0 * one, 0 * one)
    assert torch.equal(go, torch.full_like(go, 0.5 / c))
    (dcg,) = C.channel_bwd_ref(zero, x, cg, gc_max, cmax, ties)
    assert torch.allclose(dcg, (x[:, :, 0, 0] * h * w / c), rtol=1e-6)


class _Tail(torch.nn.Module):
    """``relu(cbam(x) + r)``, fused or plain, for ``functional_call``."""

    def __init__(self, m: CBAM, fused: bool):
        super().__init__()
        self.m, self.fused = m, fused

    def forward(self, x, r):
        return self.m.fused_gate_tail(x, r) if self.fused else F.relu(self.m(x) + r)


def _member_loss(m: CBAM, fused: bool):
    """A member's loss of the tail and, as its aux, the new BN averages."""
    tail = _Tail(m, fused)

    def loss(params, buffers, x, r):
        tensors = {f"m.{k}": v for k, v in {**params, **buffers}.items()}
        with collect_averages() as averages:
            y = functional_call(tail, tensors, (x, r))
        return (y * y.mean(dim=1, keepdim=True)).sum(), [v for pair in averages.values()
                                                           for v in pair]
    return loss


def test_vmap_keeps_batch_norm_per_member():
    """Under ``torch.func.vmap`` over two members (the vmapped seed
    engines' ``vmap(grad(...))``), each member's spatial BN takes its own
    batch statistics, and every gradient and new average equals the
    member's own unvmapped run and the plain composition's vmapped run."""
    K, shape = 2, (3, 32, 6, 5)
    m = _module(shape[1])
    params = {k: v.detach() for k, v in m.named_parameters()}
    buffers = {k: v.detach() for k, v in m.named_buffers()}
    stacked = {k: torch.stack([v, 1.3 * v]) for k, v in params.items()}
    stacked_buffers = {k: torch.stack([v, v]) for k, v in buffers.items()}
    g = torch.Generator().manual_seed(5)
    x = torch.stack([_channels_last(*shape, generator=g), 3 * _channels_last(*shape, generator=g)])
    r = torch.stack([_channels_last(*shape, generator=g) for _ in range(K)])
    results = {}
    for fused in (False, True):
        step = grad(_member_loss(m, fused), argnums=(0, 2, 3), has_aux=True)
        results[fused] = vmap(step)(stacked, stacked_buffers, x, r)
    (gp0, gx0, gr0), av0 = results[False]
    (gp1, gx1, gr1), av1 = results[True]
    _close(gx1, gx0)
    _close(gr1, gr0)
    for k in gp0:
        _close(gp1[k], gp0[k], what=k)
    for a, b in zip(av1, av0):
        _close(a, b)
    assert not torch.allclose(av1[0][0], av1[0][1])   # the members' own batch means
    for k in range(K):
        step = grad(_member_loss(m, True), argnums=(0, 2, 3), has_aux=True)
        (gp, gx, gr), av = step({n: v[k] for n, v in stacked.items()},
                                {n: v[k] for n, v in stacked_buffers.items()}, x[k], r[k])
        _close(gx1[k], gx)
        for n in gp:
            _close(gp1[n][k], gp[n], what=n)
        for a, b in zip(av1, av):
            _close(a[k], b)


@pytest.mark.parametrize("kwargs,fusable", [
    ({}, True), ({"pool_types": ("avg", "max", "lse")}, False),
    ({"pool_types": ("avg",)}, False), ({"pool_types": ("max", "avg")}, False),
    ({"no_spatial": True}, False)], ids=["avg_max", "lse", "avg", "max_avg", "no_spatial"])
def test_which_configurations_take_the_kernels(kwargs, fusable):
    """The module's construction decides: the kernels only for avg and max
    pools with the spatial gate (WideResNet's), never on the CPU, where
    ``gate_tail`` is the plain composition bit for bit."""
    m = CBAM(32, 16, **kwargs).train()
    assert m.fusable is fusable
    g = torch.Generator().manual_seed(1)
    x, r = _channels_last(2, 32, 4, 4, generator=g), _channels_last(2, 32, 4, 4, generator=g)
    assert not m.takes_kernels(x, r)
    ref = copy.deepcopy(m)
    assert torch.equal(m.gate_tail(x, r), F.relu(ref(x) + r))


def test_basic_block_without_cbam_adds_and_relus():
    block = BasicBlock(16, 16, use_cbam=False)
    block.reset_parameters(torch.Generator().manual_seed(0))
    block.train()
    assert block.cbam is None
    x = _channels_last(2, 16, 4, 4, generator=torch.Generator().manual_seed(2))
    out = block.bn2(block.conv2(F.relu(block.bn1(block.conv1(x)))))
    block2 = copy.deepcopy(block)
    assert torch.equal(block2(x), F.relu(out + x))


def test_wide_resnet_widths_take_the_kernels():
    model = WideResNet(layers=(1, 1, 1, 1))
    assert all(getattr(model, n).cbam.fusable for n in model.block_names)


@pytest.mark.parametrize("shape", [(256, 64, 56, 56), (256, 128, 28, 28), (256, 256, 14, 14),
                                   (256, 512, 7, 7), (2, 24, 6, 5)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_geometry_covers_the_pixels(shape, dtype):
    """The launch geometry the C launchers accept: lanes a power of two up to
    32 that the pieces fill where they can; the pool's bands cover every
    pixel, none empty, and its threads fit a block."""
    n, c, h, w = shape
    pieces = c * torch.empty((), dtype=dtype).element_size() // C.VECTOR_BYTES
    rows = C.row_geometry(n * h * w, c, dtype, 132)
    assert rows.lanes & (rows.lanes - 1) == 0 and rows.lanes <= min(32, pieces) < 2 * rows.lanes
    assert 1 <= rows.blocks <= C.BLOCKS_PER_SM * 132
    pool = C.pool_geometry(n, h * w, c, dtype, 132)
    assert pool.lanes == pieces and pool.rows * pool.lanes <= C.THREADS
    assert pool.splits * pool.band >= h * w > (pool.splits - 1) * pool.band


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stage_inputs(shape, dtype, device, seed=0):
    """o, cg, sg, r, gy for the six functions, and the pixel maps' gradient."""
    n, c, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def act():
        return torch.randn(n, h, w, c, generator=g, device=device).to(dtype).permute(0, 3, 1, 2)
    o, r, gy = act(), act(), act()
    cg = torch.rand(n, c, generator=g, device=device)
    sg = torch.rand(n, h * w, generator=g, device=device)
    gc = torch.randn(n, 2, h, w, generator=g, device=device).to(dtype)
    return o, cg, sg, r, gy, gc


def _held(kernel, ref, tol, what):
    if tol == 0:
        assert torch.equal(kernel, ref), what
    else:
        _close(kernel.float(), ref.float(), tol, what)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 64, 56, 56), (256, 128, 28, 28), (256, 256, 14, 14),
                                   (256, 512, 7, 7), (3, 24, 6, 5)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernels_match_plain_versions(cuda, shape, dtype):
    """Each of the six functions against its plain version on the same
    inputs: maxima, tie counts and the masked writes exact; sums to their
    summation order (fp32) or one rounding of the output (bf16)."""
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    o, cg, sg, r, gy, gc = _stage_inputs(shape, dtype, cuda)
    before = (C.launches, C.bwd_launches)
    avg, mx, mx_ties = C.channel_pool(o)
    ravg, rmx, rmx_ties = C.channel_pool_ref(o)
    _held(avg, ravg, tol, "mean over the pixels")
    _held(mx, rmx, 0, "max over the pixels")
    _held(mx_ties, rmx_ties, 0, "ties over the pixels")
    comp, cmax, ties = C.spatial_pool(o, cg)
    rcomp, rcmax, rties = C.spatial_pool_ref(o, cg)
    _held(comp[:, 0], rcomp[:, 0], 0, "max over the channels")
    _held(comp[:, 1], rcomp[:, 1], tol, "mean over the channels")
    _held(cmax, rcmax, 0, "fp32 max over the channels")
    _held(ties, rties, 0, "ties over the channels")
    (y,) = C.gate(o, cg, sg, r)
    _held(y, C.gate_ref(o, cg, sg, r)[0], 0 if dtype == torch.float32 else tol, "gate")
    dr, gx1, dsg = C.gate_bwd(gy, y, o, cg, sg)
    rdr, rgx1, rdsg = C.gate_bwd_ref(gy, y, o, cg, sg)
    _held(dr, rdr, 0, "residual gradient")
    _held(gx1, rgx1, 0 if dtype == torch.float32 else tol, "x1 gradient through the tail")
    _held(dsg, rdsg, tol, "sg gradient")
    (dcg,) = C.channel_bwd(gx1, o, cg, gc, cmax, ties)
    _held(dcg, C.channel_bwd_ref(gx1, o, cg, gc, cmax, ties)[0], tol, "cg gradient")
    gmx, gavg = torch.randn_like(cg), torch.randn_like(cg)
    (go,) = C.input_bwd(gx1, o, cg, gc, cmax, ties, mx, mx_ties, gmx, gavg)
    rgo = C.input_bwd_ref(gx1, o, cg, gc, cmax, ties, mx, mx_ties, gmx, gavg)[0]
    _held(go, rgo, tol, "input gradient")
    assert go.is_contiguous(memory_format=torch.channels_last)
    assert (C.launches - before[0], C.bwd_launches - before[1]) == (4, 4)


def _wrn_block(device, dtype):
    """Stage 1's block, computing in ``dtype``, and a batch of 32 inputs."""
    block = BasicBlock(64, 64, dtype=dtype)
    block.reset_parameters(torch.Generator().manual_seed(0))
    block = block.to(device).train()
    with torch.no_grad():
        block.cbam.spatial_gate.spatial_bn.weight.fill_(0.8)
    g = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(32, 28, 28, 64, generator=g, device=device).to(dtype).permute(0, 3, 1, 2)
    return block, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_block_on_the_card_matches_plain_versions(cuda, dtype, monkeypatch):
    """A BasicBlock's fused CBAM and tail, kernels against the same Functions
    with the plain versions on the card: forward and every gradient."""
    block, x = _wrn_block(cuda, dtype)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    out = {}
    orig = C.gate_tail
    for impl in (C.KERNELS, C.REF):
        b = copy.deepcopy(block)
        xi = x.clone().requires_grad_()
        monkeypatch.setattr(C, "gate_tail", functools.partial(orig, impl=impl))
        before = (C.launches, C.bwd_launches)
        y = b(xi)
        grads = torch.autograd.grad(y.float().square().sum(), [xi, *b.parameters()])
        launched = (C.launches - before[0], C.bwd_launches - before[1])
        assert launched == ((4, 4) if impl is C.KERNELS else (0, 0))
        out[impl is C.KERNELS] = (y, grads)
    (y1, g1), (y0, g0) = out[True], out[False]
    _close(y1.float(), y0.float(), tol, "forward")
    # a ReLU within a rounding of 0 may take the other side (cg from the
    # kernel's sums and from torch.mean differ in their last bits) and move
    # whole values of the gradients there: at most one in a million, and
    # the gradients held by their relative L2 error
    assert int(((y1 > 0) != (y0 > 0)).sum()) <= 1e-6 * y0.numel()
    l2_tol = 1e-3 if dtype == torch.float32 else 2.0 ** -5
    for a, b in zip(g1, g0):
        assert float((a.float() - b.float()).norm() / b.float().norm()) <= l2_tol


@pytest.mark.cuda
def test_counters_under_a_captured_replay(cuda):
    """The counters count at capture and the graph helper adds the capture's
    increments at each replay: 1 eager + 4 replayed steps of a block's
    forward and backward count 5 x 4 launches each way, as many as the
    card's trace shows."""
    from eoe_tpu_torch.training import graphs
    block, x = _wrn_block(cuda, torch.float32)
    x = x.clone().requires_grad_()

    def step():
        y = block(x)
        torch.autograd.grad(y.sum(), [x, *block.parameters()])

    before = (C.launches, C.bwd_launches)
    runner = graphs.ResidentSteps(step, cuda, 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        runner.run(5)
        torch.cuda.synchronize()
    assert (C.launches - before[0], C.bwd_launches - before[1]) == (20, 20)
    assert runner.replays == 4
    traced = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and "cbam_" in e.name]
    assert len(traced) == 40, traced
    runner.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_two_runs_give_the_same_bits(cuda, dtype):
    """No atomics: the forward and every gradient equal bit for bit."""
    block, x = _wrn_block(cuda, dtype)
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            b = copy.deepcopy(block)
            xi = x.clone().requires_grad_()
            y = b(xi)
            runs.append((y, *torch.autograd.grad(y.float().square().sum(), [xi, *b.parameters()])))
    finally:
        torch.backends.cudnn.deterministic = False
    for a, b in zip(*runs):
        assert torch.equal(a, b)
