"""The seed-vmapped engine (``training.vmapped_seeds``) on the CPU at a tiny
size: each member against the port's sequential ``train_cls`` of the same
seed, the engine against the JAX package's ``train_cls_vmapped_seeds``,
``Trainer.run``'s default against the JAX package's, and the vmap rules of
the fused-QKV and flash Functions and of the fused stem.

The held steps update with SGD: Adam turns float noise on near-zero
gradients into updates of the learning rate's size
(tests/test_torch_conv_trainer.py). The stacked Adam is held on given
gradients instead. The members against the sequential seeds use a random
pipeline (flip, noise), so each member's own draws are held; the
JAX comparison takes the deterministic ``normalize`` and the port's init and
plans, carried over.
"""

import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from eoe_tpu.datasets import bases as JB
from eoe_tpu.models.cnn import CNN32 as JaxCNN32
from eoe_tpu.training import vmapped_seeds as JV
from eoe_tpu.training.optim import make_optimizer as jax_make_optimizer
from eoe_tpu.training.trainer import Trainer as JaxTrainer, TrainState as JaxState
from eoe_tpu.utils.logger import Logger as JaxLogger
from eoe_tpu_torch.datasets import bases as B
from eoe_tpu_torch.models import AE32, CNN32
from eoe_tpu_torch.models.clip import ClipConfig
from eoe_tpu_torch.models.clip.model import MultiHeadAttention
from eoe_tpu_torch.models.convert import to_flax_numpy
from eoe_tpu_torch.ops import attention as A
from eoe_tpu_torch.ops.stem import fused_stem_train
from eoe_tpu_torch.training import TRAINER, NanGradientsError
from eoe_tpu_torch.training import trainer as T
from eoe_tpu_torch.training import vmapped_seeds as V
from eoe_tpu_torch.training.clip import ClipTrainer
from eoe_tpu_torch.training.optim import make_optimizer
from eoe_tpu_torch.utils.logger import Logger
from eoe_tpu_torch.utils.profiling import device_seconds, profile, step_timer

K, BATCH, N_NORMAL, N_OE, N_TEST = 3, 8, 24, 20, 12
# random ops whose outputs have no ties: a zero-padded crop makes equal
# activations, and max pooling then routes a gradient by float noise
RANDOM_SPECS = [{"op": "random_hflip"}, {"op": "gaussian_noise", "std": 0.05}, "normalize"]
SPECS = ["normalize"]
STATS = {"mean": [0.45, 0.5, 0.55], "std": [0.25, 0.3, 0.2], "mode": 0}
COMMON = dict(dataset="cifar10", oe_dataset="cifar100", datapath="", wdk=1e-3,
              milestones=[1], batch_size=BATCH)
TOL = 1e-5
# objective -> (model, SGD learning rate). At these rates every member stays
# within 1e-5 of its seed over the 6 steps; at 10x them a max-pool window
# whose two largest entries lie within float noise can route a gradient
# differently in the two summation orders (grouped against single
# convolutions), and a parameter then jumps by up to 1e-4
CASES = {"hsc": (CNN32, 1e-4), "dsvdd": (CNN32, 1e-5), "ae": (AE32, 1e-7)}
TINY_CLIP = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
                 vision_patch_size=8, context_length=77, vocab_size=49408,
                 transformer_width=128, transformer_heads=2, transformer_layers=2,
                 vision_heads_override=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One CPU thread for this module's tests: the stacked steps run many
    small kernels, and with the test workers sharing the cores their
    threads wait on each other (six concurrent copies of one test took
    259 s each with the default threads, 8.5 s with one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _combined(mod, specs, stats=STATS, test_specs=SPECS):
    rng = np.random.default_rng(0)
    x, xo, xt = (rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
                 for n in (N_NORMAL, N_OE, N_TEST))
    kw = dict(root="", train_specs=specs, test_specs=test_specs, n_classes=2,
              raw_shape=(32, 32, 3), ds_statistics=stats)
    normal = mod.GenericADDataset(mod.ArraySource(x, np.zeros(N_NORMAL)),
                                  mod.ArraySource(xt, np.arange(N_TEST) % 2),
                                  normal_classes=(0,), nominal_label=0, **kw)
    oe = mod.GenericADDataset(mod.ArraySource(xo, np.ones(N_OE)), None,
                              normal_classes=(1,), nominal_label=1, **kw)
    return mod.CombinedDataset(normal, oe)


def _sgd(trainer, lr):
    trainer.make_optimizer = lambda params, steps: make_optimizer(
        "sgd", params, lr, COMMON["wdk"], COMMON["milestones"], steps)
    return trainer


def _port(objective, specs=RANDOM_SPECS, epochs=2, logger=None):
    model, lr = CASES[objective]
    tr = TRAINER[objective](model=model(), train_specs=specs, test_specs=SPECS, logger=logger,
                            epochs=epochs, lr=lr, device="cpu", **COMMON)
    return _sgd(tr, lr)


def _seeds(n=K, cls=0):
    return [T._seed(0, cls, it, 0) for it in range(n)]


def _assert_state(want: dict, got: dict, atol: float = TOL):
    assert want.keys() == got.keys()
    for n, v in want.items():
        np.testing.assert_allclose(got[n].numpy(), v.numpy(), atol=atol, rtol=TOL, err_msg=n)


@pytest.mark.parametrize("objective", list(CASES))
def test_members_equal_the_sequential_seeds(objective):
    """Member k of one vmapped class equals the sequential seed k: every
    step's loss, the train AUROC, the test scores, the parameters and the
    BN averages (2 epochs, a milestone between them, each member's own
    crops and flips; DSVDD with each member's centre, AE with its inputs)."""
    tr, ds = _port(objective), _combined(B, RANDOM_SPECS)
    stack, rocs = V.train_cls_vmapped_seeds(tr, ds, 0, "airplane", K, _seeds())
    losses = np.array(tr.step_losses).reshape(K, -1)
    scores = V.eval_scores_vmapped(tr, ds, stack, K)
    members = stack.host_members()
    tr.step_losses = []
    for k, seed in enumerate(_seeds()):
        state, roc = tr.train_cls(ds, 0, "airplane", k, seed)
        np.testing.assert_allclose(losses[k], tr.step_losses, rtol=TOL)
        tr.step_losses = []
        assert roc is not None and abs(roc.auc - rocs[k].auc) <= TOL
        np.testing.assert_allclose(scores[k], tr.eval_scores(state, ds), rtol=TOL, atol=1e-6)
        _assert_state(state.model.state_dict(), members[k][0])
        # the member's slice of the optimizer state, in the sequential format
        # (its momentum sums every step's gradient, whose conv-weight entries
        # cancel to 1e-4 of the largest: held as the exact slice instead)
        seq_opt = state.optimizer.state_dict()["optimizer"]
        member_opt = members[k][1]["optimizer"]
        assert members[k][1]["count"] == state.optimizer.count == 6
        assert member_opt["param_groups"] == seq_opt["param_groups"]
        assert member_opt["state"].keys() == seq_opt["state"].keys()
        stacked_opt = stack.optimizer.optimizer.state
        for i, n in enumerate(stack.trainable):
            assert torch.equal(member_opt["state"][i]["momentum_buffer"],
                               stacked_opt[stack.tensors[n]]["momentum_buffer"][k])


def test_eval_scores_vmapped_equal_per_member_eval():
    """Every member's test scores from the stacked eval equal ``eval_scores``
    of that member's state (fresh members, BN in eval mode)."""
    tr, ds = _port("dsvdd"), _combined(B, RANDOM_SPECS)
    stack = tr.init_states_stacked(_seeds(), 1)
    centers = []
    for k in range(K):
        stack.load_member(tr.model, k)
        centers.append(tr.prepare_metric("airplane", ds, T.TrainState(tr.model, None), k))
    tr.center = torch.stack(centers)
    scores = V.eval_scores_vmapped(tr, ds, stack, K)
    for k, seed in enumerate(_seeds()):
        state = tr.init_state(seed, ds, 1)
        tr.center = centers[k]
        np.testing.assert_allclose(scores[k], tr.eval_scores(state, ds), rtol=TOL)
        tr.center = torch.stack(centers)


def test_clip_members_fold_into_one_kernel_call():
    """A tiny CLIP, two members: each equals its sequential seed (losses,
    scores, image-tower parameters); with the kernels' plain versions in the
    fused-QKV Function, every block's forward and backward ran once per step
    on the folded batch of K*n images."""
    sd_gen = torch.Generator().manual_seed(0)
    from eoe_tpu_torch.models.clip import CLIP
    sd = CLIP(ClipConfig(**TINY_CLIP), generator=sd_gen).state_dict()
    specs = [{"op": "clip_pil_preprocessing", "resolution": 32}, {"op": "random_hflip"},
             {"op": "clip_tensor_preprocessing"}]
    tr = ClipTrainer(None, specs, None, dataset="cifar10", oe_dataset="cifar100", datapath="",
                     logger=None, epochs=1, lr=1e-2, wdk=1e-3, milestones=[], batch_size=BATCH,
                     clip_state_dict=sd, clip_config=ClipConfig(**TINY_CLIP), device="cpu")
    calls = []

    def fwd(qkv, heads, causal):
        calls.append(("fwd", qkv.shape[0]))
        return A.fused_qkv_attention_fwd_ref(qkv, heads, causal)

    def bwd(qkv, dout, heads, causal):
        calls.append(("bwd", qkv.shape[0]))
        return A.fused_qkv_attention_bwd_ref(qkv, dout, heads, causal)

    def qkv_attention(qkv, heads, causal=False):
        return A._QkvAttention.apply(qkv, heads, causal, fwd, bwd)

    for m in tr.model.modules():
        if isinstance(m, MultiHeadAttention):
            m.qkv_attention = qkv_attention
    ds = _combined(B, specs, stats=None, test_specs=None)
    stack, rocs = V.train_cls_vmapped_seeds(tr, ds, 0, "airplane", 2, _seeds(2))
    steps, layers = N_NORMAL // BATCH, TINY_CLIP["vision_layers"]
    image_calls = [c for c in calls if c[1] != 2]   # the rest: the two prompts' text tower
    assert image_calls == ([("fwd", 2 * 2 * BATCH)] * layers
                           + [("bwd", 2 * 2 * BATCH)] * layers) * steps
    calls.clear()
    losses = np.array(tr.step_losses).reshape(2, -1)
    members = stack.host_members()
    tr.step_losses = []
    for k, seed in enumerate(_seeds(2)):
        state, roc = tr.train_cls(ds, 0, "airplane", k, seed)
        np.testing.assert_allclose(losses[k], tr.step_losses, rtol=TOL)
        tr.step_losses = []
        assert abs(roc.auc - rocs[k].auc) <= TOL
        want = {n: v for n, v in state.model.state_dict().items() if n.startswith("visual.")}
        _assert_state(want, {n: members[k][0][n] for n in want})
    assert {n for _, n in calls} == {2, 2 * BATCH}   # sequential: one member's batch


def test_stacked_adam_equals_separate_adams():
    """One Adam (coupled decay, a milestone) over stacked (K, ...) leaves
    gives every member exactly the update of its own Adam, on given
    gradients."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(5, 3), (7,), ()]
    init = [torch.randn(K, *s, generator=gen) for s in shapes]
    grads = [[torch.randn(K, *s, generator=gen) for s in shapes] for _ in range(4)]
    stacked = [torch.nn.Parameter(t.clone()) for t in init]
    opt = make_optimizer("adam", stacked, 1e-2, 1e-3, [1], 2)
    singles = [[torch.nn.Parameter(t[k].clone()) for t in init] for k in range(K)]
    opts = [make_optimizer("adam", ps, 1e-2, 1e-3, [1], 2) for ps in singles]
    for g in grads:
        for p, gk in zip(stacked, g):
            p.grad = gk.clone()
        opt.step()
        for k in range(K):
            for p, gk in zip(singles[k], g):
                p.grad = gk[k].clone()
            opts[k].step()
    for i, p in enumerate(stacked):
        for k in range(K):
            assert torch.equal(p.detach()[k], singles[k][i].detach()), (i, k)


def test_vmapped_seeds_match_jax():
    """The port's engine against the JAX package's on the same stacked init
    (carried with ``to_flax_numpy``), the same per-member plans and the
    deterministic pipeline: parameters, BN averages, train AUROCs and the
    members' test scores."""
    tr, ds = _port("hsc", SPECS), _combined(B, SPECS)
    seeds = _seeds()
    init = tr.init_states_stacked(seeds, N_NORMAL // BATCH).host_members()
    samplers = [B.BalancedEpochSampler(N_NORMAL, N_OE, BATCH, T._seed(s, 1)) for s in seeds]
    plans = [[s.epoch() for _ in range(2)] for s in samplers]
    stack, rocs = V.train_cls_vmapped_seeds(tr, ds, 0, "airplane", K, seeds)
    scores = V.eval_scores_vmapped(tr, ds, stack, K)

    jt = JaxTrainer(model=JaxCNN32(), train_specs=SPECS, test_specs=SPECS, objective="hsc",
                    logger=JaxLogger("", active=False), epochs=2, lr=CASES["hsc"][1], **COMMON)
    jt.make_optimizer = lambda steps: jax_make_optimizer("sgd", CASES["hsc"][1], COMMON["wdk"],
                                                         COMMON["milestones"], steps)

    def init_states_stacked(keys, jds, steps):
        members = [to_flax_numpy(m[0]) for m in init]
        stacked = jax.tree_util.tree_map(lambda *xs: jnp.asarray(np.stack(xs)), *members)
        params = stacked["params"]
        return JaxState(params=params, batch_stats=stacked["batch_stats"],
                        opt_state=jax.vmap(jt.make_optimizer(steps).init)(params),
                        step=jnp.zeros((len(keys),), jnp.int32))

    made = iter(range(K))

    class Sampler(JB.BalancedEpochSampler):   # member k replays the port's plans
        def __init__(self, *a):
            super().__init__(*a)
            self._plans = iter(plans[next(made)])

        def epoch(self):
            return next(self._plans)

    jt.init_states_stacked = init_states_stacked
    jds = _combined(JB, SPECS)
    orig = JV.BalancedEpochSampler
    JV.BalancedEpochSampler = Sampler
    try:
        keys = [jax.random.key(i) for i in range(K)]
        jstates, jrocs = JV.train_cls_vmapped_seeds(jt, jds, 0, "airplane", K, keys)
    finally:
        JV.BalancedEpochSampler = orig
    jscores = JV.eval_scores_vmapped(jt, jds, jstates, K)
    np.testing.assert_allclose(scores, jscores, rtol=TOL, atol=1e-6)
    for k, (params, _) in enumerate(stack.host_members()):
        got = to_flax_numpy(params)
        for col in ("params", "batch_stats"):
            want = jax.tree_util.tree_map(lambda x: np.asarray(x[k]), getattr(jstates, col))
            for path, v in jax.tree_util.tree_leaves_with_path(want):
                g = got[col]
                for p in path:
                    g = g[p.key]
                np.testing.assert_allclose(g, v, atol=TOL, err_msg=str(path))
        assert abs(rocs[k].auc - jrocs[k].auc) <= TOL


# ---------------------------------------------------------------- the grid


class _Streamed(B.ArraySource):
    """An array source that claims to stream (neither resident nor fitting)."""
    resident = False

    def fits_resident(self, n):
        return False


class _JaxStreamed(JB.ArraySource):
    resident = False

    def fits_resident(self, n):
        return False


VMAP_CASES = {   # case -> (run_seeds, load, objective, streamed)
    "multi_seed_conv": (2, None, "hsc", False),
    "single_seed": (1, None, "hsc", False),
    "clip": (2, None, "clip", False),
    "load": (2, [["snapshot"] * 2], "hsc", False),
    "streamed_split": (2, None, "hsc", True),
}


class _Reached(Exception):
    pass


def _decision(side, case, monkeypatch):
    """Which engine ``run`` reaches for class 0 with the case's arguments:
    "vmapped" or "sequential" (both are stopped at their entry)."""
    run_seeds, load, objective, streamed = VMAP_CASES[case]
    if side == "jax":
        trainer_cls, mod, engine, model = JaxTrainer, JB, JV, JaxCNN32()
        source = _JaxStreamed if streamed else JB.ArraySource
        logger = JaxLogger("", active=False)
    else:
        trainer_cls, mod, engine, model = T.Trainer, B, V, CNN32()
        source = _Streamed if streamed else B.ArraySource
        logger = None
    device = {} if side == "jax" else {"device": "cpu"}
    tr = trainer_cls(model=model, train_specs=SPECS, test_specs=SPECS, logger=logger, epochs=1,
                     lr=1e-2, objective=objective, **COMMON, **device)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (N_NORMAL, 32, 32, 3), dtype=np.uint8)
    kw = dict(root="", train_specs=SPECS, test_specs=SPECS, n_classes=2,
              raw_shape=(32, 32, 3), ds_statistics=STATS)
    normal = mod.GenericADDataset(source(x, np.zeros(N_NORMAL)), source(x, np.arange(24) % 2),
                                  normal_classes=(0,), nominal_label=0, **kw)
    oe = mod.GenericADDataset(source(x, np.ones(N_NORMAL)), None, normal_classes=(1,),
                              nominal_label=1, **kw)
    tr.ds = mod.CombinedDataset(normal, oe)
    reached = []

    def stop(name):
        def fn(*a, **k):
            reached.append(name)
            raise _Reached()
        return fn

    monkeypatch.setattr(engine, "train_cls_vmapped_seeds", stop("vmapped"))
    monkeypatch.setattr(tr, "train_cls", stop("sequential"))
    monkeypatch.setattr(tr, "load_ds_statistics", lambda path: None)
    with pytest.raises(_Reached):
        tr.run(run_classes=[0], run_seeds=run_seeds, load=load)
    return reached[0]


@pytest.mark.parametrize("case", list(VMAP_CASES))
def test_run_vmaps_where_jax_does(case, monkeypatch):
    """``Trainer.run``'s default (``vmap_seeds=None``) reaches the vmapped
    engine in exactly the cases where the JAX package's does: several seeds
    of a conv model trained from scratch on resident splits; not for one
    seed, CLIP, a resumed run, or a streamed split."""
    want = _decision("jax", case, monkeypatch)
    assert _decision("port", case, monkeypatch) == want
    assert (want == "vmapped") == (case == "multi_seed_conv")


def _files(root):
    """The run directory's files; a tensorboard event file by its prefix
    (its name carries the time, host and process)."""
    out = set()
    for d, _, names in os.walk(root):
        out |= {re.sub(r"tfevents\..*", "tfevents", os.path.relpath(os.path.join(d, n), root))
                for n in names}
    return out


def test_vmapped_run_writes_the_sequential_run_directory(tmp_path):
    """A vmapped class writes what the sequential seeds write (snapshots,
    previews, per-seed scores, results.json), with the same AUROCs; its
    snapshots load back into the sequential trainer, optimizer included."""
    runs = {}
    for vmapped in (True, False):
        logger = Logger(str(tmp_path / str(vmapped)), noname=True, archive_source=False)
        tr = _port("hsc", logger=logger, epochs=1)
        tr.ds = _combined(B, RANDOM_SPECS)
        _, runs[vmapped] = tr.run(run_classes=[0], run_seeds=2, vmap_seeds=vmapped)
        assert tr._last_grid_vmapped == vmapped
    assert _files(tmp_path / "True") == _files(tmp_path / "False")
    np.testing.assert_allclose(runs[True]["cls_aucs"][0], runs[False]["cls_aucs"][0], atol=1e-4)
    with open(tmp_path / "True" / "print.txt") as f:
        assert "trained 2 seeds of cls 0 vmapped" in f.read()
    tr = _port("hsc", epochs=1)
    ds = _combined(B, RANDOM_SPECS)
    state = tr.init_state(1, ds, 3)
    _, epoch = tr.load(str(tmp_path / "True" / "snapshots" / "snapshot_cls0_it1.pt"), state)
    assert epoch == 1 and state.optimizer.count == 3


@pytest.mark.parametrize("per", [2, 1])
def test_seeds_train_in_programs_that_fit(per, tmp_path, monkeypatch):
    """Three seeds on a card that holds ``per`` of them in one program: two
    programs (2 + 1) that write the sequential seeds' run directory with
    their AUROCs, or with one, the sequential seeds."""
    runs, printed = {}, {}
    for mode in ("fit", "sequential"):
        monkeypatch.setattr(V, "seeds_per_program", lambda tr, ds, c, seeds: per)
        logger = Logger(str(tmp_path / mode), noname=True, archive_source=False)
        tr = _port("hsc", logger=logger, epochs=1)
        tr.ds = _combined(B, RANDOM_SPECS)
        _, runs[mode] = tr.run(run_classes=[0], run_seeds=3, vmap_seeds=mode == "fit")
        assert tr._last_grid_vmapped == (mode == "fit" and per > 1)
        with open(tmp_path / mode / "print.txt") as f:
            printed[mode] = f.read()
    assert _files(tmp_path / "fit") == _files(tmp_path / "sequential")
    np.testing.assert_allclose(runs["fit"]["cls_aucs"][0], runs["sequential"]["cls_aucs"][0],
                               atol=1e-4)
    assert ("trained 3 seeds of cls 0 vmapped, 2 per program" in printed["fit"]) == (per == 2)
    assert ("training them sequentially" in printed["fit"]) == (per == 1)
    for k in range(3):
        assert f"cls 0 seed {k} epoch 1/1" in printed["fit"]


@pytest.mark.parametrize("peaks, free, wanted, want", [
    ((30, 50), 100, 16, 4),         # (90 - 10) // 20
    ((30, 50), 100, 3, 3),          # at most what was asked
    ((30, 50), 40, 16, 1),
    ((30, 50), 10, 16, 1),          # at least one
    ((0, 1 << 62), 1 << 40, 16, 1),  # two members ran out of memory
])
def test_members_that_fit(peaks, free, wanted, want):
    """The members of one program from the peaks of one and of two members
    and the free memory, a tenth of it kept spare."""
    assert V.members_that_fit(peaks, free, wanted) == want


def test_members_per_program_probes_only_on_the_card():
    """Off the card every member is wanted and nothing is probed."""
    tr = _port("hsc")

    def probe(k):
        raise AssertionError("probed on the CPU")

    assert V.members_per_program(tr, "key", 10, probe) == 10 and tr.member_peaks == {}


def test_nan_scores_fall_back_to_sequential_seeds(tmp_path, monkeypatch):
    """NaN scores in the vmapped run: a warning, and the class trains its
    seeds sequentially."""
    logger = Logger(str(tmp_path), noname=True, archive_source=False)
    tr = _port("hsc", logger=logger, epochs=1)
    tr.ds = _combined(B, SPECS)

    def nan(*a, **k):
        raise NanGradientsError()

    monkeypatch.setattr(V, "train_cls_vmapped_seeds", nan)
    _, res = tr.run(run_classes=[0], run_seeds=2)
    assert not tr._last_grid_vmapped and np.isfinite(res["mean_auc"])
    with open(tmp_path / "warnings.txt") as f:
        assert "falling back to sequential training" in f.read()


# ---------------------------------------------------------------- vmap rules


def _counting(fn, seen):
    def wrapped(*args):
        seen.append(args[0].shape[0])
        return fn(*args)
    return wrapped


@pytest.mark.parametrize("causal", [False, True])
def test_qkv_vmap_rule_folds_members(causal):
    """Under ``vmap(grad(...))`` the fused-QKV Function calls its forward
    and its backward once each, on the K*n folded images, and the values
    and gradients equal per-member calls."""
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(K, 4, 20, 3 * 128, generator=gen)
    seen_f, seen_b = [], []
    fwd = _counting(A.fused_qkv_attention_fwd_ref, seen_f)
    bwd = _counting(A.fused_qkv_attention_bwd_ref, seen_b)

    def loss(x):
        out = A._QkvAttention.apply(x, 2, causal, fwd, bwd)
        return (out * out).sum(), out

    g, out = vmap(grad(loss, has_aux=True))(qkv)
    assert seen_f == [K * 4] and seen_b == [K * 4]
    for k in range(K):
        x = qkv[k].clone().requires_grad_()
        o = A.fused_qkv_attention_ref(x, 2, causal)
        (gk,) = torch.autograd.grad((o * o).sum(), x)
        assert torch.equal(out[k], o.detach())
        torch.testing.assert_close(g[k], gk, rtol=1e-6, atol=1e-6)


def test_flash_vmap_rule_folds_members():
    """The flash Function's rule: q, k and v fold into one call of K*n
    images with the shared mask; values and gradients equal per-member
    calls; a mask that differs per member is refused."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(K, 3, 2, 17, 32, generator=gen) for _ in range(3))
    mask = torch.randn(17, 17, generator=gen)
    seen = []
    fwd = _counting(A.flash_attention_ref, seen)

    def loss(q, k, v):
        out = A._FlashAttention.apply(q, k, v, mask, fwd)
        return out.square().sum(), out

    g, out = vmap(grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    assert seen == [K * 3]
    for m in range(K):
        xs = [t[m].clone().requires_grad_() for t in (q, k, v)]
        o = A.flash_attention(*xs, mask)
        gs = torch.autograd.grad(o.square().sum(), xs)
        torch.testing.assert_close(out[m], o.detach(), rtol=0, atol=0)
        for a, b in zip(g, gs):
            torch.testing.assert_close(a[m], b, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="one mask"):
        vmap(lambda q, m: A._FlashAttention.apply(q, q, q, m, fwd))(q, mask.expand(K, 17, 17))


def test_fused_stem_vmap_keeps_member_statistics():
    """The fused stem under ``vmap(grad(...))``: each member's output, BN
    statistics and gradients equal its own call (statistics per member,
    not pooled over the members)."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(K, 8, 3, 7, 7, generator=gen) * 0.1
    gamma, beta = torch.rand(K, 8, generator=gen) + 0.5, torch.randn(K, 8, generator=gen) * 0.1
    x = torch.randn(K, 4, 3, 32, 32, generator=gen) + torch.arange(K).reshape(K, 1, 1, 1, 1)

    def loss(w, gamma, beta, x):
        out, mu, var = fused_stem_train(w, gamma, beta, x)
        return (out * out).sum(), (out, mu, var)

    g, (out, mu, var) = vmap(grad(loss, argnums=(0, 1, 2), has_aux=True))(w, gamma, beta, x)
    assert not torch.allclose(mu[0], mu[1])
    for k in range(K):
        ps = [t[k].clone().requires_grad_() for t in (w, gamma, beta)]
        o, m, s = fused_stem_train(*ps, x[k])
        gs = torch.autograd.grad((o * o).sum(), ps)
        torch.testing.assert_close(out[k], o.detach())
        torch.testing.assert_close(mu[k], m)
        torch.testing.assert_close(var[k], s)
        for a, b in zip(g, gs):
            torch.testing.assert_close(a[k], b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def test_step_timer_appends_one_duration_per_step(tmp_path):
    """``step_timer`` appends one duration per step, waiting for the
    ``sync`` tensor; ``profile`` writes a Chrome trace of its block, in
    which the CPU shows no device time."""
    times = []
    with profile(str(tmp_path)) as prof:
        for _ in range(3):
            with step_timer(times) as out:
                time.sleep(0.01)
                out["sync"] = torch.ones(2) * 2
    assert len(times) == 3 and all(t >= 0.01 for t in times)
    assert prof is not None and (tmp_path / "trace.json").stat().st_size > 0
    assert device_seconds(prof) == 0.0
    with profile(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()
