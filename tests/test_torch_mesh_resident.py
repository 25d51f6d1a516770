"""The resident epoch under a mesh on the CPU: gloo ranks, each a process of
one thread, with ``EOE_TPU_CPU_SCAN=1``, run the step that the card captures
as CUDA graphs (``training.graphs``), uncaptured, with the mesh's
collectives inside it: the data axis's gradient sum in DDP's place
(``parallel.mesh.all_reduce_grads``), batch norm's global sums and the
model axis's product sums. Each case runs twice on the same ranks, through
the resident epoch and through the per-step loop with DDP
(``trainer._per_step``), and the two are held to 1e-5; the data mesh's
``Trainer.run`` is also held against the JAX package's run on its data=2
mesh of the virtual CPU devices (tests/test_torch_parallel.py's limits).

The ranks run once for the module (``ranks``): this file's ``__main__``
branch, started with EOE_TPU_DISTRIBUTED=1 and the group's address. Four
ranks form a 2 x 2 mesh and train tests/test_parallel.py's tiny CLIP with a
random flip; then ranks 0-1 form a data mesh of two and train CNN32 on the
JAX package's benchmark CIFAR-10 stack (every random op drawn for the
global half-batch) and run tests/test_torch_parallel.py's ``Trainer.run``.
The worker imports no jax. The gate of the resident epoch is held by its
inputs (device, mesh backend and shape), without a card.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import _env, _launch, epoch_losses, jax_data_mesh_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
# the CIFAR-10 stack of the JAX package's benchmark (bench.py:91-103)
CIFAR_SPECS = [
    {"op": "color_jitter", "brightness": 0.01, "contrast": 0.01, "saturation": 0.01,
     "hue": 0.01},
    {"op": "random_hflip", "p": 0.5},
    {"op": "random_crop", "size": 32, "padding": 4},
    {"op": "gaussian_noise", "std": 0.001},
    "normalize"]
WAYS = ("resident", "per_step")


# ---------------------------------------------------------------- the ranks' cases


def _counted(fn, *args) -> tuple:
    """``fn(*args)`` and the number of ``ResidentSteps`` it built."""
    from eoe_tpu_torch.training import graphs
    made, base = [], graphs.ResidentSteps

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    graphs.ResidentSteps = Recorded
    try:
        return fn(*args), len(made)
    finally:
        graphs.ResidentSteps = base


def _trained(tr, ds, per_step: bool, mesh) -> dict:
    """``train_cls`` of class 0, seed 0 on ``ds`` through the resident epoch
    or the per-step loop: every step's global loss, the full parameters
    (gathered over a model axis), the train AUROC and how it trained."""
    from eoe_tpu_torch.parallel import mesh as meshlib
    tr._per_step = per_step
    (state, roc), runners = _counted(tr.train_cls, ds, 0, "airplane", 0, 11)
    params, shardings = state.model.state_dict(), tr._shardings(state)
    if shardings is not None:
        params = meshlib.gather_params(mesh, params, shardings)
    return {"losses": list(tr.step_losses), "auroc": roc.auc, "runners": runners,
            "params": {k: v.detach().clone() for k, v in params.items()},
            "sum_grads": state.sum_grads, "ddp": state.ddp is not None}


def _cnn(mesh, per_step: bool) -> dict:
    """CNN32 (batch norm's global sums) on the CIFAR-10 stack, 2 epochs of 3
    steps of 8 + 8 (the last step's zero-weight tail on rank 1), SGD with a
    milestone between the epochs."""
    from eoe_tpu_torch.datasets import bases as B
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.training import TRAINER
    from eoe_tpu_torch.training.optim import make_optimizer
    from test_torch_parallel import COMMON, SPECS, _combined
    tr = TRAINER["hsc"](model=CNN32(), train_specs=CIFAR_SPECS, test_specs=SPECS, logger=None,
                        epochs=2, device="cpu", mesh=mesh, **{**COMMON, "milestones": [1]})
    tr.make_optimizer = lambda params, steps: make_optimizer(
        "sgd", params, COMMON["lr"], COMMON["wdk"], [1], steps)
    return _trained(tr, _combined(B, CIFAR_SPECS, SPECS), per_step, mesh)


def _clip(mesh, per_step: bool) -> dict:
    """The tiny CLIP of tests/test_parallel.py (both towers split over the
    model axis), HSC with a random flip, 2 epochs of 3 steps, SGD."""
    from eoe_tpu_torch.datasets import bases as B
    from eoe_tpu_torch.models.clip import CLIP, ClipConfig
    from eoe_tpu_torch.training import Trainer
    from test_torch_parallel import CLIP_CFG, CLIP_HW, CLIP_SPECS, COMMON, _combined
    specs = [{"op": "random_hflip"}, *CLIP_SPECS]
    weights = CLIP(ClipConfig(**CLIP_CFG), generator=torch.Generator().manual_seed(0)).state_dict()
    tr = Trainer(model=CLIP(ClipConfig(**CLIP_CFG)), objective="hsc", train_specs=specs,
                 test_specs=CLIP_SPECS, logger=None, epochs=2, device="cpu", mesh=mesh, **COMMON)
    tr.init_weights = lambda seed: tr.model.load_state_dict(weights)
    return _trained(tr, _combined(B, specs, CLIP_SPECS, CLIP_HW), per_step, mesh)


def _rank_cases(rank: int) -> dict:
    """The 2 x 2 mesh's CLIP on every rank; then ranks 0-1 as a data mesh of
    two: CNN32 and ``Trainer.run``."""
    from eoe_tpu_torch.parallel import mesh as meshlib
    from test_torch_parallel import _run
    meshlib.init_distributed()
    mesh = meshlib.make_mesh(meshlib.MeshConfig(data=2, model=2), "cpu")
    out = {"clip": {way: _clip(mesh, way == "per_step") for way in WAYS}}
    meshlib.leave()
    if rank < 2:
        meshlib._init_group(os.environ["MESH_RESIDENT_DATA_ADDR"], 2, rank)
        mesh = meshlib.make_mesh(meshlib.MeshConfig(data=2), "cpu")
        out["cnn"] = {way: _cnn(mesh, way == "per_step") for way in WAYS}
        run, runners = _counted(_run, mesh)
        out["run"] = {**run, "runners": runners}
        meshlib.leave()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from eoe_tpu_torch.parallel.mesh import free_port
    tmp = str(tmp_path_factory.mktemp("ranks"))
    addr, data_addr = f"localhost:{free_port()}", f"localhost:{free_port()}"
    envs = [_env(EOE_TPU_DISTRIBUTED="1", EOE_TPU_COORD_ADDR=addr, EOE_TPU_NUM_PROCESSES="4",
                 EOE_TPU_PROCESS_ID=str(i), EOE_TPU_CPU_SCAN="1",
                 MESH_RESIDENT_DATA_ADDR=data_addr) for i in range(4)]
    _launch([tmp], envs, timeout=300, script=__file__)
    return [torch.load(os.path.join(tmp, f"rank{i}.pt"), weights_only=False) for i in range(4)]


# ---------------------------------------------------------------- the gate


@pytest.mark.parametrize("device, backend, data, model, want", [
    ("cuda", "nccl", 2, 1, True),      # a card a rank: NCCL, captured
    ("cuda", "nccl", 2, 2, True),      # data x model on NCCL
    ("cuda", "nccl", 1, 2, True),
    ("cuda", "gloo", 2, 1, False),     # ranks sharing a card: gloo through the host
    ("cuda", "gloo", 1, 2, False),
    ("cuda", "gloo", 1, 1, True),      # one rank: nothing to capture
    ("cpu", "gloo", 2, 1, True),       # EOE_TPU_CPU_SCAN=1: uncaptured
    ("cpu", "gloo", 2, 2, True)])
def test_resident_gate_by_its_inputs(monkeypatch, device, backend, data, model, want):
    """``Trainer.resident_epoch`` under a mesh, from the gate's inputs alone
    (the trainer's device and its mesh's backend and shape; no card is
    used): on the card where the ranks run NCCL, a card each, and on the
    CPU under ``EOE_TPU_CPU_SCAN=1``; not for gloo ranks sharing a card,
    whose step stays per-step. A stacked program (``stacked=True``) holds no
    collective and takes it under any mesh; without
    ``EOE_TPU_CPU_SCAN=1`` the CPU takes neither."""
    from eoe_tpu_torch.datasets import bases as B
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.parallel.mesh import Mesh
    from eoe_tpu_torch.training import TRAINER
    from test_torch_parallel import COMMON, SPECS, _combined
    monkeypatch.setenv("EOE_TPU_CPU_SCAN", "1")
    tr = TRAINER["hsc"](model=CNN32(), train_specs=SPECS, test_specs=SPECS, logger=None,
                        epochs=1, device="cpu", **COMMON)
    ds = _combined(B, SPECS, SPECS)
    tr.device = torch.device(device, 0) if device == "cuda" else torch.device(device)
    tr.mesh = Mesh(None, backend, 0, data, tr.device, model=model)
    assert tr.resident_epoch(ds) is want
    assert tr.resident_epoch(ds, stacked=True)
    monkeypatch.delenv("EOE_TPU_CPU_SCAN")
    on_card = device == "cuda"
    assert tr.resident_epoch(ds) is (want and on_card)
    assert tr.resident_epoch(ds, stacked=True) is on_card


def test_resident_gate_takes_no_evaluation_only_dataset(monkeypatch):
    """An evaluation-only dataset (no train split, as ``inference_custom``
    builds it) trains nothing: the gate says no on the card and under
    ``EOE_TPU_CPU_SCAN=1``, and a class-seed's state is made without the
    gate in one process (asking it there raised on the card)."""
    from types import SimpleNamespace
    from eoe_tpu_torch.models import CNN32
    from eoe_tpu_torch.training import TRAINER
    from test_torch_parallel import COMMON, SPECS
    monkeypatch.setenv("EOE_TPU_CPU_SCAN", "1")
    tr = TRAINER["hsc"](model=CNN32(), train_specs=SPECS, test_specs=SPECS, logger=None,
                        epochs=1, device="cpu", **COMMON)
    ds = SimpleNamespace(train_set=None)
    assert tr.resident_epoch(ds) is False
    state = tr.init_state(0, ds, 1)
    assert state.ddp is None and not state.sum_grads
    tr.device = torch.device("cuda", 0)
    assert tr.resident_epoch(ds) is False


def test_rank_draws_trace_a_contiguous_image(monkeypatch):
    """A rank draws for the global half-batch through a stand-in without
    memory (``trainer._local_draws``: zeros expanded to the batch's shape),
    and the pipeline takes one image of it through itself once to learn what
    each draw sees. Where the JAX package's jitter-crop-flip peephole is the
    first step (the acceptance stack's order, a crop without padding), that
    image reaches the crop step first, whose kernel on the card takes
    contiguous images only: the image must be a copy with its own memory. It
    was the stand-in's stride-0 slice, and a data-parallel step on the
    acceptance stack raised on the card."""
    from eoe_tpu_torch.ops import augment
    from eoe_tpu_torch.ops.preprocess import compile_pipeline
    from eoe_tpu_torch.training.trainer import _local_draws
    seen, crop = [], augment.crop_augment

    def recorded(images, *args, **kwargs):
        seen.append(images.is_contiguous())
        return crop(images, *args, **kwargs)

    monkeypatch.setattr(augment, "crop_augment", recorded)
    specs = [{"op": "color_jitter", "brightness": 0.4, "contrast": 0.4, "saturation": 0.4,
              "hue": 0.1}, {"op": "random_crop", "size": 24}, {"op": "random_hflip"}]
    fn = compile_pipeline(specs)
    assert fn.fused[0][0] == "color_jitter_crop_flip"
    x = torch.zeros(4, 32, 32, 3, dtype=torch.uint8)
    draws = _local_draws(fn, x, (4, 8, 8), None, torch.Generator().manual_seed(0))
    assert seen == [True] and len(draws) == len(fn.random_ops)
    assert all(v.shape[0] == 4 for d in draws for v in d.values())


# ---------------------------------------------------------------- the ranks


def _hold(got: dict, want: dict, name: str):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL, atol=TOL, err_msg=name)
    assert abs(got["auroc"] - want["auroc"]) <= TOL, name
    for k, v in want["params"].items():
        torch.testing.assert_close(got["params"][k], v, atol=TOL, rtol=0, msg=f"{name} {k}")


def test_cnn32_resident_epoch_matches_per_step_ddp(ranks):
    """CNN32 on the CIFAR-10 stack on a data mesh of two: the resident
    epoch (one-step programs replayed over the device plans, the gradient
    sum in the step, no DDP) against the per-step loop with DDP on the same
    ranks: every step's global loss, the parameters and batch-norm averages
    and the train AUROC to 1e-5; the ranks hold the same parameters."""
    for rank in ranks[:2]:
        got, want = rank["cnn"]["resident"], rank["cnn"]["per_step"]
        assert got["runners"] == 1 and got["sum_grads"] and not got["ddp"]
        assert want["runners"] == 0 and want["ddp"] and not want["sum_grads"]
        assert len(got["losses"]) == 6 and any("running" in k for k in got["params"])
        _hold(got, want, "cnn")
    for k, v in ranks[0]["cnn"]["resident"]["params"].items():
        assert torch.equal(ranks[1]["cnn"]["resident"]["params"][k], v), k


def test_clip_resident_epoch_matches_per_step_on_a_2x2_mesh(ranks):
    """The tiny CLIP on a 2 x 2 mesh (the model axis's sums and the data
    axis's gradient sum inside the step) through the resident epoch against
    the per-step loop: losses, the gathered parameters and the AUROC to
    1e-5, on every rank."""
    for rank in ranks:
        got, want = rank["clip"]["resident"], rank["clip"]["per_step"]
        assert got["runners"] == 1 and got["sum_grads"] and want["runners"] == 0
        _hold(got, want, "clip")
        assert got["losses"] == ranks[0]["clip"]["resident"]["losses"]


def test_resident_run_matches_jax_data_mesh(ranks, tmp_path, monkeypatch):
    """``Trainer.run`` (tests/test_torch_parallel.py's case) through the
    resident epoch on a data mesh of two against the JAX package's
    ``Trainer.run`` on its data=2 mesh: each epoch's loss within 2e-3
    relative, the AUROC within 0.01 (the limits of
    ``test_trainer_run_matches_jax_data_mesh``)."""
    got = ranks[0]["run"]
    assert got["runners"] == 1 and not got["vmapped"]
    jax_losses, jax_aucs = jax_data_mesh_run(tmp_path, monkeypatch)
    np.testing.assert_allclose(epoch_losses(got["losses"]), jax_losses, rtol=2e-3)
    np.testing.assert_allclose(got["aucs"], jax_aucs, atol=0.01)
    assert ranks[1]["run"]["losses"] == got["losses"]


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    world_rank = int(os.environ["EOE_TPU_PROCESS_ID"])
    result = _rank_cases(world_rank)
    torch.save(result, os.path.join(sys.argv[1], f"rank{world_rank}.pt"))
