"""The port's optimizers and MultiStep schedule against the JAX package's
optax chains: the same toy parameters and the same gradient sequence (numpy),
six updates with a milestone inside the run, parameters equal to 1e-6.

optax computes Adam's bias corrections in fp32, where 0.999 is not exact
(1 - 0.999 is off by 1.3e-5 relative), torch in float64; the updates differ
by ~6e-6 of their size, so the learning rate is 1e-2, where six updates of
parameters ~1 stay within 1e-6."""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eoe_tpu.training.optim import make_optimizer as jax_make_optimizer
from eoe_tpu.training.optim import multistep_lr as jax_multistep_lr
from eoe_tpu_torch.training.optim import make_optimizer, multistep_lr

STEPS, STEPS_PER_EPOCH = 6, 2
SHAPES = {"w": (4, 3), "b": (3,)}


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("milestones,weight_decay", [([1], 1e-3), ([1, 2], 0.0), ([], 1e-2)])
def test_optimizer_matches_optax(kind, milestones, weight_decay):
    rng = np.random.default_rng(0)
    init = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    lr = 1e-2

    tx = jax_make_optimizer(kind, lr, weight_decay, milestones, STEPS_PER_EPOCH)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_optimizer(kind, params.values(), lr, weight_decay, milestones, STEPS_PER_EPOCH)
    for g in grads:
        opt.zero_grad()
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    assert opt.count == STEPS
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6)


def test_multistep_switches_at_the_boundary_inclusive():
    milestones, spe = [1, 3], 4
    ours = multistep_lr(0.5, milestones, spe)
    theirs = jax_multistep_lr(0.5, milestones, spe)
    for step in range(16):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6), step
    assert ours(3) == 0.5 and ours(4) == pytest.approx(0.05) and ours(12) == pytest.approx(5e-3)


def test_state_dict_round_trip():
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer("sgd", [p], 0.1, 0.0, [1], 1)
    p.grad = torch.ones(3)
    opt.step()
    state = copy.deepcopy(opt.state_dict())  # a loaded file shares no buffers
    q = torch.nn.Parameter(p.detach().clone())
    other = make_optimizer("sgd", [q], 0.1, 0.0, [1], 1)
    other.load_state_dict(state)
    assert other.count == 1
    p.grad = q.grad = torch.ones(3)
    opt.step()
    other.step()
    assert torch.equal(p, q)
    with pytest.raises(ValueError):
        make_optimizer("lamb", [p], 0.1, 0.0, [], 1)
