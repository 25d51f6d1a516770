"""The comparisons that decide ``correct``, against the plain reference
(``portbench/reference``), run once the window has closed and the
program's state is freed. The reference regenerates the weights and takes
the images from the seed; of the program it takes only what it judges and
the random choices of the timed steps (the plan rows and the augmentation
draws), as a served model's sampled tokens would be taken.

Training (the first ``STEPS`` steps of the class-seed, which the window's
own runner drove):

* ``loss_gap``: the largest gap between a step's loss and the reference's,
  over the reference's;
* ``grad_gap``: by the worst leaf, the gap between the norm of the first
  gradient as the optimizer received it (worked out from its state after
  one step) and the reference's, over the larger of the reference leaf's
  norm and the median leaf's;
* ``update_gap``: the same for the parameters' change over the steps, read
  before the next step overwrites them;
* ``score_gap``: the largest gap between a real slot's anomaly score, as the
  step's forward pass gave it, and the reference's.

``_first`` is a number of the first step alone, ``_median`` by the median
leaf instead of the worst.

Steps of the window itself (``window_``): the reference cannot follow the
program over hundreds of steps, so it takes the program's parameters and
optimizer moments before each window step the run recorded and makes that
one step: ``window_loss_gap``, ``window_score_gap`` and ``window_grad_gap``
(``_median``) as above, the gradient being what the optimizer received in
that step, worked out from its moments before and after it. The first
steps check the start this skips.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of the gradient and change numbers (the rule is by the
gradient, not by name).

Where the objective has a centre that the program derives in its set-up
(CLIP's prompt centre), ``centre_gap`` compares it with the reference's
(the largest distance between a row and the reference's, the rows being
unit vectors), and the reference's steps take the program's centre: with
random weights the prompts' features lie close together (cosine 0.91-0.97),
so the loss's gradient follows their difference, in which the centre's
rounding is magnified several times over; the steps are checked apart from
it.

Serving: ``score_gap``, the largest gap between a served score and the
reference's, over a sample of the requests the window answered, drawn from
the seed with the largest among them.
"""

import math
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.harness import weights as wgen
from portbench.harness.common import family_module, seed_of
from portbench.reference import augment
from portbench.reference.precision import Precision
from portbench.reference.train import Optimizer, run_steps

SAMPLE = 6   # purpose of the run seed: the served requests compared
TINY_GRADIENT = 1e-3


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in d.items()}


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              keep) -> Dict[str, float]:
    ref = _norms({n: reference[n] for n in keep})
    got = _norms({n: program[n] for n in keep})
    med = float(np.median(list(ref.values())))
    return {n: abs(got[n] - ref[n]) / max(ref[n], med, 1e-30) for n in keep}


def _verdict(values: Dict[str, float], limits: Dict[str, float],
             keep: Optional[dict] = None) -> Dict[str, dict]:
    """The numbers the cell compares (those it gives a limit), each beside
    its limit; every number goes to standard error as a reading."""
    print("readings: " + ", ".join(f"{k} {v!r}" for k, v in values.items()), file=sys.stderr)
    if keep is not None:
        keep["readings"] = values
    return {k: {"value": values[k], "limit": v} for k, v in limits.items()}


def correct(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def _batch(inputs: dict, plan: torch.Tensor, draws_n, draws_o, device) -> dict:
    """A step's batch: ``plan`` (3, batch) normal positions, OE positions,
    weights."""
    i_n, i_o, w = plan
    return {"xn": torch.from_numpy(inputs["xn"][i_n.numpy()]).to(device),
            "xo": torch.from_numpy(inputs["xo"][i_o.numpy()]).to(device),
            "ln": torch.zeros(len(i_n), dtype=torch.long, device=device),
            "lo": torch.ones(len(i_o), dtype=torch.long, device=device),
            "w": w.float().to(device), "draws_n": draws_n, "draws_o": draws_o}


def _stacks(tr: dict) -> dict:
    return {"specs": tr["specs"], "guard_n": tr["guard"]["normal"], "guard_o": tr["guard"]["oe"]}


def reference_training(cfg: dict, inputs: dict, program: dict, seed: int, device,
                       precision: str = "fp32", fault=None, optimizer=Optimizer) -> dict:
    """The reference's (or a control's) steps on the program's plan rows and
    draws: {"losses", "scores", "first_gradient", "params0", "params",
    "centre"}. ``fault`` and ``optimizer`` plant a fault in the reference."""
    fam = family_module(cfg["family"])
    tr = cfg["train"]
    P = Precision(precision)
    with P.flags():
        params = wgen.make(fam.reference.param_specs(cfg), seed, device)
        parts = fam.reference_parts(cfg, params, inputs, tr["dataset"], P)
        params0 = {n: t.clone() for n, t in params.items() if parts["trainable"](n)}
        batches = [_batch(inputs, plan, program["draws"]["normal"][k],
                          program["draws"]["oe"][k], device)
                   for k, plan in enumerate(program["plans"])]
        if fault is not None:
            batches = [fault(b) for b in batches]
        centre = program.get("centre")
        out = run_steps(parts["forward"], parts["loss_terms"], parts["score"], params,
                        parts["trainable"], batches, _stacks(tr),
                        optimizer(tr["optimizer"], tr["lr"], tr["weight_decay"]),
                        parts["centre"] if centre is None else centre.to(device),
                        parts["row_block"], parts["stats"])
    return {"losses": out["losses"], "scores": out["scores"],
            "first_gradient": out["first_gradient"],
            "params0": params0, "params": {n: params[n] for n in params0},
            "centre": parts["centre"]}


def window_reference(cfg: dict, inputs: dict, program: dict, seed: int, device,
                     precision: str = "fp32", fault=None) -> List[dict]:
    """The reference's (or a control's) step from the program's state
    before each recorded window step, on its plan row and draws, with the
    program's centre: {"loss", "scores", "gradient"} a step."""
    fam = family_module(cfg["family"])
    tr = cfg["train"]
    P = Precision(precision)
    out = []
    with P.flags():
        base = wgen.make(fam.reference.param_specs(cfg), seed, device)
        parts = fam.reference_parts(cfg, base, inputs, tr["dataset"], P)
        centre = program.get("centre")
        centre = parts["centre"] if centre is None else centre.to(device)
        for w in program["window"]:
            params = {**base, **{n: t.to(device).float().clone() for n, t in w["params"].items()}}
            batch = _batch(inputs, w["plan"], w["draws"]["normal"], w["draws"]["oe"], device)
            if fault is not None:
                batch = fault(batch)
            got = run_steps(parts["forward"], parts["loss_terms"], parts["score"], params,
                            parts["trainable"], [batch], _stacks(tr),
                            Optimizer(tr["optimizer"], tr["lr"], tr["weight_decay"]), centre,
                            parts["row_block"], parts["stats"])
            out.append({"loss": got["losses"][0], "scores": got["scores"][0],
                        "gradient": got["first_gradient"]})
            del params
    return out


def outputs(rows: torch.Tensor) -> tuple:
    """(scores, weights) of a step's output rows [loss share, scores,
    labels, weights], each (..., halves x rows) of this process's rows."""
    n = (rows.shape[-1] - 1) // 3
    return rows[..., 1:1 + n], rows[..., 1 + 2 * n:1 + 3 * n]


def _score_gap(got, ref, weights) -> float:
    """The largest gap over real slots; ``got`` may hold the first rows of
    each half alone (a rank's), ``ref`` holds every row."""
    got, ref, w = _numpy(got), _numpy(ref), np.asarray(_numpy(weights))
    ref = ref.reshape(2, -1)[:, :len(got) // 2].reshape(-1)
    return float(np.abs(got - ref)[w > 0].max())


def _kept(gradient: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(gradient)
    med = float(np.median(list(norms.values())))
    return [n for n, v in norms.items() if v >= TINY_GRADIENT * med]


def training_numbers(program: dict, ref: dict) -> Dict[str, float]:
    """``program``: {"losses", "scores", "weights", "first_gradient",
    "params", "centre"} of the program or of a control in its place."""
    keep = _kept(ref["first_gradient"])
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(program["losses"], ref["losses"])]
    delta_ref = {n: ref["params"][n] - ref["params0"][n] for n in keep}
    delta_got = {n: program["params"][n].to(ref["params0"][n].device) - ref["params0"][n]
                 for n in keep}
    score_gaps = [_score_gap(p, r, w)
                  for p, r, w in zip(program["scores"], ref["scores"], program["weights"])]
    grads = leaf_gaps(program["first_gradient"], ref["first_gradient"], keep)
    updates = leaf_gaps(delta_got, delta_ref, keep)
    out = {"loss_gap": max(losses), "loss_gap_first": losses[0],
           "score_gap": max(score_gaps), "score_gap_first": score_gaps[0],
           "grad_gap": max(grads.values()),
           "grad_gap_median": float(np.median(list(grads.values()))),
           "update_gap": max(updates.values()),
           "update_gap_median": float(np.median(list(updates.values())))}
    if ref.get("centre") is not None and program.get("centre") is not None:
        out["centre_gap"] = float((program["centre"].to(ref["centre"].device).float()
                                   - ref["centre"]).norm(dim=-1).max())
    print("worst leaves: gradient " + ", ".join(sorted(grads, key=grads.get)[-3:])
          + "; change " + ", ".join(sorted(updates, key=updates.get)[-3:]), file=sys.stderr)
    return out


def window_numbers(got: List[dict], ref: List[dict]) -> Dict[str, float]:
    """``got``: {"loss", "scores", "weights", "gradient"} of each window
    step, the program's or a control's; ``ref`` the reference's."""
    nan = float("nan")
    out = {"window_steps": float(len(ref)), "window_loss_gap": nan, "window_score_gap": nan,
           "window_grad_gap": nan, "window_grad_gap_median": nan}
    for g, r in zip(got, ref):
        keep = _kept(r["gradient"])
        grads = leaf_gaps(g["gradient"], r["gradient"], keep)
        now = {"window_loss_gap": abs(g["loss"] - r["loss"]) / max(abs(r["loss"]), 1e-30),
               "window_score_gap": _score_gap(g["scores"], r["scores"], g["weights"]),
               "window_grad_gap": max(grads.values()),
               "window_grad_gap_median": float(np.median(list(grads.values())))}
        for k, v in now.items():
            out[k] = v if math.isnan(out[k]) else max(out[k], v)
    return out


def program_window(program: dict) -> List[dict]:
    """The program's window steps in ``window_numbers``' form."""
    got = []
    for w in program["window"]:
        scores, weights = outputs(w["outputs"])
        got.append({"loss": w["loss"], "scores": scores, "weights": weights,
                    "gradient": w["gradient"]})
    return got


def training(cell: dict, cfg: dict, inputs: dict, program: dict, seed: int, device,
             keep: Optional[dict] = None) -> dict:
    ref = reference_training(cfg, inputs, program, seed, device)
    scores, weights = outputs(program["outputs"])
    values = training_numbers({**program, "scores": scores, "weights": weights}, ref)
    del ref
    values.update(window_numbers(program_window(program),
                                 window_reference(cfg, inputs, program, seed, device)))
    return _verdict(values, cell["limits"], keep)


def sample_requests(served: List[tuple], seed: int, images: int) -> List[int]:
    """Indices of served requests to compare: the largest, then others drawn
    from the seed until ``images`` images are in."""
    if not served:
        return []
    rng = np.random.default_rng(seed_of(seed, SAMPLE))
    order = [int(np.argmax([r[1] for r in served]))]
    rest = [i for i in rng.permutation(len(served)) if i != order[0]]
    total = served[order[0]][1]
    for i in rest:
        if total >= images:
            break
        order.append(int(i))
        total += served[i][1]
    return order


def reference_scores(cfg: dict, pool: np.ndarray, requests: List[tuple], cls: int, seed: int,
                     device, precision: str = "fp32") -> List[np.ndarray]:
    """The reference's (or a control's) scores of ``requests`` (offset, n)."""
    fam = family_module(cfg["family"])
    sv = cfg["serve"]
    P = Precision(precision)
    out = []
    with P.flags(), torch.no_grad():
        params = wgen.make(fam.reference.param_specs(cfg), seed, device)
        parts = fam.reference_parts(cfg, params, {"cls": cls}, sv["dataset"], P)
        for off, n in requests:
            x = torch.from_numpy(pool[off:off + n]).to(device)
            scores = []
            for i in range(0, n, sv["batch_size"]):
                xb = augment.apply(x[i:i + sv["batch_size"]], sv["specs"], [])
                scores.append(parts["score"](parts["forward"](params, xb), parts["centre"]))
            out.append(torch.cat(scores).cpu().numpy())
    return out


def serving(cell: dict, cfg: dict, pool: np.ndarray, served: List[tuple], cls: int, seed: int,
            device, keep: Optional[dict] = None) -> dict:
    """``served``: (offset, n, scores) of every request the window answered."""
    pick = sample_requests(served, seed, cell["check_images"])
    ref = reference_scores(cfg, pool, [served[i][:2] for i in pick], cls, seed, device)
    gap = max((float(np.max(np.abs(served[i][2] - r))) for i, r in zip(pick, ref)),
              default=float("nan"))
    return _verdict({"score_gap": gap}, cell["limits"], keep)
