#!/usr/bin/env python3
"""Data-parallel scaling of a runner's training step over the cards of one
host: the same runner through ``main(["-d", N, ...])`` on one card and on N,
each rank taking ``--per-rank`` + ``--per-rank`` images a step (the global
batch grows with N), on the synthetic data of ``EOE_TPU_FAKE_DATA=1``.

    python3 dp_scaling.py --ranks 4                      # CLIP ViT-B/32 bf16, one host
    python3 dp_scaling.py --ranks 4 --runner train_cifar --device cpu --steps 3

Rank 0 times every step between two synchronisations of its card; the
median of the steps after the first is printed for each N with img/s
(global images over rank 0's step), the collectives' backend, the per-step
losses, and the card's name and power limit. The CLIP runner reads an
OpenAI-format ViT-B/32 checkpoint made here from seed 0. Imports nothing of
JAX or eoe_tpu.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def run(runner: str, n: int, per_rank: int, steps: int, root: str, device) -> dict:
    """One training run of ``runner`` on ``n`` ranks; rank 0's step times."""
    import importlib

    import numpy as np
    import torch
    from eoe_tpu_torch.training import Trainer

    main = importlib.import_module(f"eoe_tpu_torch.main.{runner}").main
    step_ms, trainers = [], []
    train_step, train_run = Trainer.train_step, Trainer.run

    def sync():
        if torch.cuda.is_available() and device != "cpu":
            torch.cuda.synchronize()

    def timed(self, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = train_step(self, *args, **kwargs)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def kept(self, *args, **kwargs):
        trainers.append(self)
        return train_run(self, *args, **kwargs)

    Trainer.train_step, Trainer.run = timed, kept
    try:
        main(["-d", str(n), "-b", str(per_rank * n), "-e", str(steps), "--classes", "0",
              "-it", "1", "--no-vmap-seeds", "--datapath", root, "--superdir", f"d{n}"],
             device=device)
    finally:
        Trainer.train_step, Trainer.run = train_step, train_run
    tr = trainers[-1]
    ms = float(np.median(step_ms[1:] or step_ms))
    return {"ranks": n, "images_per_step": 2 * per_rank * n, "step_ms": ms,
            "img_s": 2 * per_rank * n / ms * 1e3, "steps_ms": step_ms,
            "losses": list(tr.step_losses),
            "mesh": tr.mesh.note if tr.mesh is not None else "one process"}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--runner", default="train_clip_cifar")
    parser.add_argument("--per-rank", type=int, default=128, help="images a rank, each half")
    parser.add_argument("--steps", type=int, default=6, help="epochs of one step each")
    parser.add_argument("--device", default=None, help="cuda unless given (cpu rehearses)")
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    if args.device is None and not torch.cuda.is_available():
        sys.exit("dp_scaling: no card (pass --device cpu to rehearse on the CPU)")
    os.environ["EOE_TPU_FAKE_DATA"] = "1"
    with tempfile.TemporaryDirectory() as root:
        if args.runner.startswith("train_clip"):
            from eoe_tpu_torch.models.clip import CLIP, VIT_B32, to_openai
            ckpt = os.path.join(root, "ViT-B-32.pt")
            torch.save(to_openai(CLIP(VIT_B32, generator=torch.Generator().manual_seed(0))
                                 .state_dict(), VIT_B32), ckpt)
            os.environ["EOE_TPU_CLIP_CHECKPOINT"] = ckpt
        where = card() if args.device != "cpu" else "cpu"
        rows = []
        for n in (1, args.ranks):
            rows.append(run(args.runner, n, args.per_rank, args.steps, root, args.device))
            print(json.dumps({**rows[-1], "card": where}), flush=True)
    one, many = rows
    print(f"{args.runner}: {one['images_per_step']} images a step on one "
          f"{'card' if args.device != 'cpu' else 'process'} {one['step_ms']:.2f} ms "
          f"({one['img_s']:.0f} img/s); {many['images_per_step']} on {args.ranks} ranks "
          f"{many['step_ms']:.2f} ms a step on rank 0 ({many['img_s']:.0f} img/s, "
          f"{many['img_s'] / one['img_s']:.2f}x; {many['mesh']}) [{where}]")


if __name__ == "__main__":
    main()
