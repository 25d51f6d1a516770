#!/usr/bin/env python3
"""Data-parallel scaling of a runner's training step over the cards of one
host: the same runner through ``main(["-d", N, ...])`` on one card and on N,
each rank taking ``--per-rank`` + ``--per-rank`` images a step (the global
batch grows with N), on the synthetic data of ``EOE_TPU_FAKE_DATA=1``.

    python3 dp_scaling.py --ranks 4                      # CLIP ViT-B/32 bf16, one host
    python3 dp_scaling.py --ranks 4 --ways eager,graph   # the step both ways
    python3 dp_scaling.py --ranks 4 --runner train_cifar --device cpu --steps 3

``--ways`` runs each way in turn, on one card and on N: ``eager`` (the
per-step loop, ``Trainer._per_step``; the default) and ``graph`` (the
resident epoch: each step replayed from a captured CUDA graph, NCCL's
collectives inside it). Each epoch is one step. Rank 0 times every step
between two synchronisations of its card: an eager step in
``Trainer.train_step``, replayed ones in ``ResidentSteps.run`` (an epoch's
over its steps; the first epoch's eager step and the second's capture left
out). The median of the
timed steps after the first is printed for each way and N with img/s
(global images over rank 0's step), the collectives' backend, the per-step
losses, and the card's name and power limit. Graph against eager on N
cards splits a rank's step into host time (what the graph removes) and
the rest, collectives included; graph on N against graph on one card is
the collectives' cost and the wait for the slowest rank. The CLIP runner
reads an OpenAI-format ViT-B/32 checkpoint made here from seed 0. Imports
nothing of JAX or eoe_tpu.
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


def _rank(runner: str, argv: list, device, per_step: bool):
    """A rank of ``run`` that ``spawn_ranks`` started: the runner's ``main``
    on its group, on the way rank 0 takes."""
    import importlib

    from eoe_tpu_torch.training import Trainer
    Trainer._per_step = per_step
    importlib.import_module(f"eoe_tpu_torch.main.{runner}").main(argv, device=device)


def run(runner: str, n: int, per_rank: int, steps: int, root: str, device, way: str) -> dict:
    """One training run of ``runner`` on ``n`` ranks, ``way`` eager or
    graph; rank 0's step times. Ranks 1..n-1 are spawned here, as the
    runners' ``-d`` spawns them, so that they take rank 0's way."""
    import importlib

    import numpy as np
    import torch
    from eoe_tpu_torch.parallel import mesh as meshlib
    from eoe_tpu_torch.training import Trainer, graphs

    main = importlib.import_module(f"eoe_tpu_torch.main.{runner}").main
    step_ms, trainers = [], []
    train_step, train_run, replay = Trainer.train_step, Trainer.run, graphs.ResidentSteps.run

    def sync():
        if torch.cuda.is_available() and device != "cpu":
            torch.cuda.synchronize()

    def timed(fn, steps_of=lambda *args: 1):
        def call(self, *args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3 / steps_of(*args))
            return out
        return call

    def kept(self, *args, **kwargs):
        trainers.append(self)
        return train_run(self, *args, **kwargs)

    if way == "graph":   # the epochs of one step each: an eager step, a capture, replays
        graphs.ResidentSteps.run = timed(replay, lambda n: n)
    else:
        Trainer.train_step = timed(train_step)
    Trainer.run, Trainer._per_step = kept, way == "eager"
    argv = ["-d", str(n), "-b", str(per_rank * n), "-e", str(steps), "--classes", "0", "-it",
            "1", "--no-vmap-seeds", "--datapath", root, "--superdir", f"{way}{n}"]
    ranks = meshlib.spawn_ranks(_rank, (runner, argv, device, way == "eager"), n) \
        if n > 1 else None
    try:
        main(argv, device=device)
    except BaseException:
        for p in ranks.processes if ranks is not None else ():
            if p.is_alive():
                p.terminate()
        raise
    finally:
        Trainer.train_step, Trainer.run, graphs.ResidentSteps.run = train_step, train_run, replay
        Trainer._per_step = False
        meshlib.leave()   # with the ranks, which leave as they finish: NCCL's is collective
    while ranks is not None and not ranks.join():
        pass
    tr = trainers[-1]
    timed_steps = step_ms[2:] if way == "graph" else step_ms
    ms = float(np.median(timed_steps[1:] or timed_steps))
    return {"way": way, "ranks": n, "images_per_step": 2 * per_rank * n, "step_ms": ms,
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
    parser.add_argument("--ways", default="eager",
                        help="comma-separated: eager (the per-step loop) and/or graph (each "
                             "step replayed from a captured CUDA graph)")
    args = parser.parse_args()
    ways = args.ways.split(",")
    if set(ways) - {"eager", "graph"}:
        parser.error("--ways takes eager and graph")
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
        rows = {}
        for way in ways:
            for n in (1, args.ranks):
                rows[way, n] = run(args.runner, n, args.per_rank, args.steps, root,
                                   args.device, way)
                print(json.dumps({**rows[way, n], "card": where}), flush=True)
    for way in ways:
        one, many = rows[way, 1], rows[way, args.ranks]
        print(f"{args.runner} {way}: {one['images_per_step']} images a step on one "
              f"{'card' if args.device != 'cpu' else 'process'} {one['step_ms']:.2f} ms "
              f"({one['img_s']:.0f} img/s); {many['images_per_step']} on {args.ranks} ranks "
              f"{many['step_ms']:.2f} ms a step on rank 0 ({many['img_s']:.0f} img/s, "
              f"{many['img_s'] / one['img_s']:.2f}x; {many['mesh']}) [{where}]")


if __name__ == "__main__":
    main()
