"""Experiment orchestration of the port: the argument parsers, the trainer
factories, the multiscale sweep, the evolutionary search's setup and the
resume loaders of eoe_tpu/main, which the runners in this package share
(``python -m eoe_tpu_torch.main.<runner>``).

The flags, their defaults and the on-disk layout are the JAX package's: data
under ``<datapath>/datasets``, runs under ``<datapath>/results/<superdir>``,
a resumed run (``--load``) continued in ``<old run>---CNTD``, an evolution
run in ``<superdir>/log_<time>_evolve_<comment>`` (``--ev-continue-run``:
``<old run>---CNTD``). Two flags differ:
  * ``-d/--devices`` counts GPUs, one process each: ``data_parallel`` (every
    runner's ``main``) starts ranks 1..N-1 of ``-d N`` (default: every card;
    on the CPU, ``-d`` alone) running the same ``main(argv)``, and
    ``create_trainer`` gives the trainer the data mesh (``parallel.mesh``).
    Under ``EOE_TPU_DISTRIBUTED=1`` the processes are started by the user,
    one per GPU, and ``-d`` counts from the group's size. Only the process
    the user started writes a run directory; under ``EOE_TPU_DISTRIBUTED=1``
    each process writes its own, as the JAX package's do;
  * ``--compute-dtype`` maps ``float32`` / ``bfloat16`` to the torch dtypes
    and is written under the same names, so ``load_setup`` reads either
    package's setup.json.
``--vmap-seeds`` / ``--no-vmap-seeds`` (default: auto) reach ``Trainer.run``
and ``--ev-vmap`` trains the candidates of a generation as one program
(``evolve.vmapped``), as in the JAX package.
Snapshots are the port's ``.pt`` files. The runners and the functions below
take ``device`` as a keyword (``cuda`` unless the caller asks for another
one); it is not a flag. The evolutionary search keeps the JAX package's
``results.json`` history (the ``geneation_pool`` key included) and
``evolution.json`` tree, so either package resumes the other's run
(``--ev-continue-run``, ``load_evolve``).
"""

import functools
import json
import os
import os.path as pt
import sys
import time
from argparse import ArgumentParser, BooleanOptionalAction, Namespace
from copy import deepcopy
from itertools import product
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from eoe_tpu_torch.datasets import (DS_CHOICES, DS_PARTS, MSM, MSM_TRANSFORMS,
                                    TRAIN_NOMINAL_ID, TRAIN_OE_ID, no_classes)
from eoe_tpu_torch.datasets.bases import INF
from eoe_tpu_torch.evolve import (Individual, Toolbox, evaluate, evaluate_individual, evolve,
                                  init_individual, mate_individuals, mutate_individual,
                                  replace_individuals_randomly, seed_evolution,
                                  select_individual)
from eoe_tpu_torch.evolve.tree import EvolNode, Individual as TreeIndividual, Tree
from eoe_tpu_torch.ops.preprocess import specs_repr
from eoe_tpu_torch.parallel import mesh as meshlib
from eoe_tpu_torch.training import TRAINER, Trainer
from eoe_tpu_torch.utils.logger import Logger

AD_MODE_MAP = {"ovr": "one_vs_rest", "loo": "leave_one_out", "ff": "fifty_fifty"}
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def default_datapath() -> str:
    return os.environ.get("EOE_TPU_DATAPATH", pt.abspath(pt.join(os.getcwd(), "data")))


def default_argsparse(modify_descr: Callable[[str], str],
                      modify_parser: Callable[[ArgumentParser], None] = None,
                      modify_args: Callable[[Namespace], None] = None,
                      argv: Optional[List[str]] = None) -> Namespace:
    """The shared training CLI; ``argv`` replaces ``sys.argv[1:]``."""
    parser = ArgumentParser(
        description=modify_descr(
            "Iterates over a set of classes found in the dataset and multiple random "
            "seeds per class. For each class-seed combination, it trains and evaluates "
            "a given AD model and objective. Depending on the ad_mode, it either treats "
            "the current class or all but the current class as normal. It always "
            "evaluates using the full test set. "))
    parser.add_argument("-ds", "--dataset", type=str, default=None,
                        choices=tuple(DS_CHOICES.keys()),
                        help="The dataset for which to train the AD model.")
    parser.add_argument("-oe", "--oe-dataset", type=str, default=None,
                        choices=tuple(DS_CHOICES.keys()) + ("none",),
                        help="Optional Outlier Exposure dataset; concatenates an equally "
                             "sized batch of its samples as auxiliary anomalies.")
    parser.add_argument("--oe-size", type=int, default=INF,
                        help="Use a random subset of the OE dataset with this size.")
    parser.add_argument("-b", "--batch-size", type=int, default=200,
                        help="Batch size (doubled when an OE dataset is present).")
    parser.add_argument("-e", "--epochs", type=int, default=50)
    parser.add_argument("-lr", "--learning-rate", type=float, default=1e-3)
    parser.add_argument("-wdk", "--weight-decay", type=float, default=1e-4)
    parser.add_argument("--milestones", type=int, nargs="+", default=[],
                        help="LR-scheduler milestones; each reduces the LR by 0.1.")
    parser.add_argument("-o", "--objective", type=str, default="hsc",
                        choices=tuple(TRAINER.keys()))
    parser.add_argument("--ad-mode", type=str, default="ovr", choices=("ovr", "loo", "ff"),
                        help="one-vs-rest, leave-one-class-out, or fifty-fifty benchmark mode.")
    parser.add_argument("--classes", type=int, nargs="+", default=None,
                        help="Class ids to iterate over; defaults to all.")
    parser.add_argument("-d", "--devices", type=int, metavar="N-GPUS", default=None,
                        help="Number of GPUs to train data-parallel on, one process each. "
                             "Defaults to every GPU (under EOE_TPU_DISTRIBUTED=1, every "
                             "process of the group); at most as many as there are; 1 "
                             "trains on one.")
    parser.add_argument("-it", "--iterations", type=int, default=2,
                        help="Random seeds per class.")
    parser.add_argument("--load", type=str, metavar="FILE-PATH", default=None,
                        help="Path to a previous run's logging directory; loads config + "
                             "snapshots, re-evaluates completed class-seed combos, and "
                             "continues into {old_dir}---CNTD.")
    parser.add_argument("--comment", type=str, default="")
    parser.add_argument("--superdir", type=str, default=".")
    parser.add_argument("--compute-dtype", type=str, default=None,
                        choices=tuple(COMPUTE_DTYPES),
                        help="Matmul/conv compute precision on the card. Defaults to "
                             "bfloat16 for the CLIP objective and float32 otherwise.")
    parser.add_argument("--datapath", type=str, default=None,
                        help="Data root (default: $EOE_TPU_DATAPATH or ./data).")
    parser.add_argument("--vmap-seeds", action=BooleanOptionalAction, default=None,
                        help="Train all seeds of a class as one vmapped program on "
                             "resident data. Default: on for several seeds trained from "
                             "scratch without --load, CLIP excepted; --no-vmap-seeds "
                             "trains them one after another.")
    if modify_parser is not None:
        modify_parser(parser)
    args = parser.parse_args(argv)
    if args.oe_dataset == "none":
        args.oe_dataset = None
    args.ad_mode = AD_MODE_MAP[args.ad_mode]
    if modify_args is not None:
        modify_args(args)
    return args


def ms_argsparse(modify_descr, modify_parser=None, modify_args=None, argv=None):
    """``default_argsparse`` with --ms-mode TRANSFORM+DSPART and --magnitude."""

    def combined_parser(parser):
        parser.add_argument(
            "--ms-mode", type=str, default=(), nargs="+",
            choices=["+".join((i, j)) for i, j in product(MSM_TRANSFORMS, DS_PARTS.keys())],
            help="Multi-scale modes TRANSFORM+DSPART, e.g. lpf+train_nominal.")
        parser.add_argument("--magnitude", type=int, default=14,
                            help="Magnitude applied to all MSMs.")
        if modify_parser is not None:
            modify_parser(parser)

    def combined_args(args):
        args.ms_mode = [MSM(m.split("+")[0], m.split("+")[1], args.magnitude)
                        for m in args.ms_mode]
        if modify_args is not None:
            modify_args(args)

    return default_argsparse(modify_descr, combined_parser, combined_args, argv)


def evolve_argsparse(modify_descr, modify_parser=None, modify_args=None, argv=None):
    """``ms_argsparse`` with the ``--ev-*`` flags of the evolutionary search."""

    def evolve_descr(s):
        s += ("Repeats this complete procedure with different fixed Outlier Exposure "
              "(OE) subsets chosen by an evolutionary algorithm optimizing mean AUC. ")
        return modify_descr(s) if modify_descr is not None else s

    def evolve_parser(parser):
        parser.add_argument("--ev-oesize", type=int, default=1)
        parser.add_argument("--ev-generation-pool", type=int, default=16)
        parser.add_argument("--ev-mutation-pool", type=int, default=100)
        parser.add_argument("--ev-mutation-indp", type=float, default=1.0)
        parser.add_argument("--ev-mutation-oneofkbest", type=int, default=3)
        parser.add_argument("--ev-mutation-chance", type=float, default=0.5)
        parser.add_argument("--ev-mate-chance", type=float, default=0.2)
        parser.add_argument("--ev-generations", type=int, default=30)
        parser.add_argument("--ev-select-toursize", type=int, default=3)
        parser.add_argument("--ev-minimize-fitness", action="store_true")
        parser.add_argument("--ev-seed", type=int, default=0,
                            help="Seed for all stochastic GA decisions (init, "
                                 "mutation, mating, selection). Same-seed runs "
                                 "reproduce byte-identically; each generation's "
                                 "stream derives from (seed, gen), so resumes "
                                 "replay the uninterrupted run.")
        parser.add_argument("--ev-vmap", action="store_true",
                            help="Train the candidates of a generation as one vmapped "
                                 "program (chunks of 16), all from one init per seed. "
                                 "Without it the candidates train one after another.")
        parser.add_argument("--ev-continue-run", type=str, default=None)
        if modify_parser is not None:
            modify_parser(parser)

    def evolve_args(args):
        if args.load is not None:
            raise ValueError("For the evolutionary algorithm, `--load` has no impact. "
                             "Use `--ev-continue-run` instead.")
        if args.oe_size != INF:
            raise ValueError("For the evolutionary algorithm, `--oe-size` has no impact. "
                             "Use `--ev-oesize` instead.")
        if modify_args is not None:
            modify_args(args)

    return ms_argsparse(evolve_descr, evolve_parser, evolve_args, argv)


def _spawn_count(argv: List[str], device) -> int:
    """How many ranks ``-d`` in ``argv`` asks this command to start: none
    under EOE_TPU_DISTRIBUTED=1, inside a group or for ``--help``."""
    if os.environ.get("EOE_TPU_DISTRIBUTED", "0") == "1" or dist.is_initialized() \
            or "-h" in argv or "--help" in argv:
        return 1
    pre = ArgumentParser(add_help=False)
    pre.add_argument("-d", "--devices", type=int, default=None)
    pre.add_argument("-ds")   # so that "-ds x" is not read as "-d s"
    devices = pre.parse_known_args(argv)[0].devices
    on_card = torch.device("cuda" if device is None else device).type == "cuda"
    return meshlib.data_size(devices, torch.cuda.device_count() if on_card else devices or 1)


def data_parallel(main: Callable) -> Callable:
    """A runner's ``main(argv=None, device=None)`` on the ranks of ``-d N``:
    for N above 1 it spawns ranks 1..N-1 (``parallel.mesh.spawn_ranks``)
    that run the same ``main(argv)`` and do not write, runs rank 0 itself,
    leaves the group when the ranks do and joins them; a rank that fails
    fails the command and stops the others."""
    @functools.wraps(main)
    def run(argv: Optional[List[str]] = None, device=None):
        argv = list(sys.argv[1:] if argv is None else argv)
        n = _spawn_count(argv, device)
        if n <= 1:
            return main(argv, device=device)
        ranks = meshlib.spawn_ranks(run, (argv, device), n)
        try:
            out = main(argv, device=device)
        except BaseException:
            for p in ranks.processes:
                if p.is_alive():
                    p.terminate()
            meshlib.leave()
            raise
        meshlib.leave()   # with the ranks, which leave as they finish: NCCL's is collective
        while not ranks.join():
            pass
        return out
    return run


def _make_mesh(devices: Optional[int], device=None) -> Optional[meshlib.Mesh]:
    """The data mesh of ``-d devices``, as the JAX package's ``_make_mesh``:
    its devices are the ranks of the process group (``EOE_TPU_DISTRIBUTED=1``
    or ``data_parallel``'s), every one by default; 1 or less, and one
    process, mean no mesh. A ``-d`` below the group's size raises: every
    rank trains."""
    meshlib.init_distributed()   # a no-op unless EOE_TPU_DISTRIBUTED=1
    if not dist.is_initialized():
        return None
    world = dist.get_world_size()
    n = meshlib.data_size(devices, world)
    if n <= 1:
        return None
    if n != world:
        raise ValueError(f"--devices {devices}: the process group has {world} ranks, and "
                         f"every rank trains")
    return meshlib.make_mesh(meshlib.MeshConfig(data=n, model=1), device)


def create_trainer(trainer: str, comment: str, dataset: str, oe_dataset: Optional[str],
                   epochs: int, lr: float, wdk: float, milestones: List[int],
                   batch_size: int, ad_mode: str, devices: Optional[int], model,
                   train_specs: Sequence, test_specs: Sequence,
                   oe_limit_samples: Union[int, List[int]] = INF,
                   oe_limit_classes: Union[int, float] = INF,
                   msm: Sequence[MSM] = (), logpath: str = None, device=None,
                   **kwargs) -> Trainer:
    """The trainer and its logger: a new run directory under
    ``<dataset_path>/results/<superdir>`` (or ``logpath``), or with
    ``continue_run`` the directory ``<continue_run>---CNTD``. The data lie
    under ``<dataset_path>/datasets``; for the custom dataset its classes are
    read from its train folders into ``DS_CHOICES["custom"]`` (its split-less
    layouts lie directly under ``<dataset_path>``). ``devices`` gives the
    trainer its data mesh (``_make_mesh``)."""
    mesh = _make_mesh(devices, device)
    dtype_name = kwargs.pop("compute_dtype", None) or (
        "bfloat16" if trainer == "clip" else "float32")
    datapath = kwargs.pop("dataset_path", None) or default_datapath()
    superdir = kwargs.pop("superdir", ".")
    continue_run = kwargs.pop("continue_run", None)
    if continue_run is None:
        logger = Logger(pt.join(datapath, "results", superdir) if logpath is None
                        else logpath, comment, active=meshlib.writes())
    else:
        logger = Logger(continue_run + "---CNTD", noname=True, active=meshlib.writes())
    if dataset == "custom" or oe_dataset == "custom":
        from eoe_tpu_torch.datasets.custom import ADCustomDS
        if not (ADCustomDS.train_only or ADCustomDS.eval_only):
            datapath = pt.join(datapath, "datasets")
        classes = ADCustomDS.determine_classes(datapath)
        DS_CHOICES["custom"]["str_labels"] = classes
        DS_CHOICES["custom"]["no_classes"] = len(classes)
    else:
        datapath = pt.join(datapath, "datasets")
    return TRAINER[trainer](
        model=model, train_specs=train_specs, test_specs=test_specs, dataset=dataset,
        oe_dataset=oe_dataset, datapath=datapath, logger=logger,
        epochs=epochs, lr=lr, wdk=wdk, milestones=milestones, batch_size=batch_size,
        ad_mode=ad_mode, oe_limit_samples=oe_limit_samples,
        oe_limit_classes=oe_limit_classes, msms=msm,
        compute_dtype=COMPUTE_DTYPES[dtype_name], device=device, mesh=mesh, **kwargs)


def evolve_trainer(trainer: str, comment: str, dataset: str, oe_dataset: Optional[str],
                   epochs: int, lr: float, wdk: float, milestones: List[int],
                   batch_size: int, ad_mode: str, devices: Optional[int], model,
                   train_specs: Sequence, test_specs: Sequence,
                   oe_limit_samples: Union[int, List[int]] = INF,
                   oe_limit_classes: Union[int, float] = INF,
                   msms: Sequence[MSM] = (), evolve_tag: str = "", logpath: str = None,
                   classes: Optional[List[int]] = None, device=None, **kwargs):
    """A trainer with the dataset of one class pinned (``trainer.ds``), its OE
    train split (the individuals' pool), and the outer logger of the
    evolution run ``<superdir>/log_<time>_evolve_<evolve_tag>`` (or
    ``<continue_run>---CNTD``); each individual's runs log inside it."""
    from eoe_tpu_torch.datasets import load_dataset

    evolve_dir = pt.join(kwargs.pop("superdir", "."),
                         f"log_{time.strftime('%Y%m%d%H%M%S')}_evolve_{evolve_tag}")
    continue_run = kwargs.pop("continue_run", None)
    if continue_run is not None:
        evolve_dir = continue_run + "---CNTD"
    trainer_obj = create_trainer(
        trainer, comment, dataset, oe_dataset, epochs, lr, wdk, milestones, batch_size,
        ad_mode, devices, model, train_specs, test_specs, oe_limit_samples,
        oe_limit_classes, msms, logpath, device=device, superdir=evolve_dir,
        continue_run=None, **kwargs)
    if classes is None or len(classes) != 1:
        raise NotImplementedError(
            "Evolve for multiple classes at once does not work: individuals pin "
            "trainer.ds.oe.train_set.indices, which a per-class dataset rebuild would "
            "discard.")
    trainer_obj.ds = load_dataset(
        trainer_obj.dsstr, trainer_obj.datapath, trainer_obj.get_nominal_classes(classes[0]),
        0, trainer_obj.train_specs, trainer_obj.test_specs, trainer_obj.logger,
        trainer_obj.oe_dsstr, trainer_obj.oe_limit_samples, trainer_obj.oe_limit_classes,
        trainer_obj.msms)
    oeds = trainer_obj.ds.oe.train_set
    outer_logger = Logger(pt.join(trainer_obj.logger.dir, ".."), noname=True,
                          active=meshlib.writes())
    return trainer_obj, oeds, outer_logger


def _make_history(**setup) -> dict:
    return {"pop": [], "fit": [], "mean_fit": [], "std_fit": [], "max_fit": [],
            "min_fit": [], "setup": setup}


def _toolbox(trainer: Trainer, oeds, args: Namespace, mutation_pool: int, mutation_indp: float,
             mutation_oneofkbest: int, select, select_kw: dict) -> Toolbox:
    toolbox = Toolbox()
    toolbox.register("evaluate", evaluate_individual, trainer=trainer, args=args,
                     toolbox=toolbox)
    for name, fn in (("mate", mate_individuals), ("mutate", mutate_individual)):
        toolbox.register(name, fn, oeds=oeds, poolsize=mutation_pool, indp=mutation_indp,
                         oneofkbest=mutation_oneofkbest, device=trainer.device)
    toolbox.register("select", select, **select_kw)
    return toolbox


def _first_population(oeds, oesize: int, generation_pool: int, maxfit: bool) -> tuple:
    weight = 1.0 if maxfit else -1.0
    pop = [Individual([init_individual(oeds) for _ in range(oesize)], weight)
           for _ in range(generation_pool)]
    return pop, Tree(*[EvolNode(TreeIndividual(list(ind))) for ind in pop])


def evolve_setup(oesize: int, generation_pool: int, mutation_pool: int,
                 mutation_indp: float, mutation_oneofkbest: int, mutation_chance: float,
                 mate_chance: float, generations: int, select_toursize: int,
                 trainer: Trainer, oeds, args: Namespace, maxfit: bool = True,
                 vmap_candidates: bool = False, seed: Optional[int] = None):
    """The GA's toolbox, history and first population (generation 0) with its
    tree. ``seed`` seeds every stochastic decision and is recorded in the
    history's setup, whose keys (the JAX package's ``geneation_pool`` typo
    included) a resume checks. ``vmap_candidates`` registers
    ``VmappedEvaluator.evaluate_population``: a generation's candidates
    train as one program."""
    if seed is not None:
        seed_evolution(seed)
    history = _make_history(
        oesize=oesize, geneation_pool=generation_pool, mutation_pool=mutation_pool,
        mutation_indp=mutation_indp, mutation_oneofkbest=mutation_oneofkbest,
        mutation_chance=mutation_chance, mate_chance=mate_chance,
        generations=generations, oeds=trainer.oe_dsstr, select_toursize=select_toursize,
        ev_seed=seed)
    toolbox = _toolbox(trainer, oeds, args, mutation_pool, mutation_indp, mutation_oneofkbest,
                       select_individual, {"tournsize": select_toursize})
    if vmap_candidates:
        from eoe_tpu_torch.evolve.vmapped import VmappedEvaluator
        toolbox.register("evaluate_population", VmappedEvaluator(trainer, args).evaluate_population)
    pop, tree = _first_population(oeds, oesize, generation_pool, maxfit)
    return pop, 0, toolbox, history, tree


def rand_pick_setup(oesize: int, generation_pool: int, trainer: Trainer, oeds,
                    args: Namespace, maxfit: bool = True, seed: Optional[int] = None):
    """The random-search baseline: ``generation_pool`` random subsets, no
    mating or mutation."""
    if seed is not None:
        seed_evolution(seed)
    history = _make_history(oesize=oesize, ev_seed=seed)
    toolbox = _toolbox(trainer, oeds, args, 0, 0.0, 0, replace_individuals_randomly,
                       {"oeds": oeds})
    pop, tree = _first_population(oeds, oesize, generation_pool, maxfit)
    return pop, 0, toolbox, history, tree


def evolve_experiment(descr: str, defaults: dict, train_specs, test_specs, build_model,
                      argv=None, device=None):
    """The body of the evolve_oe_<dataset> runners: parse (``descr`` ends the
    description, ``defaults`` are the runner's), resume a run with
    ``--ev-continue-run``, evaluate generation 0 and evolve the rest; the
    history, the tree, the genealogy and the best/worst overviews are written
    however the loop ends. Returns (history, tree)."""
    def modify_parser(parser):
        parser.set_defaults(**defaults)

    args = evolve_argsparse(lambda s: f"{s} {descr}", modify_parser, argv=argv)
    args.comment = args.comment.format(
        obj=args.objective, admode=args.ad_mode,
        classes="+".join(str(c) for c in args.classes), its=args.iterations)
    if args.ev_continue_run is not None:
        dirs = [pt.join(args.ev_continue_run, f) for f in os.listdir(args.ev_continue_run)
                if pt.isdir(pt.join(args.ev_continue_run, f)) and f.startswith("log_")]
        if not dirs:
            raise ValueError(f"Could not find a training log directory in "
                             f"{args.ev_continue_run}.")
        load_setup(dirs[0], args, train_specs, test_specs)
    print("Program started with:\n", vars(args))
    trainer, ds, logger = evolve_trainer(
        args.objective, "", args.dataset, args.oe_dataset, args.epochs,
        args.learning_rate, args.weight_decay, args.milestones, args.batch_size,
        args.ad_mode, args.devices, build_model(args), train_specs, test_specs,
        evolve_tag=args.comment, classes=args.classes, msms=args.ms_mode,
        superdir=args.superdir, continue_run=args.ev_continue_run,
        dataset_path=args.datapath, device=device)
    pop, start_gen, toolbox, history, tree = evolve_setup(
        args.ev_oesize, args.ev_generation_pool, args.ev_mutation_pool,
        args.ev_mutation_indp, args.ev_mutation_oneofkbest, args.ev_mutation_chance,
        args.ev_mate_chance, args.ev_generations, args.ev_select_toursize, trainer, ds,
        args, not args.ev_minimize_fitness, vmap_candidates=args.ev_vmap,
        seed=args.ev_seed)
    if args.ev_continue_run is not None:
        history, pop, start_gen, logger, toolbox = load_evolve(
            args.ev_continue_run, tree, history, pop, start_gen, logger, trainer, ds,
            args, trainer.train_specs, trainer.test_specs)
    try:
        if start_gen == 0:
            evaluate(pop, pop, start_gen, toolbox, history, tree, ds, logger)
            start_gen += 1
        for gen in range(start_gen, args.ev_generations):
            evolve(pop, gen, toolbox, args.ev_mate_chance, args.ev_mutation_chance,
                   history, tree, ds, logger, seed=args.ev_seed)
    finally:
        _save_evolution(logger, history, tree, ds, args)
    return history, tree


def random_oe_experiment(descr: str, defaults: dict, train_specs, test_specs, build_model,
                         argv=None, device=None):
    """The body of the random_oe_<dataset> runners: ``--ev-samples`` random OE
    subsets of ``--ev-oesize`` images, each trained and evaluated once.
    Returns (history, tree)."""
    def modify_parser(parser):
        parser.add_argument("--ev-oesize", type=int, default=1,
                            help="The size of the OE subsets.")
        parser.add_argument("--ev-samples", type=int, default=2000,
                            help="The number of OE subsets that are randomly chosen.")
        parser.add_argument("--ev-seed", type=int, default=0,
                            help="Seed for the random subset draws (reproducible).")
        parser.set_defaults(**defaults)

    args = ms_argsparse(
        lambda s: f"{s} Repeats this complete procedure with different randomly chosen "
                  f"OE subsets. {descr}", modify_parser, argv=argv)
    if args.oe_size != INF:
        raise ValueError("For finding random OE subsets, `--oe-size` has no impact. "
                         "Use `--ev-oesize` instead.")
    args.comment = args.comment.format(
        obj=args.objective, admode=args.ad_mode, classes=args.classes,
        its=args.iterations)
    print("Program started with:\n", vars(args))
    trainer, ds, logger = evolve_trainer(
        args.objective, "", args.dataset, args.oe_dataset, args.epochs,
        args.learning_rate, args.weight_decay, args.milestones, args.batch_size,
        args.ad_mode, args.devices, build_model(args), train_specs, test_specs,
        evolve_tag=args.comment, classes=args.classes, msms=args.ms_mode,
        superdir=args.superdir, dataset_path=args.datapath, device=device)
    pop, start_gen, toolbox, history, tree = rand_pick_setup(
        args.ev_oesize, args.ev_samples, trainer, ds, args,
        not getattr(args, "ev_minimize_fitness", False), seed=args.ev_seed)
    try:
        evaluate(pop, pop, start_gen, toolbox, history, tree, ds, logger)
    finally:
        _save_evolution(logger, history, tree, ds, args)
    return history, tree


def _save_evolution(logger: Logger, history: dict, tree: Tree, oeds, args: Namespace):
    if not logger.active:
        return
    logger.logjson("results", history)
    tree.save(pt.join(logger.dir, "evolution"))
    tree.render(pt.join(logger.dir, "genealogy.png"), oeds=oeds)
    tree.imsave_collection_best(logger, args.ms_mode, oeds=oeds)
    logger.flush_scalars()
    logger.drain()   # the background writes are on disk before the runner returns


def multiscale_experiment(args: Namespace, model, train_specs, test_specs,
                          magnitudes: Sequence[int] = (0, 1, 2, 4, 8, 16, 32), device=None,
                          **kwargs):
    """One full training per MSM magnitude, each in a run directory
    ``magnitude_<m>`` inside one outer run. When every MSM touches only test
    parts, the magnitudes other than 0 evaluate the magnitude-0 snapshots
    with ``epochs=0``. Returns [(mean AUC, std AUC)] per magnitude."""
    aucs = []
    superdir = kwargs.pop("superdir", ".")
    continue_run = kwargs.pop("continue_run", [])
    continue_last_magnitude = kwargs.pop("continue_last_magnitude", (None, None))
    plot_elsewhere = kwargs.pop("plot_elsewhere", None)
    datapath = kwargs.pop("dataset_path", None) or default_datapath()

    if len(continue_run) == 0:
        logger = Logger(pt.join(datapath, "results", superdir), args.comment,
                        active=meshlib.writes())
    else:
        logger = Logger(args.continue_run if plot_elsewhere is None else plot_elsewhere,
                        noname=True, active=meshlib.writes())
    magn0_snapshots = None
    test_only_msms = all(m.ds_part not in (TRAIN_NOMINAL_ID, TRAIN_OE_ID)
                         for m in args.ms_mode)
    for i, magnitude in enumerate(magnitudes):
        if len(continue_run) > i:
            aucs.append(tuple(continue_run[i]))
            if test_only_msms:
                raise NotImplementedError(
                    "For test-only MSMs, the magnitude-0 models have to be loaded "
                    "from the snapshots!")
            continue
        trainer = create_trainer(
            args.objective, f"magnitude_{magnitude}", args.dataset, args.oe_dataset,
            args.epochs, args.learning_rate, args.weight_decay, args.milestones,
            args.batch_size, args.ad_mode, args.devices, model, train_specs, test_specs,
            msm=[m.set_magnitude(magnitude) for m in args.ms_mode], logpath=logger.dir,
            oe_limit_samples=args.oe_size, continue_run=continue_last_magnitude[1],
            dataset_path=datapath, device=device, **kwargs)
        if magnitude != 0 and test_only_msms:
            trainer.epochs = 0
            _, results = trainer.run(args.classes, args.iterations, magn0_snapshots)
        else:
            _, results = trainer.run(args.classes, args.iterations,
                                     continue_last_magnitude[0])
        continue_last_magnitude = (None, None)
        if magnitude == 0:
            classes = args.classes if args.classes is not None else \
                list(range(no_classes(args.dataset)))
            magn0_snapshots = [
                [trainer.logger.snapshot_path(f"snapshot_cls{c}_it{i}")
                 if c in classes else None for i in range(args.iterations)]
                for c in range(no_classes(args.dataset))]
        aucs.append((results["mean_auc"], results["std_auc"]))

    print(f"----------------- {args.ms_mode} OVERVIEW -----------------")
    for s, (a, std) in zip(magnitudes, aucs):
        print(f"{args.ms_mode} with magnitude={s:02d} yielded {a * 100:04.2f} "
              f"+- {std * 100:04.2f}.")
    logger.logjson("results", {
        "magnitudes": list(magnitudes), "aucs": [a for a, _ in aucs],
        "stds": [s for _, s in aucs], "classes": args.classes, "comment": args.comment,
        "ms_mode": [repr(m) for m in args.ms_mode], "dataset": args.dataset})
    return aucs


def run_default_training(args: Namespace, model, train_specs, test_specs, device=None):
    """The shared tail of every train_<dataset> runner: resume, build, run."""
    snapshots, continue_run = load_setup(args.load, args, train_specs, test_specs)
    print("Program started with:\n", vars(args))
    trainer = create_trainer(
        args.objective, args.comment, args.dataset, args.oe_dataset, args.epochs,
        args.learning_rate, args.weight_decay, args.milestones, args.batch_size,
        args.ad_mode, args.devices, model, train_specs, test_specs,
        oe_limit_samples=args.oe_size, continue_run=continue_run,
        superdir=args.superdir, dataset_path=args.datapath,
        compute_dtype=getattr(args, "compute_dtype", None), device=device)
    return trainer.run(args.classes, args.iterations, snapshots,
                       vmap_seeds=getattr(args, "vmap_seeds", None))


def load_setup(path: Optional[str], args: Namespace, check_train_specs,
               check_test_specs) -> Tuple[Optional[List[List[Optional[str]]]], Optional[str]]:
    """Load a previous run's configuration into ``args`` and its snapshot
    matrix (a path per class and seed, None where there is none). The
    pipelines, dataset and objective must match the run's."""
    if path is None:
        return None, None
    if path.startswith("sftp://"):
        path = path[7:][path[7:].index("/"):]
    print(f"Load setup from {path}")
    with open(pt.join(path, "setup.json")) as r:
        setup = json.load(r)
    v1 = pt.join(path, "setup_v1.json")
    run_meta = {}
    if pt.exists(v1):
        with open(v1) as r:
            run_meta = json.load(r)

    assert specs_repr(setup.pop("train_specs")) == specs_repr(check_train_specs), \
        "The loaded train transformation pipeline does not match the set one. " \
        "Please match manually."
    assert specs_repr(setup.pop("test_specs")) == specs_repr(check_test_specs), \
        "The loaded test transformation pipeline does not match the set one. " \
        "Please match manually."
    assert setup.pop("dataset") == args.dataset, \
        f"It seems like the set dataset ({args.dataset}) is not the one found in the " \
        f"loaded experiment. Please match manually."
    assert setup.pop("objective") == args.objective, \
        f"It seems like the set objective ({args.objective}) is not the one found in " \
        f"the loaded experiment. Please match manually."
    args.oe_dataset = setup.pop("oe_dataset")
    args.epochs = setup.pop("epochs")
    args.learning_rate = setup.pop("lr")
    args.weight_decay = setup.pop("wdk")
    args.milestones = setup.pop("milestones")
    args.batch_size = setup.pop("batch_size")
    args.ad_mode = setup.pop("ad_mode")
    oe_size = setup.pop("oe_limit_samples", INF)
    args.oe_size = INF if oe_size in (None, "inf", "Infinity") else oe_size
    msms = setup.pop("msms", None)
    args.ms_mode = [MSM.load(m) for m in msms] if msms else []
    args.classes = run_meta.get("run_classes", getattr(args, "classes", None))
    args.iterations = run_meta.get("run_seeds", getattr(args, "iterations", 1))
    args.compute_dtype = setup.pop("compute_dtype", None)
    for known in ("model", "datapath", "oe_limit_classes", "seed", "nominal_label"):
        setup.pop(known, None)
    assert len(setup) == 0, f"There are unexpected arguments in the loaded setup: {setup.keys()}."

    classes = args.classes if args.classes is not None else range(no_classes(args.dataset))
    snapshots: List[List[Optional[str]]] = []
    for c in range(no_classes(args.dataset)):
        snapshots.append([])
        for i in range(args.iterations):
            snap = pt.join(path, "snapshots", f"snapshot_cls{c}_it{i}.pt")
            snapshots[-1].append(snap if c in classes and pt.exists(snap) else None)
    return snapshots, path


def load_evolve(path: Optional[str], tree: Tree, history: dict, pop: list, gen: int,
                logger: Logger, trainer: Trainer, dataset, args: Namespace,
                check_train_specs, check_test_specs):
    """Resume an evolution run from its results.json (the history, whose setup
    must have this run's keys) and evolution.json (the tree): the population
    of the last finished generation with its fitness, the next generation's
    number, and a fresh toolbox. The configuration comes from the
    most-continued inner run. Deviation: an individual takes its fitness
    from the history's last row, where the JAX package takes that of the
    first tree node with its values, which has none where the values occur
    in more than one node and ``evaluate`` gave the fitness to another."""
    if path is None:
        return history, pop, gen, logger, None

    print(f"Load evolve setup from {path}")
    with open(pt.join(path, "results.json")) as r:
        loaded_history = json.load(r)
    setup = deepcopy(loaded_history["setup"])
    for k in setup:
        assert k in history["setup"], f"{k} is in loaded setup but not in setup!"
    for k in history["setup"]:
        # ev_seed is optional: runs recorded before it existed can still resume
        assert k in setup or k == "ev_seed", f"{k} is in setup but not in loaded setup!"
    args.ev_seed = setup.pop("ev_seed", getattr(args, "ev_seed", None))
    args.ev_oesize = setup.pop("oesize")
    args.ev_generation_pool = setup.pop("geneation_pool")
    args.ev_mutation_pool = setup.pop("mutation_pool")
    args.ev_mutation_indp = setup.pop("mutation_indp")
    args.ev_mutation_oneofkbest = setup.pop("mutation_oneofkbest")
    args.ev_mutation_chance = setup.pop("mutation_chance")
    args.ev_mate_chance = setup.pop("mate_chance")
    args.ev_generations = setup.pop("generations")
    setup.pop("oeds")
    args.ev_select_toursize = setup.pop("select_toursize")
    assert len(setup) == 0, f"setup contains unexpected keys ({setup.keys()})"
    history = loaded_history

    inner = [d for d in os.listdir(path)
             if pt.isdir(pt.join(path, d)) and d.startswith("log_")]
    if inner:
        # a ---CNTD continuation makes a second inner run directory: resume
        # from the most-continued (then newest) one
        inner.sort(key=lambda d: (d.count("---CNTD"), d))
        load_setup(pt.join(path, inner[-1]), args, check_train_specs, check_test_specs)

    tree.load(pt.join(path, "evolution.json"))
    if len(history["pop"]) == 0:
        raise ValueError(f"The loaded experiment at {path} has no finished generation "
                         f"that can be used to continue it.")
    weight = -1.0 if args.ev_minimize_fitness else 1.0
    pop = []
    for values, fit in zip(history["pop"][-1], history["fit"][-1]):
        ind = Individual(values, weight)
        ind.fitness.values = (fit,)
        ind.file = tree.get(values).content.file
        pop.append(ind)
    gen = len(history["pop"])

    _, _, toolbox, _, _ = evolve_setup(
        args.ev_oesize, args.ev_generation_pool, args.ev_mutation_pool,
        args.ev_mutation_indp, args.ev_mutation_oneofkbest, args.ev_mutation_chance,
        args.ev_mate_chance, args.ev_generations, args.ev_select_toursize, trainer,
        dataset, args, not args.ev_minimize_fitness,
        vmap_candidates=getattr(args, "ev_vmap", False), seed=args.ev_seed)
    return history, pop, gen, logger, toolbox
