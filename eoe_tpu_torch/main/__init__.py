"""Experiment orchestration of the port: the argument parsers, the trainer
factory, the multiscale sweep and the resume loader of eoe_tpu/main, which
the runners in this package share (``python -m eoe_tpu_torch.main.<runner>``).

The flags, their defaults and the on-disk layout are the JAX package's: data
under ``<datapath>/datasets``, runs under ``<datapath>/results/<superdir>``,
a resumed run (``--load``) continued in ``<old run>---CNTD``. On one card
three flags differ:
  * ``-d/--devices`` counts GPUs. None and 1 run on the one card; more raise
    (data parallelism is not ported yet);
  * ``--vmap-seeds`` parses as in the JAX package. Auto and
    ``--no-vmap-seeds`` train the seeds one after another; an explicit
    ``--vmap-seeds`` raises (not ported yet);
  * ``--compute-dtype`` maps ``float32`` / ``bfloat16`` to the torch dtypes
    and is written under the same names, so ``load_setup`` reads either
    package's setup.json.
Snapshots are the port's ``.pt`` files. The runners and the functions below
take ``device`` as a keyword (``cuda`` unless the caller asks for another
one); it is not a flag. The evolutionary and random OE search, and the
custom-model workflow (``train_only_custom``, ``inference_custom``), are not
ported yet.
"""

import json
import os
import os.path as pt
from argparse import ArgumentParser, BooleanOptionalAction, Namespace
from itertools import product
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from eoe_tpu_torch.datasets import (DS_CHOICES, DS_PARTS, MSM, MSM_TRANSFORMS,
                                    TRAIN_NOMINAL_ID, TRAIN_OE_ID, no_classes)
from eoe_tpu_torch.datasets.bases import INF
from eoe_tpu_torch.ops.preprocess import specs_repr
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
                        help="Number of GPUs. The port runs on one card; more are not "
                             "ported yet.")
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
                        help="Train all seeds of a class as one batched program: not "
                             "ported yet. The default and --no-vmap-seeds train the "
                             "seeds one after another.")
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
    layouts lie directly under ``<dataset_path>``)."""
    if devices is not None and devices > 1:
        raise NotImplementedError(
            f"--devices {devices}: data parallelism over several GPUs is not ported yet "
            "(DDP; ROADMAP.md Queue 1 item 9)")
    dtype_name = kwargs.pop("compute_dtype", None) or (
        "bfloat16" if trainer == "clip" else "float32")
    datapath = kwargs.pop("dataset_path", None) or default_datapath()
    superdir = kwargs.pop("superdir", ".")
    continue_run = kwargs.pop("continue_run", None)
    if continue_run is None:
        logger = Logger(pt.join(datapath, "results", superdir) if logpath is None
                        else logpath, comment)
    else:
        logger = Logger(continue_run + "---CNTD", noname=True)
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
        compute_dtype=COMPUTE_DTYPES[dtype_name], device=device, **kwargs)


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
        logger = Logger(pt.join(datapath, "results", superdir), args.comment)
    else:
        logger = Logger(args.continue_run if plot_elsewhere is None else plot_elsewhere,
                        noname=True)
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
    if getattr(args, "vmap_seeds", None):
        raise NotImplementedError(
            "--vmap-seeds: training the seeds as one batched program is not ported yet "
            "(ROADMAP.md Queue 1 item 8); --no-vmap-seeds or the default train them one "
            "after another")
    snapshots, continue_run = load_setup(args.load, args, train_specs, test_specs)
    print("Program started with:\n", vars(args))
    trainer = create_trainer(
        args.objective, args.comment, args.dataset, args.oe_dataset, args.epochs,
        args.learning_rate, args.weight_decay, args.milestones, args.batch_size,
        args.ad_mode, args.devices, model, train_specs, test_specs,
        oe_limit_samples=args.oe_size, continue_run=continue_run,
        superdir=args.superdir, dataset_path=args.datapath,
        compute_dtype=getattr(args, "compute_dtype", None), device=device)
    return trainer.run(args.classes, args.iterations, snapshots)


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
