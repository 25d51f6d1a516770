"""CLI runner: multiscale (frequency-filter magnitude) sweep on CIFAR-10.

The port of eoe_tpu/main/multiscale_cifar.py: its defaults and pipelines.
Run: python -m eoe_tpu_torch.main.multiscale_cifar --ms-mode TRANSFORM+DSPART [flags]
"""

import json
import os
import os.path as pt

from eoe_tpu_torch.main import data_parallel, load_setup, ms_argsparse, multiscale_experiment

DEFAULTS = dict(
    comment='MULTISCALE_{obj}_{msm}_OE{oesamples}',
    objective='hsc',
    dataset='cifar10',
    oe_dataset='cifar100',
    epochs=100,
    learning_rate=0.001,
    weight_decay=0,
    milestones=[50, 75],
    batch_size=128,
    classes=None,
    iterations=2,
    magnitude=None,
)

TRAIN_SPECS = ['normalize']
TEST_SPECS = ['normalize']


def build_model(args):
    from eoe_tpu_torch.models import CNN32
    return CNN32(bias=True, clf=args.objective in ("bce", "focal"))


@data_parallel
def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller asks for another one."""
    def modify_parser(parser):
        parser.add_argument("--magnitudes", type=int, nargs="+",
                            default=[0, 1, 2, 4, 8, 16, 32],
                            help="The list of MSM magnitudes to sweep.")
        parser.add_argument("--continue-run", type=str, default=None,
                            help="Path to a previous multiscale run directory.")
        parser.set_defaults(**DEFAULTS)

    def modify_args(args):
        if args.magnitude is not None:
            raise ValueError("The `--magnitude` argument is not used by this script as "
                             "it repeats the experiment for all `--magnitudes` instead.")
        if args.load is not None:
            raise ValueError("Since this script repeats the experiment, `--load` has no "
                             "impact. Use `--continue-run` instead.")

    args = ms_argsparse(
        lambda s: f"{s} Repeats this whole procedure multiple times with different "
                  f"magnitudes for the `--ms-mode`. This specific script comes with a "
                  f"default configuration for CIFAR-10.", modify_parser, modify_args,
        argv=argv)
    args.comment = args.comment.format(
        obj=args.objective, oesamples=args.oe_size,
        msm="--".join(str(m).split("--")[0] for m in args.ms_mode))

    continue_run, last_magn_snapshots, last_magn_dir = [], None, None
    if args.continue_run is not None:
        # scan per-magnitude results.json; assert magnitude bookkeeping
        subdirs = sorted(d for d in os.listdir(args.continue_run)
                         if pt.isdir(pt.join(args.continue_run, d))
                         and "_magnitude_" in d)
        if not subdirs:
            raise ValueError(f"no per-magnitude run directories found in "
                             f"{args.continue_run}")
        last_magn_dir = pt.join(args.continue_run, subdirs[-1])
        last_magn = int(pt.basename(last_magn_dir).split("_magnitude_")[-1]
                        .replace("---CNTD", ""))
        n_classes = len(args.classes) if args.classes is not None else 10
        res_file = pt.join(last_magn_dir, "results.json")
        if pt.exists(res_file):
            with open(res_file) as r:
                res = json.load(r)
            if len([x for x in res["eval_cls_rocs"] if len(x) != 0]) == n_classes:
                last_magn_dir = None
            else:
                last_magn_snapshots, _ = load_setup(last_magn_dir, args, TRAIN_SPECS,
                                                    TEST_SPECS)
        else:
            last_magn_snapshots, _ = load_setup(last_magn_dir, args, TRAIN_SPECS,
                                                TEST_SPECS)
        previous = {}
        for d in sorted(os.listdir(args.continue_run)):
            full = pt.join(args.continue_run, d)
            if (not pt.isdir(full) or "_magnitude_" not in d
                    or pt.exists(full + "---CNTD")):
                continue
            if "results.json" not in os.listdir(full):
                continue
            magn = int(d.split("_magnitude_")[-1].replace("---CNTD", ""))
            with open(pt.join(full, "results.json")) as r:
                res = json.load(r)
            if len([x for x in res["eval_cls_rocs"] if len(x) != 0]) != n_classes:
                continue
            previous[magn] = (res["eval_mean_auc"], res["eval_std_auc"])
        assert list(previous.keys()) == list(args.magnitudes[: len(previous)]), \
            f"The so-far finished magnitudes {tuple(previous.keys())} do not match " \
            f"the configured magnitudes {args.magnitudes}. Please match manually."
        if last_magn_dir is not None:
            assert last_magn == args.magnitudes[len(previous)], \
                f"The last unfinished magnitude ({last_magn}) does not match the " \
                f"expected one [{args.magnitudes[len(previous)]} in " \
                f"{args.magnitudes}]. Please match manually."
        continue_run = [previous[m] for m in sorted(previous)]

    print("Program started with:\n", vars(args))
    return multiscale_experiment(
        args, build_model(args), TRAIN_SPECS, TEST_SPECS, magnitudes=args.magnitudes,
        continue_run=continue_run,
        continue_last_magnitude=(last_magn_snapshots, last_magn_dir),
        superdir=args.superdir, dataset_path=args.datapath, device=device)


if __name__ == "__main__":
    main()
