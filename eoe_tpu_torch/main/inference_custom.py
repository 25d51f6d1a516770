"""CLI runner: inference only, on a custom dataset.

The port of eoe_tpu/main/inference_custom.py: scores the data at
--custom-dataset-path (normal/, anomalous/ and unlabeled/ folders) with a
trained snapshot (``--custom-model-snapshot``, a CustomNet's or any port
snapshot of the model), logging each sample's anomaly score keyed by its
file path relative to that folder, and the AUROC where both labelled
folders are present. It evaluates without training (``run(..., train=False)``).
Run: python -m eoe_tpu_torch.main.inference_custom --custom-dataset-path P --log-path L \
     --custom-model-snapshot S
"""

import sys

from eoe_tpu_torch.datasets import DS_CHOICES
from eoe_tpu_torch.datasets.custom import ADCustomDS
from eoe_tpu_torch.main import create_trainer, data_parallel, default_argsparse
from eoe_tpu_torch.main.train_only_custom import (add_custom_model_args, build_specs,
                                                  discover_custom_models)


@data_parallel
def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller asks for another one."""
    custom_models = discover_custom_models()

    def modify_parser(parser):
        add_custom_model_args(parser, custom_models, train=False)
        parser.set_defaults(
            comment="{obj}_custom_inference", objective="hsc", dataset="custom",
            oe_dataset=None, epochs=0, learning_rate=1e-3, weight_decay=0,
            milestones=[], batch_size=128, classes=None, iterations=1)

    def modify_args(args):
        if args.dataset is not None and args.dataset != "custom":
            raise ValueError("The argument dataset needs to be 'custom' for custom inference.")
        args.dataset = "custom"
        args.iterations = 1  # there's no point in evaluating multiple times
        if args.ad_mode != "one_vs_rest":
            print(f"The AD mode is changed to {args.ad_mode}. Custom datasets ignore "
                  f"the AD mode.", file=sys.stderr)
        if len(args.image_resize) > 2:
            raise ValueError(f"--image-resize accepts one or two integers, but "
                             f"{len(args.image_resize)} are given.")

    args = default_argsparse(
        lambda s: f"{s} This specific script comes with a default configuration for "
                  f"custom datasets.", modify_parser, modify_args, argv=argv)
    DS_CHOICES["custom"]["default_size"] = args.custom_dataset_default_size
    ADCustomDS.eval_only = True
    ADCustomDS.base_folder = "."
    ADCustomDS.classes = []
    args.comment = args.comment.format(obj=args.objective, admode="")

    specs = build_specs(args, train=False)
    model = custom_models[args.custom_model_name](
        prediction_head=args.custom_model_add_prediction_head,
        clf=args.objective in ("bce", "focal"))

    print("Program started with:\n", vars(args))
    trainer = create_trainer(
        args.objective, args.comment, args.dataset, args.oe_dataset, args.epochs,
        args.learning_rate, args.weight_decay, args.milestones, args.batch_size,
        args.ad_mode, args.devices, model, specs, specs,
        oe_limit_samples=args.oe_size, dataset_path=args.custom_dataset_path,
        logpath=args.log_path, device=device)
    return trainer.run([0], args.iterations,
                       [[args.custom_model_snapshot] * args.iterations], train=False)


if __name__ == "__main__":
    main()
