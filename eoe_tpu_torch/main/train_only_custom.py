"""CLI runner: training only, on a custom dataset, with a plug-in CustomNet
model.

The port of eoe_tpu/main/train_only_custom.py: the data lie directly at
--custom-dataset-path in normal/ (and optionally anomalous/) folders; the
model is a ``CustomNet`` subclass of ``eoe_tpu_torch.models.custom``, found
by name; ``--custom-model-snapshot`` starts it from a feature-model state
dict or a full snapshot, ``--custom-model-freeze`` trains only its head. It
trains and snapshots without a test (``run(..., test=False)``).
Run: python -m eoe_tpu_torch.main.train_only_custom --custom-dataset-path P --log-path L
"""

import inspect
import sys

import eoe_tpu_torch.models.custom as custom_models_pck
from eoe_tpu_torch.datasets import DS_CHOICES
from eoe_tpu_torch.datasets.custom import ADCustomDS
from eoe_tpu_torch.main import create_trainer, data_parallel, default_argsparse
from eoe_tpu_torch.models.custom_base import CustomNet


def discover_custom_models():
    """Every CustomNet subclass in ``eoe_tpu_torch.models.custom``, by name."""
    return {name: clz for name, clz in inspect.getmembers(custom_models_pck)
            if isinstance(clz, type) and issubclass(clz, CustomNet) and clz != CustomNet}


def add_custom_model_args(parser, custom_models, train: bool):
    group = parser.add_argument_group("custom-dataset")
    group.add_argument("--custom-dataset-default-size", type=int, default=256)
    group.add_argument("--custom-dataset-path", type=str, metavar="DIRECTORY-PATH",
                       required=True,
                       help='Path to the data; must contain a "normal" folder'
                            + (' (optionally "anomalous").' if train else
                               ' and/or "anomalous"/"unlabeled" folders.'))
    group.add_argument("--log-path", type=str, required=True,
                       help="Directory where results (incl. snapshots) are logged.")
    group.add_argument("--custom-model-snapshot", type=str, metavar="FILE-PATH",
                       default=None,
                       help="A feature-model state dict or a full EOE snapshot.")
    group.add_argument("--custom-model-name", type=str,
                       choices=list(custom_models.keys()), default="WideResNetCustom")
    group.add_argument("--custom-model-add-prediction-head", action="store_true")
    if train:
        group.add_argument("--custom-model-freeze", action="store_true",
                           help="Freeze the feature-extraction module's gradients.")
    group.add_argument("--image-resize", type=int, default=(256,), nargs="*")
    group.add_argument("--image-crop", type=int, default=(224, 224), nargs=2)


def build_specs(args, train: bool):
    size = args.image_resize if len(args.image_resize) == 2 else args.image_resize[0]
    specs = [{"op": "resize", "size": size}]
    if train:
        specs += [{"op": "color_jitter", "brightness": 0.01, "contrast": 0.01,
                   "saturation": 0.01, "hue": 0.01}, {"op": "random_hflip", "p": 0.5}]
        if all(c > 0 for c in args.image_crop):
            specs.append({"op": "random_crop", "size": list(args.image_crop)})
    else:
        if all(c > 0 for c in args.image_crop):
            specs.append({"op": "center_crop", "size": list(args.image_crop)})
    specs.append("normalize")
    return specs


@data_parallel
def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller asks for another one."""
    custom_models = discover_custom_models()

    def modify_parser(parser):
        add_custom_model_args(parser, custom_models, train=True)
        parser.set_defaults(
            comment="{obj}_custom_training", objective="hsc", dataset="custom",
            oe_dataset="custom", epochs=150, learning_rate=1e-3, weight_decay=0,
            milestones=[100, 125], batch_size=128, classes=None, iterations=10)

    def modify_args(args):
        if args.dataset is not None and args.dataset != "custom":
            raise ValueError("The argument dataset needs to be 'custom' for custom training.")
        if args.load is not None:
            raise NotImplementedError(
                "Continuing an experiment for custom training is not supported at the moment.")
        if args.classes is not None:
            raise ValueError("The argument classes is not supported for custom training.")
        args.dataset = "custom"
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
    ADCustomDS.train_only = True
    ADCustomDS.base_folder = "."
    ADCustomDS.classes = []
    args.comment = args.comment.format(obj=args.objective, admode="")

    specs = build_specs(args, train=True)
    model = custom_models[args.custom_model_name](
        prediction_head=args.custom_model_add_prediction_head,
        clf=args.objective in ("bce", "focal"),
        freeze=args.custom_model_freeze)

    print("Program started with:\n", vars(args))
    trainer = create_trainer(
        args.objective, args.comment, args.dataset, args.oe_dataset, args.epochs,
        args.learning_rate, args.weight_decay, args.milestones, args.batch_size,
        args.ad_mode, args.devices, model, specs, specs,
        oe_limit_samples=args.oe_size, dataset_path=args.custom_dataset_path,
        logpath=args.log_path, device=device)
    return trainer.run([0], args.iterations,
                       [[args.custom_model_snapshot] * args.iterations], test=False)


if __name__ == "__main__":
    main()
