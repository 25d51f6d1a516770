"""CLI runner: combined train+eval on a custom image-folder dataset.

The port of eoe_tpu/main/train_custom.py: its defaults and pipelines. It
expects ``datapath``/datasets/custom/{train,test}/... in either the
one-vs-rest class-folder layout or the general layout with per-class
normal/anomalous folders (--custom-dataset-ovr switches; see
eoe_tpu_torch.datasets.custom).
Run: python -m eoe_tpu_torch.main.train_custom [flags]
"""

from eoe_tpu_torch.datasets import DS_CHOICES
from eoe_tpu_torch.datasets.custom import ADCustomDS
from eoe_tpu_torch.main import data_parallel, default_argsparse, run_default_training

DEFAULTS = dict(
    comment="{obj}_custom{admode}_{oelimit}",
    objective="hsc",
    dataset="custom",
    oe_dataset="imagenet21k",
    epochs=150,
    learning_rate=1e-3,
    weight_decay=0,
    milestones=[100, 125],
    batch_size=128,
    classes=None,
    iterations=10,
)

TRAIN_SPECS = [{"op": "resize", "size": 256},
               {"op": "color_jitter", "brightness": 0.01, "contrast": 0.01,
                "saturation": 0.01, "hue": 0.01},
               {"op": "random_hflip", "p": 0.5},
               {"op": "random_crop", "size": 224}, "normalize"]
TEST_SPECS = [{"op": "resize", "size": 256}, {"op": "center_crop", "size": 224},
              "normalize"]


def build_model(args):
    from eoe_tpu_torch.models import WideResNet
    return WideResNet(clf=args.objective in ("bce", "focal"))


@data_parallel
def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller asks for another one."""
    def modify_parser(parser):
        group = parser.add_argument_group("custom-dataset")
        group.add_argument("--custom-dataset-default-size", type=int, default=256,
                           help="The custom dataset's default (raw) image size.")
        group.add_argument("--custom-dataset-ovr", action="store_true", default=False,
                           help="Use the one-vs-rest class-folder layout instead of the "
                                "general normal/anomalous layout.")
        parser.set_defaults(**DEFAULTS)

    args = default_argsparse(
        lambda s: f"{s} This specific script comes with a default configuration for "
                  f"custom datasets.", modify_parser, argv=argv)
    if args.ad_mode != "one_vs_rest":
        raise ValueError(
            f"The AD mode is changed to {args.ad_mode}. Note that custom datasets ignore "
            f"the AD mode. The mode is instead set via --custom-dataset-ovr.")
    DS_CHOICES["custom"]["default_size"] = args.custom_dataset_default_size
    ADCustomDS.ovr = args.custom_dataset_ovr
    args.comment = args.comment.format(
        obj=args.objective, admode="_one_vs_rest" if args.custom_dataset_ovr else "",
        oelimit=f"_OE{args.oe_size}" if args.oe_size < float("inf") else "")
    return run_default_training(args, build_model(args), TRAIN_SPECS, TEST_SPECS,
                                device=device)


if __name__ == "__main__":
    main()
