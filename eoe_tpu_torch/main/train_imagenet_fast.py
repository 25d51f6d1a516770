"""CLI runner: ImageNet-30 (fast) anomaly-detection benchmark.

The port of eoe_tpu/main/train_imagenet_fast.py: its defaults and pipelines.
Run: python -m eoe_tpu_torch.main.train_imagenet_fast [flags]
"""

from eoe_tpu_torch.main import data_parallel, default_argsparse, run_default_training

DEFAULTS = dict(
    comment='{obj}_imagenet_{admode}{oelimit}',
    objective='hsc',
    dataset='imagenet',
    oe_dataset='imagenet21k',
    epochs=30,
    learning_rate=0.001,
    weight_decay=0,
    milestones=[25],
    batch_size=128,
    classes=None,
    iterations=2,
)

TRAIN_SPECS = [{'op': 'resize', 'size': 256}, {'op': 'random_crop', 'size': 224}, 'normalize']
TEST_SPECS = [{'op': 'resize', 'size': 256}, {'op': 'center_crop', 'size': 224}, 'normalize']


def build_model(args):
    from eoe_tpu_torch.models import WideResNet
    return WideResNet(clf=args.objective in ("bce", "focal"))


@data_parallel
def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller asks for another one."""
    def modify_parser(parser):
        parser.set_defaults(**DEFAULTS)

    args = default_argsparse(
        lambda s: f"{s} This specific script comes with a default configuration for ImageNet-30 (fast).",
        modify_parser, argv=argv)
    args.comment = args.comment.format(
        obj=args.objective, admode=args.ad_mode, epochs=args.epochs,
        oelimit=f"_OE{args.oe_size}" if args.oe_size < float("inf") else "")
    return run_default_training(args, build_model(args), TRAIN_SPECS, TEST_SPECS,
                                device=device)


if __name__ == "__main__":
    main()
