"""CLI runner: CLIP on Fashion-MNIST anomaly-detection benchmark.

The port of eoe_tpu/main/train_clip_fmnist.py: its defaults and pipelines.
Run: python -m eoe_tpu_torch.main.train_clip_fmnist [flags]
"""

from eoe_tpu_torch.main import data_parallel, default_argsparse, run_default_training

DEFAULTS = dict(
    comment='{obj}_fmnist_{admode}_E{epochs}',
    objective='clip',
    dataset='fmnist',
    oe_dataset='cifar100',
    epochs=80,
    learning_rate=2e-05,
    weight_decay=0.001,
    milestones=[50, 60, 70, 75],
    batch_size=128,
    classes=None,
    iterations=10,
)

TRAIN_SPECS = [{'op': 'clip_pil_preprocessing'}, {'op': 'clip_tensor_preprocessing'}]
TEST_SPECS = []


def build_model(args):
    return None


@data_parallel
def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller asks for another one."""
    def modify_parser(parser):
        parser.set_defaults(**DEFAULTS)

    args = default_argsparse(
        lambda s: f"{s} This specific script comes with a default configuration for CLIP on Fashion-MNIST.",
        modify_parser, argv=argv)
    args.comment = args.comment.format(
        obj=args.objective, admode=args.ad_mode, epochs=args.epochs,
        oelimit=f"_OE{args.oe_size}" if args.oe_size < float("inf") else "")
    return run_default_training(args, build_model(args), TRAIN_SPECS, TEST_SPECS,
                                device=device)


if __name__ == "__main__":
    main()
