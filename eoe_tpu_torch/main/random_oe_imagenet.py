"""CLI runner: random-search baseline for OE-subset selection on ImageNet-30.

The port of eoe_tpu/main/random_oe_imagenet.py: its defaults and pipelines.
Trains ``--ev-samples`` random subsets of ``--ev-oesize`` OE images once each.
Run: python -m eoe_tpu_torch.main.random_oe_imagenet [flags]
"""

from eoe_tpu_torch.main import data_parallel, random_oe_experiment

DEFAULTS = dict(
    comment='RANDPICK_{obj}_imagenet_cl{classes}_its{its}',
    objective='hsc',
    dataset='imagenet',
    oe_dataset='imagenet21k',
    epochs=30,
    learning_rate=0.001,
    weight_decay=0,
    milestones=[25],
    batch_size=128,
    classes=[0],
    iterations=2,
)

TRAIN_SPECS = [{'op': 'resize', 'size': 256}, {'op': 'center_crop', 'size': 224}, 'normalize']
TEST_SPECS = [{'op': 'resize', 'size': 256}, {'op': 'center_crop', 'size': 224}, 'normalize']


def build_model(args):
    from eoe_tpu_torch.models import WideResNet
    return WideResNet(clf=args.objective in ("bce", "focal"))


@data_parallel
def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller asks for another one."""
    return random_oe_experiment(
        "This specific script comes with a default configuration for ImageNet-30.",
        DEFAULTS, TRAIN_SPECS, TEST_SPECS, build_model, argv, device)


if __name__ == "__main__":
    main()
