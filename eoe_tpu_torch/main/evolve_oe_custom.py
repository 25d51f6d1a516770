"""CLI runner: evolutionary search for the single best/worst OE sample on custom datasets.

The port of eoe_tpu/main/evolve_oe_custom.py: its defaults and pipelines.
Runs ``--ev-generations`` generations of ``--ev-generation-pool``
individuals; ``--ev-continue-run <evolution run>`` resumes an interrupted
run from its last finished generation.
Run: python -m eoe_tpu_torch.main.evolve_oe_custom [flags]
"""

from eoe_tpu_torch.main import data_parallel, evolve_experiment

DEFAULTS = dict(
    comment='{obj}_custom_cl{classes}',
    objective='hsc',
    dataset='custom',
    oe_dataset='imagenet21k',
    epochs=30,
    learning_rate=0.001,
    weight_decay=0,
    milestones=[25],
    batch_size=128,
    classes=[0],
    iterations=2,
    ev_oesize=1,
    ev_generation_pool=64,
    ev_mutation_pool=10000,
    ev_mutation_indp=1,
    ev_mutation_oneofkbest=50,
    ev_mutation_chance=0.55,
    ev_mate_chance=0.05,
    ev_generations=50,
    ev_select_toursize=3,
)

TRAIN_SPECS = [{'op': 'resize', 'size': 256}, {'op': 'center_crop', 'size': 224}, 'normalize']
TEST_SPECS = [{'op': 'resize', 'size': 256}, {'op': 'center_crop', 'size': 224}, 'normalize']


def build_model(args):
    from eoe_tpu_torch.models import WideResNet
    return WideResNet(clf=args.objective in ("bce", "focal"))


@data_parallel
def main(argv=None, device=None):
    """``device``: ``cuda`` unless the caller asks for another one."""
    return evolve_experiment(
        "This specific script comes with a default configuration for "
        "finding optimal OE subsets for custom datasets.",
        DEFAULTS, TRAIN_SPECS, TEST_SPECS, build_model, argv, device)


if __name__ == "__main__":
    main()
