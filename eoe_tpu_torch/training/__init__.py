"""Trainers of the port: the registry of the JAX package's objective names.

``hsc`` and ``clip`` are ported; bce, focal, dsvdd, dsad and ae wait for the
models that use them and raise here.
"""

from functools import partial

from eoe_tpu_torch.training.trainer import (  # noqa: F401
    NanGradientsError, Result, Trainer, TrainState)


def _clip_trainer(*args, **kwargs):
    from eoe_tpu_torch.training.clip import ClipTrainer
    return ClipTrainer(*args, **kwargs)


def _not_ported(name):
    def make(*args, **kwargs):
        raise NotImplementedError(f"the {name} trainer is not ported yet")
    return make


TRAINER = {
    "hsc": partial(Trainer, objective="hsc"),
    "clip": _clip_trainer,
    **{name: _not_ported(name) for name in ("bce", "dsvdd", "dsad", "focal", "ae")},
}
