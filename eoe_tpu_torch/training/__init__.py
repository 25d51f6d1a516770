"""Trainers of the port: the registry of the JAX package's objective names.
``clip`` is ``ClipTrainer``; every other objective is ``Trainer`` with that
objective (bce and focal want a model with a one-neuron head, ``clf=True``;
ae an autoencoder, ``AE32``).
"""

from functools import partial

from eoe_tpu_torch.training.trainer import (  # noqa: F401
    NanGradientsError, Result, Trainer, TrainState)


def _clip_trainer(*args, **kwargs):
    from eoe_tpu_torch.training.clip import ClipTrainer
    return ClipTrainer(*args, **kwargs)


TRAINER = {
    **{name: partial(Trainer, objective=name)
       for name in ("hsc", "bce", "dsvdd", "dsad", "focal", "ae")},
    "clip": _clip_trainer,
}
