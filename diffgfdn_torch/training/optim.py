"""Optimizer: per-group Adam and a step decay (port of ``training/optim.py``).

Coupling angles, io gains (and the scalar-gain heads) and everything else
each get their own learning rate. The groups are labelled by the JAX
package's substring rules, applied to each parameter's flax path
(``utils/params.flax_path``), so ``output_scalars/...`` lands in ``io`` as it
does in JAX. The decay is StepLR(10 epochs, 0.1) counted in optimizer steps:
update u (from 0) uses lr * 0.1^(((u + offset) // steps_per_epoch) // 10),
as optax's schedule does with its step count. The spatial-sampling trainer
takes one Adam over all parameters with StepLR(20 epochs, 0.1)
(:func:`make_single_lr_optimizer`), as JAX's ``optax.exponential_decay(lr,
20 * steps_per_epoch, 0.1, staircase=True)``.
"""

from typing import Dict, Tuple

import torch
from torch import nn

from ..config.schema import TrainerConfig
from ..utils.params import flax_path

# substring -> label, checked in order (first match wins)
_LABEL_RULES = (
    ("alpha", "coupling"),
    ("output_gains", "io"),
    ("input_gains", "io"),
    ("output_svf_params", "io"),
    ("input_svf_params", "io"),
    ("input_scalars", "io"),
    ("output_scalars", "io"),
    ("sh_output_scalars", "io"),
)
STEP_SIZE_EPOCHS = 10
GAMMA = 0.1


def label_for_path(path: str) -> str:
    """The optimizer label of a "/"-joined flax path."""
    for sub, label in _LABEL_RULES:
        if sub in path:
            return label
    return "other"


def param_labels(model: nn.Module) -> Dict[str, str]:
    """{port parameter name: "coupling" | "io" | "other"}."""
    return {
        name: label_for_path("/".join(["params"] + flax_path(name)[0]))
        for name, _ in model.named_parameters()
    }


def step_decay_factor(count: int, steps_per_epoch: int, count_offset: int = 0,
                      step_size_epochs: int = STEP_SIZE_EPOCHS) -> float:
    """GAMMA^(epoch // step_size_epochs) for the epoch that update ``count`` falls in."""
    epoch = (count + count_offset) // max(steps_per_epoch, 1)
    return GAMMA ** (epoch // step_size_epochs)


def make_optimizer(
    trainer_config: TrainerConfig, model: nn.Module, steps_per_epoch: int,
    count_offset: int = 0,
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam (optax's defaults: betas 0.9 / 0.999, eps 1e-8) with one parameter
    group per label and the shared step decay. Call ``scheduler.step()``
    after every ``optimizer.step()``."""
    lrs = {
        "coupling": trainer_config.coupling_angle_lr,
        "io": trainer_config.io_lr,
        "other": trainer_config.lr,
    }
    labels = param_labels(model)
    groups = []
    for label, lr in lrs.items():
        params = [p for name, p in model.named_parameters() if labels[name] == label]
        if params:
            groups.append({"params": params, "lr": lr, "label": label})
    optimizer = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        lambda count: step_decay_factor(count, steps_per_epoch, count_offset=count_offset),
    )
    return optimizer, scheduler


def make_single_lr_optimizer(
    model: nn.Module, lr: float, steps_per_epoch: int, step_size_epochs: int
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """One Adam (optax's defaults) over every parameter at ``lr``, decayed by
    GAMMA every ``step_size_epochs`` epochs. Call ``scheduler.step()`` after
    every ``optimizer.step()``."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        lambda count: step_decay_factor(count, steps_per_epoch,
                                        step_size_epochs=step_size_epochs),
    )
    return optimizer, scheduler
