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

Adam is the fused one, capturable, and each group's learning rate is a 0-d
float32 tensor on the parameters' device: a step captured in a CUDA graph
(``training/scan.py``) reads it there on every replay, and the scheduler
writes each decay into it in place (a Python float would be frozen into the
graph at capture).
"""

from typing import Dict, Sequence, Tuple

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


def tensor_lr(lr: float, params: Sequence[torch.Tensor]) -> torch.Tensor:
    """A group's learning rate as a 0-d float32 tensor on its parameters' device."""
    return torch.tensor(lr, dtype=torch.float32, device=params[0].device)


def adam(groups) -> torch.optim.Adam:
    """Fused, capturable Adam with optax's defaults (betas 0.9 / 0.999, eps 1e-8)."""
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8, fused=True, capturable=True)


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
            groups.append({"params": params, "lr": tensor_lr(lr, params), "label": label})
    optimizer = adam(groups)
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
    params = list(model.parameters())
    optimizer = adam([{"params": params, "lr": tensor_lr(lr, params)}])
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        lambda count: step_decay_factor(count, steps_per_epoch,
                                        step_size_epochs=step_size_epochs),
    )
    return optimizer, scheduler


def load_optimizer_state(optimizer: torch.optim.Optimizer, scheduler, state: Dict) -> None:
    """Load an optimizer-state sidecar (``{"optimizer": ..., "scheduler": ...}``)
    into both. Loading takes each group's hyperparameters from the sidecar;
    one saved by a float-rate, unfused Adam brings back a Python float rate,
    ``fused`` unset, ``capturable`` off and host step counts. Every group is
    made fused and capturable again, its rate a tensor on the parameters'
    device, and every step count a float32 tensor there. A step graph
    captured before the load is stale: capture after it."""
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    for group in optimizer.param_groups:
        group.update(fused=True, capturable=True, foreach=None)
        lr = group["lr"]
        if not torch.is_tensor(lr) or lr.device != group["params"][0].device:
            group["lr"] = tensor_lr(float(lr), group["params"])
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and "step" in st:
                st["step"] = torch.as_tensor(st["step"], dtype=torch.float32, device=p.device)
