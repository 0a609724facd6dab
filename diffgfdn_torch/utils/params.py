"""Carry parameters between the JAX package's flax trees and the port's modules.

A flax tree (as a JAX checkpoint holds it: nested dicts of numpy arrays,
optionally under a top-level ``"params"`` key) maps onto the port's
``state_dict`` names by these rules:

* ``MLP_0`` -> ``mlp``;
* ``Dense_i/kernel`` (in, out) -> ``dense.i.weight`` (out, in), transposed;
  ``Dense_i/bias`` -> ``dense.i.bias``;
* ``LayerNorm_i/scale`` -> ``norm.i.weight``; ``LayerNorm_i/bias`` -> ``norm.i.bias``;
* every other key keeps its name (``input_gains``, ``output_gains``,
  ``feedback_loop/M``, ``feedback_loop/alpha``, ``output_filters``,
  ``output_scalars``).
"""

from typing import Dict

import numpy as np
import torch
from torch import nn


def torch_state_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """Flax parameter tree -> the port's ``state_dict`` (float32 tensors)."""
    params = tree.get("params", tree)
    state: Dict[str, torch.Tensor] = {}

    def walk(node: Dict, prefix: str) -> None:
        for key, val in node.items():
            if key.startswith("Dense_"):
                i = key.split("_")[1]
                state[f"{prefix}dense.{i}.weight"] = _tensor(np.asarray(val["kernel"]).T)
                state[f"{prefix}dense.{i}.bias"] = _tensor(val["bias"])
            elif key.startswith("LayerNorm_"):
                i = key.split("_")[1]
                state[f"{prefix}norm.{i}.weight"] = _tensor(val["scale"])
                state[f"{prefix}norm.{i}.bias"] = _tensor(val["bias"])
            elif isinstance(val, dict):
                walk(val, prefix + ("mlp" if key == "MLP_0" else key) + ".")
            else:
                state[prefix + key] = _tensor(val)

    walk(params, "")
    return state


def load_jax_params(model: nn.Module, tree: Dict) -> nn.Module:
    """Load a flax parameter tree into ``model`` in place (strict: every
    parameter must be present and no extra one)."""
    model.load_state_dict(torch_state_from_jax(tree), strict=True)
    return model


def jax_params_from_torch(model: nn.Module) -> Dict:
    """The port's parameters as a flax tree ``{"params": ...}`` of numpy arrays,
    in the layout a JAX checkpoint holds (the inverse of :func:`torch_state_from_jax`)."""
    tree: Dict = {}
    for name, value in model.state_dict().items():
        parts = name.split(".")
        arr = value.detach().cpu().numpy()
        keys = []
        i = 0
        while i < len(parts):
            part = parts[i]
            if part in ("dense", "norm"):
                layer, leaf = parts[i + 1], parts[i + 2]
                if part == "dense":
                    keys += [f"Dense_{layer}", "kernel" if leaf == "weight" else "bias"]
                    arr = arr.T if leaf == "weight" else arr
                else:
                    keys += [f"LayerNorm_{layer}", "scale" if leaf == "weight" else "bias"]
                i += 3
                continue
            keys.append("MLP_0" if part == "mlp" else part)
            i += 1
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.ascontiguousarray(arr)
    return {"params": tree}


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))
