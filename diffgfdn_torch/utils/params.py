"""Carry parameters between the JAX package's flax trees and the port's modules.

A flax tree (as a JAX checkpoint holds it: nested dicts of numpy arrays,
optionally under a top-level ``"params"`` key) maps onto the port's
``state_dict`` names by these rules (the GFDN models' trees and the
common-slopes heads' ``{"MLP_0": ...}`` alike):

* ``MLP_0`` -> ``mlp``; ``MLPSkipConnections_0`` -> ``skip_mlp``;
  ``ConvNet_0`` -> ``cnn``; ``ResidualBlock_i`` -> ``blocks.i``;
* ``Dense_i/kernel`` (in, out) -> ``dense.i.weight`` (out, in), transposed;
  ``Dense_i/bias`` -> ``dense.i.bias``;
* ``Conv_i/kernel`` (kh, kw, in, out) -> ``conv.i.weight`` (out, in, kh, kw),
  axes permuted (3, 2, 0, 1); ``Conv_i/bias`` -> ``conv.i.bias``;
* ``LayerNorm_i/scale`` -> ``norm.i.weight``; ``LayerNorm_i/bias`` -> ``norm.i.bias``;
* every other key keeps its name (``input_gains``, ``output_gains``,
  ``feedback_loop/M``, ``feedback_loop/alpha``, ``output_filters``,
  ``output_scalars``, ``sh_output_scalars``; a single-position model's
  ``output_svf_params``, ``input_svf_params``, ``input_scalars`` and
  ``output_scalars``; a colorless FDN's ``feedback_loop/random_feedback_matrix``).

Gradients map by the same rules (:func:`jax_grads_from_torch`), and the
optimizer's parameter groups are labelled on the flax path
(:func:`flax_path`), as the JAX package labels its tree.

Band-stacked parameters (the band-parallel trainer's, and JAX's
``BandParallelTrainer``'s) carry a leading band axis on every leaf; the
rules permute only the trailing axes of a leaf, so they map such trees as
they map one band's. :func:`stack_jax_trees` and :func:`unstack_jax_tree`
turn per-band trees (per-band checkpoints) into one band-stacked tree and
back.
"""

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


# flax module names -> the port's attribute names
_MODULES = {"MLP_0": "mlp", "MLPSkipConnections_0": "skip_mlp", "ConvNet_0": "cnn"}
_FLAX_MODULES = {v: k for k, v in _MODULES.items()}
# the axes of a port weight, taken from its flax kernel's trailing axes
DENSE_AXES = (1, 0)
CONV_AXES = (3, 2, 0, 1)
# flax layer prefix -> (port container, the weight's axes from the kernel's)
_LAYERS = {"Dense": ("dense", DENSE_AXES), "Conv": ("conv", CONV_AXES)}
_FLAX_LAYERS = {v[0]: (k, v[1]) for k, v in _LAYERS.items()}


def _permute_trailing(arr: np.ndarray, axes: Tuple[int, ...]) -> np.ndarray:
    """``arr`` with its trailing ``len(axes)`` axes permuted by ``axes``
    (leading axes, such as a band axis, kept in place)."""
    lead = arr.ndim - len(axes)
    return np.transpose(arr, tuple(range(lead)) + tuple(lead + a for a in axes))


def _inverse(axes: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(int(i) for i in np.argsort(axes))


def torch_state_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """Flax parameter tree -> the port's ``state_dict`` (float32 tensors)."""
    params = tree.get("params", tree)
    state: Dict[str, torch.Tensor] = {}

    def walk(node: Dict, prefix: str) -> None:
        for key, val in node.items():
            layer, _, i = key.partition("_")
            if layer in _LAYERS and i.isdigit():
                name, axes = _LAYERS[layer]
                state[f"{prefix}{name}.{i}.weight"] = _tensor(
                    _permute_trailing(np.asarray(val["kernel"]), axes))
                state[f"{prefix}{name}.{i}.bias"] = _tensor(val["bias"])
            elif key.startswith("LayerNorm_"):
                i = key.split("_")[1]
                state[f"{prefix}norm.{i}.weight"] = _tensor(val["scale"])
                state[f"{prefix}norm.{i}.bias"] = _tensor(val["bias"])
            elif key.startswith("ResidualBlock_"):
                walk(val, f"{prefix}blocks.{key.split('_')[1]}.")
            elif isinstance(val, dict):
                walk(val, prefix + _MODULES.get(key, key) + ".")
            else:
                state[prefix + key] = _tensor(val)

    walk(params, "")
    return state


def load_jax_params(model: nn.Module, tree: Dict) -> nn.Module:
    """Load a flax parameter tree into ``model`` in place (strict: every
    parameter must be present and no extra one)."""
    model.load_state_dict(torch_state_from_jax(tree), strict=True)
    return model


def flax_path(name: str) -> Tuple[List[str], Optional[Tuple[int, ...]]]:
    """The flax tree keys of a port parameter name, and the axes of the port
    array taken from the flax leaf's trailing axes (``DENSE_AXES``, the
    transpose, for a Dense kernel; ``CONV_AXES`` for a Conv kernel), None
    when the two are the same array (the rules above, in reverse)."""
    parts = name.split(".")
    keys: List[str] = []
    axes = None
    i = 0
    while i < len(parts):
        part = parts[i]
        if part in _FLAX_LAYERS or part == "norm":
            layer, leaf = parts[i + 1], parts[i + 2]
            if part == "norm":
                keys += [f"LayerNorm_{layer}", "scale" if leaf == "weight" else "bias"]
            else:
                flax_layer, weight_axes = _FLAX_LAYERS[part]
                keys += [f"{flax_layer}_{layer}", "kernel" if leaf == "weight" else "bias"]
                axes = weight_axes if leaf == "weight" else None
            i += 3
            continue
        if part == "blocks":
            keys.append(f"ResidualBlock_{parts[i + 1]}")
            i += 2
            continue
        keys.append(_FLAX_MODULES.get(part, part))
        i += 1
    return keys, axes


def flax_tree(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict:
    """Named tensors (port names) as a flax tree ``{"params": ...}`` of numpy
    arrays; band-stacked tensors give leaves that carry the band axis first."""
    tree: Dict = {}
    for name, value in named:
        keys, axes = flax_path(name)
        arr = value.detach().cpu().numpy()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.ascontiguousarray(
            arr if axes is None else _permute_trailing(arr, _inverse(axes)))
    return {"params": tree}


def stack_jax_trees(trees: List[Dict]) -> Dict:
    """Per-band flax trees of one architecture -> one tree with a leading
    band axis on every leaf."""
    if isinstance(trees[0], dict):
        return {k: stack_jax_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def unstack_jax_tree(tree: Dict, band: int) -> Dict:
    """One band's flax tree out of a band-stacked one."""
    if isinstance(tree, dict):
        return {k: unstack_jax_tree(v, band) for k, v in tree.items()}
    return np.ascontiguousarray(np.asarray(tree)[band])


def jax_params_from_torch(model: nn.Module) -> Dict:
    """The port's parameters as a flax tree ``{"params": ...}`` of numpy arrays,
    in the layout a JAX checkpoint holds (the inverse of :func:`torch_state_from_jax`)."""
    return flax_tree(model.state_dict().items())


def jax_grads_from_torch(model: nn.Module) -> Dict:
    """The port's ``.grad``s as a flax tree, mapped by the same rules as the
    parameters (Dense and Conv kernels permuted); parameters without a
    gradient are left out."""
    return flax_tree(
        (name, p.grad) for name, p in model.named_parameters() if p.grad is not None
    )


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))
