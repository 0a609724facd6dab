"""The common-slopes losses against the JAX package on the same seeded
inputs: the amplitude dB loss, the EDC loss (omni and directional), the
smoothness kernel and loss, and the position lookup. Forward within 1e-6
relative, gradients within 1e-5 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.losses import spatial as port
from diffgfdn_tpu.losses import spatial as ref
from torch_port_helpers import rel_l2

FWD_TOL = 1e-6
GRAD_TOL = 1e-5
B, J, K, T, M = 16, 12, 3, 720, 40


def _amps(shape, seed):
    return np.random.RandomState(seed).uniform(0.05, 1.0, shape).astype(np.float32)


def _check(port_fn, ref_fn, args, record_property, name):
    """Value and gradient w.r.t. the first argument, port vs JAX."""
    val, grad = jax.value_and_grad(ref_fn)(*[jnp.asarray(a) for a in args])
    x = torch.from_numpy(args[0]).requires_grad_(True)
    out = port_fn(x, *[torch.from_numpy(a) for a in args[1:]])
    out.backward()
    fwd = abs(out.item() - float(val)) / abs(float(val))
    gerr = rel_l2(x.grad.numpy(), np.asarray(grad))
    record_property(f"{name}_forward_rel", fwd)
    record_property(f"{name}_grad_rel_l2", gerr)
    assert fwd <= FWD_TOL and gerr <= GRAD_TOL, (fwd, gerr)


def _envelopes():
    decays = np.array([0.05, 0.09, 0.07])
    env = port.make_decay_envelopes(decays, T, 8000.0).numpy()
    assert np.array_equal(env, np.asarray(ref.make_decay_envelopes(decays, T, 8000.0)))
    return env


def test_spatial_mse_loss_matches_jax(record_property):
    _check(port.spatial_mse_loss, ref.spatial_mse_loss, (_amps((B, K), 0), _amps((B, K), 1)),
           record_property, "mse")


@pytest.mark.parametrize("directional", [False, True], ids=["omni", "directional"])
def test_spatial_edc_loss_matches_jax(directional, record_property):
    shape = (B, J, K) if directional else (B, K)
    _check(port.spatial_edc_loss, ref.spatial_edc_loss,
           (_amps(shape, 2), _amps(shape, 3), _envelopes()), record_property, "edc")


def test_smoothness_kernel_and_position_lookup_match_jax():
    rng = np.random.RandomState(4)
    pos = rng.uniform(0.0, 6.0, (M, 3)).astype(np.float32)
    kern = port.make_smoothness_kernel(pos)
    assert np.array_equal(kern, ref.make_smoothness_kernel(pos))
    cur = pos[rng.permutation(M)[:B]] + rng.uniform(-1e-3, 1e-3, (B, 3)).astype(np.float32)
    idx = port.find_position_idx(torch.from_numpy(pos), torch.from_numpy(cur)).numpy()
    assert np.array_equal(idx, np.asarray(ref.find_position_idx(jnp.asarray(pos),
                                                                 jnp.asarray(cur))))


def test_spatial_smoothness_loss_matches_jax(record_property):
    """Against JAX's loss evaluated in float64: in float32 JAX's expanded
    squared distance leaves |w|^2's rounding on the diagonal (ROADMAP C13),
    which the port's differences do not; the float32 gap is recorded."""
    rng = np.random.RandomState(5)
    kern = port.make_smoothness_kernel(rng.uniform(0.0, 6.0, (M, 3)))
    pos_idx = rng.permutation(M)[:B].astype(np.int64)
    weights = rng.randn(B, K, 9).astype(np.float32)

    def ref_fn(w, k, i):
        return ref.spatial_smoothness_loss(k, i, w)

    with jax.enable_x64(True):
        val, grad = jax.value_and_grad(ref_fn)(
            jnp.asarray(weights, jnp.float64), jnp.asarray(kern, jnp.float64), pos_idx)
        val, grad = float(val), np.asarray(grad)
    f32 = float(ref_fn(jnp.asarray(weights), jnp.asarray(kern), jnp.asarray(pos_idx)))
    w = torch.from_numpy(weights).requires_grad_(True)
    out = port.spatial_smoothness_loss(torch.from_numpy(kern), torch.from_numpy(pos_idx), w)
    out.backward()
    fwd = abs(out.item() - val) / abs(val)
    gerr = rel_l2(w.grad.numpy(), grad)
    record_property("smoothness_forward_rel_vs_jax_f64", fwd)
    record_property("smoothness_grad_rel_l2_vs_jax_f64", gerr)
    record_property("jax_f32_forward_rel_vs_jax_f64", abs(f32 - val) / abs(val))
    assert fwd <= FWD_TOL and gerr <= GRAD_TOL, (fwd, gerr)
