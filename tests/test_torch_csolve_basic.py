"""``csolve`` and the remainder of ``ops/basic.py`` against the JAX package.

``csolve`` (M X = B as cinv(M) @ B, B1 forward and B2 backward on the card)
on seeded 4 x 4 and 12 x 12 batches with 1 and 3 right-hand sides: 1e-4
relative L2 of JAX's ``kernels.csolve``; its backward by
``torch.autograd.gradcheck`` in complex128 on the plain versions; the
gradient of a real loss (w.r.t. M and B) within 2e-3 relative L2 of JAX's
(C3's model bound; torch's complex gradient is the conjugate of JAX's).
The host functions of ``ops/basic`` in float64 within 1e-12 of JAX's;
``shaped_wgn`` on JAX's noise drawn at the same key within 1e-6 relative L2,
and from a generator the same as that generator's draw passed as the noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffgfdn_torch.kernels import cinv as cinv_mod
from diffgfdn_torch.kernels import csolve, linalg
from diffgfdn_torch.ops import basic
from diffgfdn_tpu.kernels import csolve as jax_csolve
from diffgfdn_tpu.ops import basic as jax_basic
from torch_port_helpers import rel_l2

SOLVE_TOL = 1e-4
GRAD_TOL = 2e-3
HOST_TOL = 1e-12
WGN_TOL = 1e-6


def _systems(k: int, n: int, r: int, seed: int):
    rng = np.random.RandomState(seed)
    m = (2.0 * np.eye(n)[None] + 0.4 * rng.randn(k, n, n)
         + 0.4j * rng.randn(k, n, n)).astype(np.complex64)
    m[: k // 3, 0, 0] = 0.0  # elimination must pivot
    b = (rng.randn(k, n, r) + 1j * rng.randn(k, n, r)).astype(np.complex64)
    return m, b


CASES = [(4, 1), (4, 3), (12, 1), (12, 3)]


@pytest.mark.parametrize("n,r", CASES, ids=[f"n{n}_r{r}" for n, r in CASES])
def test_csolve_matches_jax(n, r, record_property):
    m, b = _systems(48, n, r, seed=n + r)
    got = csolve(torch.from_numpy(m), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_csolve(jnp.asarray(m), jnp.asarray(b)))
    err = rel_l2(got, want)
    record_property("rel_l2", err)
    assert got.shape == want.shape == (48, n, r) and got.dtype == np.complex64
    assert err <= SOLVE_TOL
    # and it solves the systems
    assert rel_l2(m @ got, b) <= SOLVE_TOL


def test_csolve_backward_passes_gradcheck():
    g = torch.Generator().manual_seed(2)
    m = (2.0 * torch.eye(4, dtype=torch.complex128)
         + 0.4 * torch.randn((3, 4, 4), dtype=torch.complex128, generator=g))
    m[0, 0, 0] = 0.0
    b = torch.randn((3, 4, 2), dtype=torch.complex128, generator=g)
    assert torch.autograd.gradcheck(
        lambda x, y: linalg.csolve_with(x, y, cinv_mod.cinv_plain, cinv_mod.neg_ptgpt_plain),
        (m.requires_grad_(), b.requires_grad_()),
    )


@pytest.mark.parametrize("n", [4, 12])
def test_csolve_gradient_matches_jax(n, record_property):
    m, b = _systems(24, n, 3, seed=7 * n)
    w = np.random.RandomState(n).randn(24, n, 3).astype(np.float32)

    def jax_loss(mm, bb):
        x = jax_csolve(mm, bb)
        return jnp.sum(w * jnp.abs(x) ** 2) + jnp.sum(w * x.real)

    want_m, want_b = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(m), jnp.asarray(b))
    tm = torch.from_numpy(m).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    x = csolve(tm, tb)
    tw = torch.from_numpy(w)
    (torch.sum(tw * torch.abs(x) ** 2) + torch.sum(tw * x.real)).backward()
    errs = {"m": rel_l2(tm.grad.numpy(), np.conj(np.asarray(want_m))),
            "b": rel_l2(tb.grad.numpy(), np.conj(np.asarray(want_b)))}
    record_property("grad_rel_l2", errs)
    assert max(errs.values()) <= GRAD_TOL, errs


def _close(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def test_host_functions_match_jax(record_property):
    rng = np.random.RandomState(0)
    fs = 8000.0
    rir = rng.randn(3000) * np.exp(-np.arange(3000) / 500.0)
    spectrum = rng.randn(257) + 1j * rng.randn(257)
    errs = {
        "samps_to_ms": _close(basic.samps_to_ms([0, 17, 8000], fs),
                              jax_basic.samps_to_ms([0, 17, 8000], fs)),
        "hertz2rad": _close(basic.hertz2rad([63.0, 1000.0, 3999.0], fs),
                            jax_basic.hertz2rad([63.0, 1000.0, 3999.0], fs)),
        "rad2hertz": _close(basic.rad2hertz([0.1, 1.0, 3.1], fs),
                            jax_basic.rad2hertz([0.1, 1.0, 3.1], fs)),
        "spectral_flatness": _close(basic.spectral_flatness(spectrum),
                                    jax_basic.spectral_flatness(spectrum)),
    }
    for window in ("hann", "rect", "black"):
        for local in (False, True):
            errs[f"ned_{window}_{local}"] = _close(
                basic.normalized_echo_density(rir, fs, 30.0, window, local),
                jax_basic.normalized_echo_density(rir, fs, 30.0, window, local))
    record_property("max_rel", errs)
    assert max(errs.values()) <= HOST_TOL, errs
    with pytest.raises(ValueError, match="window"):
        basic.normalized_echo_density(rir, fs, window_type="kaiser")


def test_tensor_helpers_match_jax():
    x = np.linspace(-60.0, 6.0, 23).astype(np.float32)
    for squared in (False, True):
        got = basic.db2lin(torch.from_numpy(x), squared).numpy()
        assert _close(got, np.asarray(jax_basic.db2lin(jnp.asarray(x), squared))) <= 1e-6
    w = np.linspace(0.0, np.pi, 33)
    for radius in (1.0, 1.001):
        got = basic.frequency_samples_from_rad(w, radius).numpy()
        want = np.asarray(jax_basic.frequency_samples_from_rad(w, radius))
        assert got.dtype == want.dtype == np.complex64 and _close(got, want) <= 1e-6
    real = torch.from_numpy(x)
    assert basic.to_complex(real).dtype == torch.complex64
    assert np.array_equal(basic.to_complex(real).numpy(),
                          np.asarray(jax_basic.to_complex(jnp.asarray(x))))


def test_shaped_wgn_matches_jax_on_its_noise(record_property):
    rng = np.random.RandomState(3)
    amps = rng.uniform(0.05, 1.0, (4, 3)).astype(np.float32)
    floor = rng.uniform(1e-6, 1e-5, 4).astype(np.float32)
    decays, n, fs = [0.1, 0.25, 0.4], 4000, 8000.0
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_basic.shaped_wgn(amps, decays, n, fs, key, noise_floor=floor))
    noise = torch.from_numpy(np.array(jax.random.normal(key, (4, n))))
    got = basic.shaped_wgn(torch.from_numpy(amps), decays, n, fs, noise=noise,
                           noise_floor=torch.from_numpy(floor)).numpy()
    err = rel_l2(got, want)
    record_property("rel_l2", err)
    assert got.shape == want.shape and err <= WGN_TOL


def test_shaped_wgn_from_a_generator():
    """Without noise, the generator's standard normal draw of the output's
    shape is shaped: the same as passing that draw as the noise."""
    amps = torch.tensor([[1.0, 0.2], [0.3, 1.0]])
    draw = lambda seed: basic.shaped_wgn(  # noqa: E731
        amps, [0.2, 0.5], 800, 8000.0, generator=torch.Generator().manual_seed(seed))
    a = draw(5)
    noise = torch.randn((2, 800), generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, basic.shaped_wgn(amps, [0.2, 0.5], 800, 8000.0, noise=noise))
    assert torch.equal(a, draw(5)) and not torch.equal(a, draw(6))
    with pytest.raises(ValueError, match="Generator"):
        basic.shaped_wgn(amps, [0.2, 0.5], 100, 8000.0)
