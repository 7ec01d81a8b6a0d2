"""Port parity of one fluctuating BD step in a triply-periodic box (every
mobility product through the positively-split Ewald operator) against the
JAX package, from the Gaussian draws the JAX step makes from its key.

4 × shell_N_42 in a (7, 6, 6.5) box, which passes ``check_box_geometry``
(body diameter 2.27 < min(L)/2 = 3); ``ewald_tol = 1e-4`` keeps the
wavevector count small, and both packages truncate the same sums.

float64: X and Q to 1e-9 with equal GMRES iterations (roundoff only).
float32: the bound of ``tests/test_torch_step_f32.py``, 2e-3·max|ΔX|: two
float32 solves stopped at ``gmres_tol`` = 1e-4, and the RFD drift divides a
difference of two products by ``rfd_delta`` = 1e-4.  There the port's
real-space sweep is K4's wrapper (its plain version on CPU tensors) and
the JAX package's is its streamed sweep; both evaluate the Chebyshev fit.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig, load_structure  # noqa: E402
from rigid_body_light_tpu.dynamics import stochastic_step as step_j  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import stochastic_step as step_t  # noqa: E402
from rigid_body_light_tpu_torch.utils.validation import check_box_geometry  # noqa: E402

B = 4
BOX = (7.0, 6.0, 6.5)
F32_STEP_TOL = 2e-3   # max|ΔX_port − ΔX_jax| / max|ΔX_jax|


def jax_step_draws(key, n, dtype):
    """The (W1, W2, W_rfd) that the JAX stochastic_step draws from ``key``."""
    k1, k2, k3 = jax.random.split(key, 3)
    return (np.array(jax.random.normal(k1, (B * 3 * n,), dtype)),
            np.array(jax.random.normal(k2, (B * 3 * n,), dtype)),
            np.array(jax.random.normal(k3, (B, n, 3), dtype)))


def both_steps(dtype_j, dtype_t, gmres_tol, seed):
    params, ref = load_structure("shell_N_42")
    a = params["sep"] / 2
    check_box_geometry(BOX, ref, a)
    X = np.array([[1.5 + 3.4 * (i % 2), 1.4 + 3.1 * (i // 2), 1.2 + 1.3 * i]
                  for i in range(B)])
    Q = np.random.default_rng(4).standard_normal((B, 4))
    cfg_j = SimulationConfig(a=a, dt=0.01, kBT=1.0, box=BOX, dtype=dtype_j,
                             ewald_tol=1e-4, lanczos_iters=6,
                             gmres_tol=gmres_tol, gmres_restart=20,
                             gmres_maxiter=60, pc_mode="block_free")
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    assert cfg_t.box == BOX and cfg_t.dtype == dtype_t and cfg_t.use_pallas
    geom_j = kin_j.make_ref_geometry(ref, dtype=dtype_j)
    st_j = make_state_j(X, Q, dtype=dtype_j)
    geom_t = interop.geometry_from_numpy(ref, dtype=dtype_t, device="cpu")
    st_t = interop.state_from_numpy(st_j.X, st_j.Q, dtype=dtype_t,
                                    device="cpu")
    force = np.zeros((B, 6), np.dtype(dtype_j))
    force[:, 2] = -1.0
    key = jax.random.key(seed)
    s_j, aux_j = jax.jit(functools.partial(step_j, geom_j, cfg_j))(
        st_j, key, jnp.asarray(force))
    s_t, aux_t = step_t(geom_t, cfg_t, st_t, torch.from_numpy(force),
                        draws=jax_step_draws(key, ref.shape[0], dtype_j))
    return cfg_t, st_j, s_j, aux_j, st_t, s_t, aux_t


def test_periodic_step_matches_float64():
    cfg, st_j, s_j, aux_j, st_t, s_t, aux_t = both_steps(
        jnp.float64, torch.float64, 1e-8, seed=5)
    assert aux_t.iters == int(aux_j.iters)
    np.testing.assert_allclose(s_t.X.numpy(), np.asarray(s_j.X), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(s_t.Q.numpy(), np.asarray(s_j.Q), rtol=0,
                               atol=1e-9)
    assert float(aux_t.residual) < cfg.gmres_tol
    np.testing.assert_allclose(float(aux_t.noise_err),
                               float(aux_j.noise_err), rtol=1e-6)
    assert np.abs(s_t.X.numpy() - np.asarray(st_j.X)).max() > 1e-4  # moved


def test_periodic_step_matches_float32():
    cfg, st_j, s_j, aux_j, st_t, s_t, aux_t = both_steps(
        jnp.float32, torch.float32, 1e-4, seed=3)
    assert s_t.X.dtype == torch.float32
    assert aux_t.iters == int(aux_j.iters)
    assert float(aux_t.residual) < cfg.gmres_tol
    dX_j = np.asarray(s_j.X) - np.asarray(st_j.X)
    dX_t = s_t.X.numpy() - st_t.X.numpy()
    assert np.abs(dX_t - dX_j).max() / np.abs(dX_j).max() < F32_STEP_TOL
    assert np.abs(s_t.Q.numpy() - np.asarray(s_j.Q)).max() < 1e-4
    np.testing.assert_allclose(torch.linalg.norm(s_t.Q, dim=1).numpy(), 1.0,
                               atol=1e-6)
