"""Port parity of one fluctuating BD step on the pseudo-2D far field (a
wall-bounded (Lx, Ly) box with ``farfield_grid`` and ``image_shells``)
against the JAX package, from the Gaussian draws the JAX step makes from
its key: the JAX package's own film system (tests/test_pseudo2d_farfield.py:
4 × shell_N_12 in an (11, 11) box, image_shells 6, grid (4, 4, 2)) at p = 3,
in float64 through ``run_bd`` and in float32 through ``stochastic_step``
(K3's wrapper, its plain version on the CPU)."""

import dataclasses
import functools
import warnings

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
from rigid_body_light_tpu_torch.dynamics import run_bd as run_bd_t  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import stochastic_step as step_t  # noqa: E402

B = 4
BOX = (11.0, 11.0)
# one float32 step against the JAX package's, max|ΔX_port − ΔX_jax| /
# max|ΔX_jax|: the bound of tests/test_torch_step_f32.py
F32_STEP_TOL = 2e-3


def _film(dtype_j, dtype_t, gmres_tol):
    """The JAX test's system; a gmres_tol below the p = 3 operator error
    (the warning is expected) so both packages solve the same approximate
    operator to the solver's precision."""
    params, ref = load_structure("shell_N_12")
    X = np.array([[3.0, 3.0, 2.2], [8.5, 3.5, 2.4], [1.0, 8.0, 2.1],
                  [6.0, 7.0, 2.3]])
    Q = np.random.default_rng(4).standard_normal((B, 4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cfg_j = SimulationConfig(
            a=params["sep"] / 2, dt=0.05, kBT=0.5, wall=True, box=BOX,
            image_shells=6, dtype=dtype_j, lanczos_iters=6,
            gmres_tol=gmres_tol, gmres_restart=20, gmres_maxiter=60,
            pc_mode="block_free", farfield_grid=(4, 4, 2), farfield_p=3)
        cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    geom_j = kin_j.make_ref_geometry(ref, dtype=dtype_j)
    st_j = make_state_j(X, Q, dtype=dtype_j)
    geom_t = interop.geometry_from_numpy(ref, dtype=dtype_t, device="cpu")
    st_t = interop.state_from_numpy(st_j.X, st_j.Q, dtype=dtype_t,
                                    device="cpu")
    force = np.zeros((B, 6))
    force[:, 2] = -0.5
    key = jax.random.key(11)
    k1, k2, k3 = jax.random.split(key, 3)
    n = ref.shape[0]
    draws = (np.array(jax.random.normal(k1, (B * 3 * n,), dtype_j)),
             np.array(jax.random.normal(k2, (B * 3 * n,), dtype_j)),
             np.array(jax.random.normal(k3, (B, n, 3), dtype_j)))
    s_j, aux_j = jax.jit(functools.partial(step_j, geom_j, cfg_j))(
        st_j, key, jnp.asarray(force, dtype_j))
    return cfg_t, geom_t, st_t, torch.from_numpy(force).to(dtype_t), draws, \
        st_j, s_j, aux_j


def test_film_farfield_step_matches_float64():
    """One step through run_bd (the entry point a user calls), from the JAX
    step's draws."""
    cfg_t, geom_t, st_t, f_t, draws, st_j, s_j, aux_j = _film(
        jnp.float64, torch.float64, 1e-8)
    assert cfg_t.box == BOX and cfg_t.farfield_grid == (4, 4, 2)
    s_t, tr = run_bd_t(geom_t, cfg_t, st_t, 1, force_fn=lambda s, i: f_t,
                       draws_fn=lambda i: draws)
    assert int(tr["iters"][0]) == int(aux_j.iters)
    np.testing.assert_allclose(s_t.X.numpy(), np.asarray(s_j.X), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(s_t.Q.numpy(), np.asarray(s_j.Q), rtol=0,
                               atol=1e-9)
    assert float(tr["residual"][0]) < cfg_t.gmres_tol
    assert np.abs(s_t.X.numpy() - np.asarray(st_j.X)).max() > 1e-4  # moved


def test_film_farfield_step_matches_float32():
    cfg_t, geom_t, st_t, f_t, draws, st_j, s_j, aux_j = _film(
        jnp.float32, torch.float32, 1e-4)
    assert cfg_t.use_pallas and st_t.X.dtype == torch.float32  # K3's path
    s_t, aux_t = step_t(geom_t, cfg_t, st_t, f_t, draws=draws)
    assert aux_t.iters == int(aux_j.iters)
    assert float(aux_t.residual) < cfg_t.gmres_tol
    dX_j = np.asarray(s_j.X) - np.asarray(st_j.X)
    dX_t = s_t.X.numpy() - np.asarray(st_j.X)
    assert np.abs(dX_t - dX_j).max() / np.abs(dX_j).max() < F32_STEP_TOL
    assert np.abs(s_t.Q.numpy() - np.asarray(s_j.Q)).max() < 1e-4
