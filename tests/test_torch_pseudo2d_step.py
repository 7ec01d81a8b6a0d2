"""Port parity of one pseudo-2D film step (a wall-bounded (Lx, Ly) box,
``examples/periodic_film.json``'s physics and solver) against the JAX
package, from the JAX step's own Gaussian draws: minimum image and the
exact image sum (image_shells 0 and 2), float64 and float32."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig, load_structure  # noqa: E402
from rigid_body_light_tpu import forces as forces_j  # noqa: E402
from rigid_body_light_tpu.dynamics import stochastic_step as step_j  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import forces as forces_t  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import stochastic_step as step_t  # noqa: E402

BOX = (8.0, 8.0)
# one float32 step against the JAX package's, max|ΔX_port − ΔX_jax| /
# max|ΔX_jax|: the bound of tests/test_torch_step_f32.py (two float32
# solves stopped at gmres_tol; RFD's 1/rfd_delta amplification)
F32_STEP_TOL = 2e-3


def _film(dtype_j, dtype_t, shells):
    """4 × shell_N_42 in the (8, 8) box above the wall with periodic_film's
    physics and solver (examples/periodic_film.json)."""
    params, ref = load_structure("shell_N_42")
    B = 4
    X = np.array([[2.5 * (i % 2), 2.5 * (i // 2), 1.6 + 0.3 * i]
                  for i in range(B)])
    Q = np.random.default_rng(4).standard_normal((B, 4))
    cfg_j = SimulationConfig(
        a=params["sep"] / 2, dt=0.01, kBT=0.3, wall=True, box=BOX,
        image_shells=shells, dtype=dtype_j, lanczos_iters=8,
        gmres_tol=1e-4, gmres_restart=20, gmres_maxiter=60,
        pc_mode="block_free")
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    geom_j = kin_j.make_ref_geometry(ref, dtype=dtype_j)
    st_j = make_state_j(X, Q, dtype=dtype_j)
    geom_t = interop.geometry_from_numpy(ref, dtype=dtype_t, device="cpu")
    st_t = interop.state_from_numpy(st_j.X, st_j.Q, dtype=dtype_t,
                                    device="cpu")

    def force(m):
        return m.sum_forces(m.gravity(np.array([0, 0, -1.0, 0, 0, 0])),
                            m.wall_repulsion(4.0, 0.3),
                            m.pair_yukawa(1.0, 0.5, diameter=2.0, box=BOX))

    f_j = force(forces_j)(st_j, 0)
    f_t = force(forces_t)(st_t, 0)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-6,
                               atol=1e-6)
    key = jax.random.key(11)
    k1, k2, k3 = jax.random.split(key, 3)
    n = ref.shape[0]
    draws = (np.array(jax.random.normal(k1, (B * 3 * n,), dtype_j)),
             np.array(jax.random.normal(k2, (B * 3 * n,), dtype_j)),
             np.array(jax.random.normal(k3, (B, n, 3), dtype_j)))
    s_j, aux_j = jax.jit(functools.partial(step_j, geom_j, cfg_j))(
        st_j, key, f_j)
    s_t, aux_t = step_t(geom_t, cfg_t, st_t, f_t, draws=draws)
    return cfg_t, st_j, s_j, aux_j, s_t, aux_t


@pytest.mark.parametrize("shells", [0, 2])
def test_film_step_matches_float64(shells):
    cfg_t, st_j, s_j, aux_j, s_t, aux_t = _film(jnp.float64, torch.float64,
                                                shells)
    assert cfg_t.box == BOX and cfg_t.image_shells == shells
    assert aux_t.iters == int(aux_j.iters)
    np.testing.assert_allclose(s_t.X.numpy(), np.asarray(s_j.X), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(s_t.Q.numpy(), np.asarray(s_j.Q), rtol=0,
                               atol=1e-9)
    assert float(aux_t.residual) < cfg_t.gmres_tol
    assert np.abs(s_t.X.numpy() - np.asarray(st_j.X)).max() > 1e-4  # moved


@pytest.mark.parametrize("shells", [0, 2])
def test_film_step_matches_float32(shells):
    cfg_t, st_j, s_j, aux_j, s_t, aux_t = _film(jnp.float32, torch.float32,
                                                shells)
    assert cfg_t.use_pallas and s_t.X.dtype == torch.float32  # kernel path
    assert aux_t.iters == int(aux_j.iters)
    assert float(aux_t.residual) < cfg_t.gmres_tol
    dX_j = np.asarray(s_j.X) - np.asarray(st_j.X)
    dX_t = s_t.X.numpy() - np.asarray(st_j.X)
    assert np.abs(dX_t - dX_j).max() / np.abs(dX_j).max() < F32_STEP_TOL
    assert np.abs(s_t.Q.numpy() - np.asarray(s_j.Q)).max() < 1e-4
