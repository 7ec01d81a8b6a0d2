"""Port parity of one float32 fluctuating BD step against the JAX package,
from identical Gaussian draws (the slice's working precision).

Tolerance: the two float32 solves stop at gmres_tol = 1e-4 with different
roundoff, and the RFD drift divides a difference of two mobility products
by rfd_delta = 1e-4, amplifying their float32 roundoff (~6e-8) about 1e4
times.  Measured on this system over six keys: ΔX agrees to 1.1e-4 to
4.4e-4 of max|ΔX|, with equal GMRES iteration counts; the bound is 2e-3.
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

B = 4
F32_STEP_TOL = 2e-3   # max|ΔX_port − ΔX_jax| / max|ΔX_jax|, see above


def test_stochastic_step_matches_float32():
    params, ref = load_structure("shell_N_42")
    n = ref.shape[0]
    X = np.array([[2.5 * (i % 2), 2.5 * (i // 2), 1.6 + 0.3 * i]
                  for i in range(B)])
    Q = np.random.default_rng(4).standard_normal((B, 4))
    cfg_j = SimulationConfig(a=params["sep"] / 2, dt=0.01, kBT=1.0,
                             wall=True, dtype=jnp.float32, lanczos_iters=6,
                             gmres_tol=1e-4, gmres_restart=20,
                             gmres_maxiter=60, pc_mode="block_free")
    geom_j = kin_j.make_ref_geometry(ref, dtype=jnp.float32)
    st_j = make_state_j(X, Q, dtype=jnp.float32)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    assert cfg_t.use_pallas and cfg_t.dtype == torch.float32  # kernel path
    geom_t = interop.geometry_from_numpy(ref)
    st_t = interop.state_from_numpy(st_j.X, st_j.Q)
    force = np.zeros((B, 6), np.float32)
    force[:, 2] = -1.0

    key = jax.random.key(3)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (np.array(jax.random.normal(k1, (B * 3 * n,), jnp.float32)),
             np.array(jax.random.normal(k2, (B * 3 * n,), jnp.float32)),
             np.array(jax.random.normal(k3, (B, n, 3), jnp.float32)))
    s_j, aux_j = jax.jit(functools.partial(step_j, geom_j, cfg_j))(
        st_j, key, jnp.asarray(force))
    s_t, aux_t = step_t(geom_t, cfg_t, st_t, torch.from_numpy(force),
                        draws=draws)

    assert s_t.X.dtype == torch.float32
    assert aux_t.iters == int(aux_j.iters)
    assert float(aux_t.residual) < cfg_t.gmres_tol
    dX_j = np.asarray(s_j.X) - np.asarray(st_j.X)
    dX_t = s_t.X.numpy() - st_t.X.numpy()
    assert np.abs(dX_t - dX_j).max() / np.abs(dX_j).max() < F32_STEP_TOL
    assert np.abs(s_t.Q.numpy() - np.asarray(s_j.Q)).max() < 1e-4
    np.testing.assert_allclose(torch.linalg.norm(s_t.Q, dim=1).numpy(), 1.0,
                               atol=1e-6)
