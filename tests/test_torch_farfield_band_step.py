"""Port parity of one fluctuating BD step on the far field with its band
tier (``farfield_band_p``) against the JAX package, float64, from the
Gaussian draws the JAX step makes from its key: the pinned geometry tier
carries the band blocks, and every sub-solve (the fused two-draw noise,
RFD's displaced applies, the half-kick solve) goes through the two-tier
operator.  X and Q to 1e-9 with equal GMRES iterations.  The JAX step is
compiled at XLA's cheapest CPU optimization (:func:`jax_fast`).
"""

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
from rigid_body_light_tpu_torch.dynamics import run_bd  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import stochastic_step as step_t  # noqa: E402
from rigid_body_light_tpu_torch.utils import profiling  # noqa: E402

B = 4
STATE_TOL = 1e-9
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def jax_step_draws(key, n):
    """The (W1, W2, W_rfd) that the JAX stochastic_step draws from ``key``."""
    k1, k2, k3 = jax.random.split(key, 3)
    return (np.array(jax.random.normal(k1, (B * 3 * n,), jnp.float64)),
            np.array(jax.random.normal(k2, (B * 3 * n,), jnp.float64)),
            np.array(jax.random.normal(k3, (B, n, 3), jnp.float64)))


@pytest.fixture(scope="module")
def system():
    """4 × shell_N_42 above the wall on a (4, 4, 2) grid, p = 3 with a
    band at order 4 (offsets 2 and 3 in x and y), float64; a tight
    gmres_tol so both packages solve the same approximate operator to
    roundoff (the operator-error warning is expected)."""
    params, ref = load_structure("shell_N_42")
    X = np.array([[3.0 * (i % 2), 3.0 * (i // 2), 1.6 + 0.3 * i]
                  for i in range(B)])
    Q = np.random.default_rng(4).standard_normal((B, 4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cfg_j = SimulationConfig(a=params["sep"] / 2, dt=0.01, kBT=1.0,
                                 wall=True, dtype=jnp.float64,
                                 lanczos_iters=6, gmres_tol=1e-8,
                                 gmres_restart=20, gmres_maxiter=60,
                                 pc_mode="block_free",
                                 farfield_grid=(4, 4, 2), farfield_p=3,
                                 farfield_band_p=4)
        cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    geom_j = kin_j.make_ref_geometry(ref, dtype=jnp.float64)
    st_j = make_state_j(X, Q, dtype=jnp.float64)
    geom_t = interop.geometry_from_numpy(ref, dtype=torch.float64,
                                         device="cpu")
    st_t = interop.state_from_numpy(st_j.X, st_j.Q, dtype=torch.float64,
                                    device="cpu")
    force = np.zeros((B, 6))
    force[:, 2] = -1.0
    return cfg_j, geom_j, st_j, cfg_t, geom_t, st_t, force, ref.shape[0]


def test_band_stochastic_step_matches_float64(system):
    cfg_j, geom_j, st_j, cfg_t, geom_t, st_t, force, n = system
    key = jax.random.key(5)
    s_j, aux_j = jax_fast(functools.partial(step_j, geom_j, cfg_j),
                          st_j, key, jnp.asarray(force))
    s_t, aux_t = step_t(geom_t, cfg_t, st_t, torch.from_numpy(force),
                        draws=jax_step_draws(key, n))
    assert aux_t.iters == int(aux_j.iters)
    np.testing.assert_allclose(s_t.X.numpy(), np.asarray(s_j.X), rtol=0,
                               atol=STATE_TOL)
    np.testing.assert_allclose(s_t.Q.numpy(), np.asarray(s_j.Q), rtol=0,
                               atol=STATE_TOL)
    assert float(aux_t.residual) < cfg_t.gmres_tol
    assert np.abs(s_t.X.numpy() - np.asarray(st_j.X)).max() > 1e-4  # moved


def test_band_run_bd_marks_the_band_span(system):
    """run_bd on the band tier: the step timer sees the ``far_band`` span
    inside the mobility products, and the band changes the step (it is not
    the p = 3 operator's)."""
    _, _, _, cfg_t, geom_t, st_t, force, _ = system
    F = torch.from_numpy(force)
    with profiling.StepTimer(device="cpu") as timer:
        s_b, _ = run_bd(geom_t, cfg_t, st_t, 1, force_fn=lambda s, i: F,
                        generator=torch.Generator().manual_seed(3))
    split = timer.split()
    assert split["far_band"]["count"] > 0 and "mobility" in split
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cfg_p = cfg_t.replace(farfield_band_p=0)
    s_p, _ = run_bd(geom_t, cfg_p, st_t, 1,
                    force_fn=lambda s, i: F,
                    generator=torch.Generator().manual_seed(3))
    assert float((s_b.X - s_p.X).abs().max()) > 1e-8
