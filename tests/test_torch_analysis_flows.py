"""The port's trajectory observables (``analysis``), ambient flows
(``flows``), the resistance solve, ``structures.shell`` and
``quaternion.rotate`` on the CPU, against the JAX package on the same
numpy inputs.

The cases of ``tests/test_analysis.py``, ``tests/test_flows.py`` and
``tests/test_structures.py``'s shells on the port; the observables equal
to the JAX package's (numpy on both sides; ``axis_correlation`` to 1e-12
through the port's own rotation matrices); the flows' slips to 1e-12;
``RigidBody.solve_mobility``'s U and λ under a flow to 1e-9 absolute and
``solvers.solve_resistance``'s F and λ to 1e-9 of their max in float64;
the resistance solve inverting the mobility solve within 10·gmres_tol.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig as ConfigJ  # noqa: E402
from rigid_body_light_tpu import analysis as analysis_j  # noqa: E402
from rigid_body_light_tpu import flows as flows_j  # noqa: E402
from rigid_body_light_tpu import structures as structures_j  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin_j  # noqa: E402
from rigid_body_light_tpu.ops import quaternion as quat_j  # noqa: E402
from rigid_body_light_tpu.ops import saddle as saddle_j  # noqa: E402
from rigid_body_light_tpu.ops import solvers as solvers_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import RigidBody, SimulationConfig  # noqa: E402
from rigid_body_light_tpu_torch import analysis, flows, interop  # noqa: E402
from rigid_body_light_tpu_torch import load_structure, structures  # noqa: E402
from rigid_body_light_tpu_torch.ops import quaternion as quat  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle, solvers  # noqa: E402
from rigid_body_light_tpu_torch.state import make_state  # noqa: E402
from test_torch_noise_drift import jax_fast  # noqa: E402

SOLVE_TOL = 1e-9    # float64 solves, absolute


# --------------------------------------------------- test_analysis.py cases


def test_msd_random_walk():
    rng = np.random.default_rng(0)
    T, B, D = 2000, 8, 0.25
    dt = 1.0
    X = np.cumsum(rng.normal(0, np.sqrt(2 * D * dt), (T, B, 3)), axis=0)
    lags, m = analysis.msd(X, max_lag=50)
    assert np.allclose(m, 2 * D * lags[:, None] * dt, rtol=0.15)
    D_fit = analysis.diffusion_coefficient(X, dt, max_lag=50)
    assert abs(D_fit - D) / D < 0.1


def test_orientation_correlation_identity():
    Q = np.tile([1.0, 0, 0, 0], (100, 4, 1))
    lags, C = analysis.orientation_correlation(Q, max_lag=10)
    assert np.allclose(C, 1.0)
    Q2 = Q.copy()
    Q2[::2] *= -1
    _, C2 = analysis.orientation_correlation(Q2, max_lag=10)
    assert np.allclose(C2, 1.0)


def test_pair_distribution_ideal_gas():
    X = np.random.default_rng(1).uniform(0, 20, (40, 64, 3))
    r, g = analysis.pair_distribution(X, r_max=3.0, bins=10)
    assert np.isfinite(g).all()
    assert g.min() > 0


def test_height_histogram():
    X = np.random.default_rng(2).uniform([0, 0, 1], [5, 5, 3], (10, 50, 3))
    z, rho = analysis.height_histogram(X, bins=20)
    assert abs(np.trapezoid(rho, z) - 1.0) < 0.05
    assert (z > 0.9).all() and (z < 3.1).all()


def test_pair_distribution_wraps_with_box():
    X = np.array([[[0.2, 5.0, 2.0], [9.7, 5.0, 2.0]]])
    r_open, g_open = analysis.pair_distribution(X, r_max=2.0, bins=10)
    r_box, g_box = analysis.pair_distribution(X, r_max=2.0, bins=10,
                                              box=(10.0, 10.0))
    assert g_open.sum() == 0.0
    assert g_box[r_box < 1.0].sum() > 0


def test_observables_match_jax():
    """Every observable on one trajectory: the numpy ones equal the JAX
    package's; axis_correlation through the port's rotation matrices to
    1e-12."""
    rng = np.random.default_rng(3)
    X = np.cumsum(rng.normal(0, 0.1, (60, 5, 3)), axis=0) + [0, 0, 3]
    Q = rng.standard_normal((60, 5, 4))
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    for fn, args, kw in (
            ("msd", (X,), dict(max_lag=20)),
            ("orientation_correlation", (Q,), {}),
            ("height_histogram", (X,), dict(bins=12)),
            ("pair_distribution", (X, 4.0), dict(bins=8, box=(6.0, 7.0))),
            ("pair_distribution", (X, 4.0), dict(bins=8))):
        for a, b in zip(getattr(analysis, fn)(*args, **kw),
                        getattr(analysis_j, fn)(*args, **kw)):
            np.testing.assert_array_equal(a, b, err_msg=fn)
    assert (analysis.diffusion_coefficient(X, 0.5, skip_lags=2)
            == analysis_j.diffusion_coefficient(X, 0.5, skip_lags=2))
    for a, b in zip(analysis.axis_correlation(Q, axis=(0.3, 0.4, 0.5)),
                    analysis_j.axis_correlation(Q, axis=(0.3, 0.4, 0.5))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


# ------------------------------------------------ structures, quaternions


@pytest.mark.parametrize("n", structures.SHELLS)
def test_shells_load(n):
    params, cfg = structures.shell(n)
    assert params["N"] == n
    assert cfg.shape == (n, 3)
    assert params["Rh"] == 1
    rad = np.linalg.norm(cfg, axis=1)
    assert np.allclose(rad.mean(), params["Rg"], atol=2e-4)
    assert rad.std() < 1e-6
    d = np.linalg.norm(cfg[:, None] - cfg[None, :], axis=-1)
    d[np.arange(n), np.arange(n)] = np.inf
    assert np.isclose(d.min(), params["sep"], rtol=1e-6)
    params_j, cfg_j = structures_j.shell(n)
    assert params == params_j
    assert np.array_equal(cfg, cfg_j)


def test_shell_rejects_unknown_count():
    with pytest.raises(ValueError, match="No shipped shell"):
        structures.shell(13)


def test_rotate_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 5, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.standard_normal((2, 5, 3))
    np.testing.assert_allclose(
        quat.rotate(torch.from_numpy(q), torch.from_numpy(v)).numpy(),
        np.asarray(quat_j.rotate(jnp.asarray(q), jnp.asarray(v))),
        rtol=0, atol=1e-14)


# ------------------------------------------------------ test_flows.py cases


def _setup(X):
    params, cfgb = load_structure("shell_N_42")
    cfg = SimulationConfig(a=params["sep"] / 2, dtype=torch.float64,
                           gmres_tol=1e-10, gmres_maxiter=400)
    geom = interop.geometry_from_numpy(cfgb, dtype=torch.float64,
                                       device="cpu")
    state = make_state(np.asarray(X), [[1.0, 0, 0, 0]], dtype=torch.float64,
                       device="cpu")
    return cfg, geom, state


def _solve_force_free(cfg, geom, state, slip_fn):
    ops = saddle.geometry_ops(geom, state)
    return solvers.solve_saddle(ops, cfg, slip_fn(state),
                                torch.zeros((1, 6), dtype=torch.float64))


def test_uniform_flow_advects_force_free_body():
    cfg, geom, state = _setup([[0.0, 0.0, 0.0]])
    res = _solve_force_free(cfg, geom, state,
                            flows.uniform_flow(geom, [0.3, -0.1, 0.7]))
    assert np.allclose(res.U[0, :3].numpy(), [0.3, -0.1, 0.7], atol=1e-8)
    assert res.U[0, 3:].abs().max() < 1e-8


def test_shear_flow_translates_and_rotates():
    """A force-free sphere in shear γ̇·z·x̂ at height h translates at ~γ̇·h
    and rotates at ω_y = γ̇/2 (Faxén)."""
    h, gd = 3.0, 0.8
    cfg, geom, state = _setup([[0.0, 0.0, h]])
    res = _solve_force_free(cfg, geom, state,
                            flows.shear_flow(geom, gd, flow_axis=0,
                                             gradient_axis=2))
    U = res.U[0].numpy()
    assert abs(U[0] - gd * h) < 1e-6
    assert abs(U[4] - gd / 2) < 2e-3
    assert abs(U[2]) < 1e-8


def test_extensional_flow_stagnation_point():
    cfg, geom, state = _setup([[0.0, 0.0, 0.0]])
    res = _solve_force_free(cfg, geom, state,
                            flows.extensional_flow(geom, 0.5))
    assert res.U.abs().max() < 1e-7


# ------------------------------------------------ flows and solves vs JAX


@pytest.fixture(scope="module")
def wall64():
    """3 × shell_N_42 above the wall, float64, block_free, both packages."""
    params, ref = load_structure("shell_N_42")
    X = np.array([[0.0, 0.0, 1.7], [2.6, 0.4, 2.1], [0.3, 2.7, 2.5]])
    Q = np.random.default_rng(5).standard_normal((3, 4))
    kw = dict(a=params["sep"] / 2, wall=True, pc_mode="block_free",
              gmres_tol=1e-10, gmres_restart=20, gmres_maxiter=100)
    cfg_j = ConfigJ(dtype=jnp.float64, **kw)
    geom_j = kin_j.make_ref_geometry(ref, dtype=jnp.float64)
    st_j = make_state_j(X, Q, dtype=jnp.float64)
    rb_t = RigidBody(ref, X, Q, kw["a"], 1.0, 0.01,
                     config=SimulationConfig(dtype=torch.float64, **kw),
                     device="cpu")
    return cfg_j, geom_j, st_j, rb_t


@pytest.mark.parametrize("flow", ["shear", "extensional", "uniform"])
def test_flow_slips_match_jax(wall64, flow):
    cfg_j, geom_j, st_j, rb_t = wall64
    make = {"shear": lambda m, g: m.shear_flow(g, 0.7, 1, 2),
            "extensional": lambda m, g: m.extensional_flow(g, -0.4),
            "uniform": lambda m, g: m.uniform_flow(g, [0.1, 0.2, -0.3])}[flow]
    slip_j = make(flows_j, geom_j)(st_j, 0)
    slip_t = make(flows, rb_t._geom)(rb_t.state, 0)
    assert slip_t.shape == (rb_t.total_blobs, 3)
    np.testing.assert_allclose(slip_t.numpy(), np.asarray(slip_j), rtol=0,
                               atol=1e-12)


def test_solves_match_jax(wall64):
    """RigidBody.solve_mobility under a shear slip (what the JAX
    RigidBody.solve_mobility runs: solve_saddle with its PC), U and λ to
    1e-9; solve_resistance (unpreconditioned GMRES on M, forces ~50 here),
    F and λ to 1e-9 of their max."""
    cfg_j, geom_j, st_j, rb_t = wall64
    rng = np.random.default_rng(6)
    force = rng.standard_normal((3, 6))
    slip_j = flows_j.shear_flow(geom_j, 0.7)(st_j, 0)
    ops_j = saddle_j.geometry_ops(geom_j, st_j)
    res_j = jax_fast(lambda o, s, f: solvers_j.solve_saddle(
        o, cfg_j, s, f, pc=saddle_j.build_pc(o, cfg_j)), ops_j, slip_j,
        jnp.asarray(force))
    U_t, lam_t, resid = rb_t.solve_mobility(force, slip=np.array(slip_j))
    np.testing.assert_allclose(U_t, np.asarray(res_j.U), rtol=0,
                               atol=SOLVE_TOL)
    np.testing.assert_allclose(lam_t, np.asarray(res_j.lam), rtol=0,
                               atol=SOLVE_TOL)
    assert resid < cfg_j.gmres_tol
    U = rng.standard_normal((3, 6))
    F_j, lamr_j, r_j = jax_fast(lambda o, u, s: solvers_j.solve_resistance(
        o, cfg_j, u, slip=s), ops_j, jnp.asarray(U), slip_j)
    F_t, lamr_t, r_t = solvers.solve_resistance(
        rb_t._ops, rb_t.config, U, slip=np.array(slip_j))
    F_j = np.asarray(F_j)
    assert np.abs(F_t.numpy() - F_j).max() < SOLVE_TOL * np.abs(F_j).max()
    lamr_j = np.asarray(lamr_j)
    assert (np.abs(lamr_t.numpy() - lamr_j).max()
            < SOLVE_TOL * np.abs(lamr_j).max())
    assert float(r_t) < cfg_j.gmres_tol


def test_resistance_inverts_mobility():
    """solve_resistance(solve_mobility(F).U) gives back F: each solve stops
    at relative residual gmres_tol, so at a loose 1e-4 the round trip is
    held to 10·gmres_tol of max|F| (float64, dense slice's settings at 4 ×
    shell_N_42)."""
    params, ref = load_structure("shell_N_42")
    X = np.array([[2.5 * (i % 2), 2.5 * (i // 2), 2.0 + 0.2 * i]
                  for i in range(4)])
    cfg = SimulationConfig(a=params["sep"] / 2, wall=True,
                           dtype=torch.float64, pc_mode="block_free",
                           gmres_tol=1e-4, gmres_restart=20, gmres_maxiter=60)
    rb = RigidBody(ref, X, np.tile([1.0, 0, 0, 0], (4, 1)), cfg.a, 1.0, 0.01,
                   config=cfg, device="cpu")
    F = np.random.default_rng(7).standard_normal((4, 6))
    U, _, _ = rb.solve_mobility(F)
    F_back, _, r = solvers.solve_resistance(rb._ops, rb.config, U)
    assert float(r) < cfg.gmres_tol
    assert np.abs(F_back.numpy() - F).max() < 10 * cfg.gmres_tol * \
        np.abs(F).max()
