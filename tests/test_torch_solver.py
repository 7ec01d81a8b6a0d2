"""Port parity of the saddle operator, the preconditioners, GMRES and the
saddle solve against the JAX package, float64, same numpy inputs."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig, load_structure  # noqa: E402
from rigid_body_light_tpu.dynamics import deterministic_step as det_j  # noqa: E402
from rigid_body_light_tpu.ops import gmres as gmres_j  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin_j  # noqa: E402
from rigid_body_light_tpu.ops import saddle as saddle_j  # noqa: E402
from rigid_body_light_tpu.ops import solvers as solvers_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import deterministic_step as det_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import gmres as gmres_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as saddle_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import solvers as solvers_t  # noqa: E402

B = 4


@pytest.fixture(scope="module")
def system():
    """4 × shell_N_42 above the wall, float64, both packages."""
    params, ref = load_structure("shell_N_42")
    rng = np.random.default_rng(11)
    X = np.array([[2.5 * (i % 2), 2.5 * (i // 2), 1.6 + 0.3 * i]
                  for i in range(B)])
    Q = rng.standard_normal((B, 4))
    cfg_j = SimulationConfig(a=params["sep"] / 2, wall=True,
                             dtype=jnp.float64, pc_mode="block_free",
                             gmres_tol=1e-8, gmres_restart=10,
                             gmres_maxiter=40)
    st_j = make_state_j(X, Q, dtype=jnp.float64)
    geom_j = kin_j.make_ref_geometry(ref, dtype=jnp.float64)
    ops_j = saddle_j.geometry_ops(geom_j, st_j)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    geom_t = interop.geometry_from_numpy(ref, dtype=torch.float64)
    st_t = interop.state_from_numpy(st_j.X, st_j.Q, dtype=torch.float64)
    ops_t = saddle_t.geometry_ops(geom_t, st_t)
    N = B * ref.shape[0]
    return types.SimpleNamespace(
        cfg_j=cfg_j, geom_j=geom_j, st_j=st_j, ops_j=ops_j, cfg_t=cfg_t,
        geom_t=geom_t, st_t=st_t, ops_t=ops_t,
        slip=rng.standard_normal((N, 3)) * 0.1,
        force=rng.standard_normal((B, 6)))


def _rel(t, j):
    j = np.asarray(j)
    return np.abs(np.asarray(t) - j).max() / np.abs(j).max()


@pytest.mark.parametrize("mode", ["block_free", "diag", "block"])
def test_pc_build_and_apply_match(system, mode):
    ops_j, ops_t, slip, force = (system.ops_j, system.ops_t, system.slip,
                                 system.force)
    cfg_j = system.cfg_j.replace(pc_mode=mode)
    cfg_t = system.cfg_t.replace(pc_mode=mode)
    pc_j = saddle_j.build_pc(ops_j, cfg_j)
    pc_t = saddle_t.build_pc(ops_t, cfg_t)
    for name in ("minv_ref", "n_ref", "n_mat", "inv_m_block", "inv_m_diag"):
        a, b = getattr(pc_t, name), getattr(pc_j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert _rel(a, b) < 1e-10, name
    lam_j, U_j = saddle_j.apply_pc(pc_j, jnp.asarray(slip), jnp.asarray(force),
                                   ops_j, cfg_j)
    lam_t, U_t = saddle_t.apply_pc(pc_t, torch.from_numpy(slip),
                                   torch.from_numpy(force), ops_t, cfg_t)
    assert _rel(lam_t, lam_j) < 1e-10
    assert _rel(U_t, U_j) < 1e-10


def test_apply_saddle_matches(system):
    s = system
    s_j, f_j = saddle_j.apply_saddle(jnp.asarray(s.slip), jnp.asarray(s.force),
                                     s.ops_j, s.cfg_j)
    s_t, f_t = saddle_t.apply_saddle(torch.from_numpy(s.slip),
                                     torch.from_numpy(s.force), s.ops_t,
                                     s.cfg_t)
    assert _rel(s_t, s_j) < 1e-12
    assert _rel(f_t, f_j) < 1e-12


def test_gmres_matches_with_equal_iters():
    """A nonsymmetric, mildly conditioned system solved across two restart
    cycles: same x to roundoff and the same executed-iteration count."""
    rng = np.random.default_rng(2)
    n = 60
    A = np.eye(n) * 3.0 + rng.standard_normal((n, n)) * 0.2
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n) * 0.1
    res_j = gmres_j.gmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                          x0=jnp.asarray(x0), tol=1e-10, restart=8,
                          max_restarts=10)
    At = torch.from_numpy(A)
    res_t = gmres_t.gmres(lambda x: At @ x, torch.from_numpy(b),
                          x0=torch.from_numpy(x0), tol=1e-10, restart=8,
                          max_restarts=10)
    assert res_t.iters == int(res_j.iters)
    assert _rel(res_t.x, res_j.x) < 1e-12
    assert float(res_t.residual) < 1e-10
    np.testing.assert_allclose(float(res_t.residual), float(res_j.residual),
                               rtol=1e-3)


def test_solve_saddle_matches_with_equal_iters(system):
    cfg_j, ops_j, cfg_t, ops_t = (system.cfg_j, system.ops_j, system.cfg_t,
                                  system.ops_t)
    slip, force = system.slip, system.force
    pc_j = saddle_j.build_pc(ops_j, cfg_j)
    res_j = solvers_j.solve_saddle(ops_j, cfg_j, jnp.asarray(slip),
                                   jnp.asarray(force), pc=pc_j,
                                   true_residual=True)
    pc_t = interop.pc_from_numpy(pc_j.minv_ref, pc_j.n_ref,
                                 dtype=torch.float64)
    res_t = solvers_t.solve_saddle(ops_t, cfg_t, torch.from_numpy(slip),
                                   torch.from_numpy(force), pc=pc_t,
                                   true_residual=True)
    assert res_t.iters == int(res_j.iters)
    assert _rel(res_t.U, res_j.U) < 1e-9
    assert _rel(res_t.lam, res_j.lam) < 1e-9
    assert float(res_t.residual) < cfg_t.gmres_tol
    assert float(res_t.true_residual) < 1e-6
    # the warm start from the converged answer needs no iteration
    warm = solvers_t.solve_saddle(ops_t, cfg_t, torch.from_numpy(slip),
                                  torch.from_numpy(force), pc=pc_t,
                                  x0=(res_t.lam, res_t.U))
    assert warm.iters == 0


@pytest.mark.parametrize("solve_kw", [
    dict(),
    # two GMRES iterations cannot reach 1e-12: the residual guard must
    # reject the step (no move) on both sides
    dict(gmres_tol=1e-12, gmres_restart=2, gmres_maxiter=2,
         max_step_residual=1e-10),
], ids=["converged", "rejected"])
def test_deterministic_step_matches(system, solve_kw):
    s = system
    cfg_j = s.cfg_j.replace(dt=0.05, **solve_kw)
    cfg_t = s.cfg_t.replace(dt=0.05, **solve_kw)
    s_j, aux_j = jax.jit(
        lambda st, f, sl: det_j(s.geom_j, cfg_j, st, f, sl))(
            s.st_j, jnp.asarray(s.force), jnp.asarray(s.slip))
    s_t, aux_t = det_t(s.geom_t, cfg_t, s.st_t, torch.from_numpy(s.force),
                       slip=torch.from_numpy(s.slip))
    assert aux_t.iters == int(aux_j.iters)
    np.testing.assert_allclose(s_t.X.numpy(), np.asarray(s_j.X), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(s_t.Q.numpy(), np.asarray(s_j.Q), rtol=0,
                               atol=1e-9)
    converged = float(aux_t.residual) < cfg_t.max_step_residual
    assert converged == (not solve_kw)
    assert bool((s_t.X != s.st_t.X).any()) == converged
