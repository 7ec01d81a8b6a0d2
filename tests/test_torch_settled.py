"""Port parity of the settled-suspension slice against the JAX package on
the CPU: the halo coupling blocks (``rpy.cross_mobility_blocks``), the RAS
preconditioner (``saddle.build_pc_ras``), a RAS saddle solve, the adaptive
Lanczos recurrence and one settled ``stochastic_step`` (RAS, adaptive
Lanczos, gravity and wall repulsion), in float64 and in float32.

The system is the JAX package's small settled layer
(``tests/test_solver.py::_settled_layer``): 12-blob shells on a dense
near-wall lattice, made here from the same numpy seed for both packages.
The Gaussian draws of a step are the ones the JAX step makes from its key
(``split(key, 3)``), handed to the port as numpy arrays.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig, forces as forces_j  # noqa: E402
from rigid_body_light_tpu import load_structure  # noqa: E402
from rigid_body_light_tpu.dynamics import stochastic_step as step_j  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin_j  # noqa: E402
from rigid_body_light_tpu.ops import lanczos as lanczos_j  # noqa: E402
from rigid_body_light_tpu.ops import rpy as rpy_j  # noqa: E402
from rigid_body_light_tpu.ops import saddle as saddle_j  # noqa: E402
from rigid_body_light_tpu.ops import solvers as solvers_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import SimulationConfig as CfgT  # noqa: E402
from rigid_body_light_tpu_torch import forces as forces_t  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import stochastic_step as step_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import lanczos as lanczos_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import rpy as rpy_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as saddle_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import solvers as solvers_t  # noqa: E402

# float32 step against the JAX float32 step, max|ΔX_t − ΔX_j| / max|ΔX_j|:
# the bound of tests/test_torch_step_f32.py (two float32 solves stopped at
# gmres_tol, the RFD drift's 1/rfd_delta = 1e4 amplification of roundoff)
F32_STEP_TOL = 2e-3
RAS = dict(pc_mode="ras", pc_halo=4.0, pc_halo_max=16)


def settled_layer(B=8, spacing=2.3, z=1.35, seed=11, shell="shell_N_12",
                  dtype="float64", **cfg_kw):
    """``tests/test_solver.py::_settled_layer`` in both packages: B shells on
    a 4-wide lattice at ``spacing``, height ``z``, jittered from ``seed``.
    Returns (cfg_j, geom_j, state_j, cfg_t, geom_t, state_t)."""
    params, ref = load_structure(shell)
    rng = np.random.default_rng(seed)
    xs = np.array([[spacing * (i % 4), spacing * (i // 4), z]
                   for i in range(B)], float)
    xs[:, :2] += 0.1 * rng.standard_normal((B, 2))
    xs[:, 2] += 0.05 * rng.standard_normal(B)
    qs = rng.standard_normal((B, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    jdt = getattr(jnp, dtype)
    kw = dict(wall=True, dtype=jdt, gmres_tol=1e-8, gmres_maxiter=200,
              a=params["sep"] / 2)
    kw.update(cfg_kw)
    cfg_j = SimulationConfig(**kw)
    geom_j = kin_j.make_ref_geometry(ref, dtype=jdt)
    st_j = make_state_j(xs, qs, dtype=jdt)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    tdt = getattr(torch, dtype)
    geom_t = interop.geometry_from_numpy(ref, dtype=tdt, device="cpu")
    st_t = interop.state_from_numpy(np.asarray(st_j.X), np.asarray(st_j.Q),
                                    dtype=tdt, device="cpu")
    return cfg_j, geom_j, st_j, cfg_t, geom_t, st_t


@pytest.fixture(scope="module")
def layer():
    return settled_layer()


def _rel(t, j):
    j = np.asarray(j)
    return np.abs(np.asarray(t) - j).max() / np.abs(j).max()


def _ops(layer):
    cfg_j, geom_j, st_j, cfg_t, geom_t, st_t = layer
    return (saddle_j.geometry_ops(geom_j, st_j),
            saddle_t.geometry_ops(geom_t, st_t))


@pytest.mark.parametrize("wall", [True, False])
def test_cross_mobility_blocks_match(layer, wall):
    """Body blobs against a halo of other positions, some of them below
    the wall-height floor, float64."""
    ops_j, ops_t = _ops(layer)
    a = layer[0].a
    rng = np.random.default_rng(1)
    rj = rng.uniform([-1, -1, 0.1 * a], [8, 6, 3], (8, 10, 3))
    M_j = rpy_j.cross_mobility_blocks(ops_j.positions, jnp.asarray(rj), a,
                                      1.0, wall=wall)
    M_t = rpy_t.cross_mobility_blocks(ops_t.positions, torch.from_numpy(rj),
                                      a, 1.0, wall=wall)
    assert M_t.shape == M_j.shape == (8, 12, 10, 3, 3)
    assert _rel(M_t, M_j) < 1e-12
    # per-blob radii all equal to a: the polydisperse blocks (the mixture
    # RAS halos', tests/test_torch_poly.py) reduce to these
    eq = dict(radii_i=torch.full((8, 12), a, dtype=torch.float64),
              radii_j=torch.full((8, 10), a, dtype=torch.float64))
    M_p = rpy_t.cross_mobility_blocks(ops_t.positions, torch.from_numpy(rj),
                                      a, 1.0, wall=wall, **eq)
    assert _rel(M_p, M_j) < 1e-12


def test_build_pc_ras_matches(layer):
    cfg_j, _, _, cfg_t, _, _ = layer
    ops_j, ops_t = _ops(layer)
    pc_j = saddle_j.build_pc_ras(ops_j, cfg_j.replace(**RAS))
    pc_t = saddle_t.build_pc_ras(ops_t, cfg_t.replace(**RAS))
    assert pc_t.halo_idx.shape == (8, 16)
    np.testing.assert_array_equal(pc_t.halo_idx.numpy(),
                                  np.asarray(pc_j.halo_idx))
    for name in ("halo_w", "halo_sinv", "n_full", "minv_ref", "n_ref"):
        assert _rel(getattr(pc_t, name), getattr(pc_j, name)) < 1e-10, name


def test_ras_solve_matches(layer):
    """A RAS saddle solve from random slip and force: equal GMRES
    iterations, U and λ to 1e-9 of their scale; fewer iterations than
    block_free, as tests/test_solver.py requires of the JAX package."""
    cfg_j, _, _, cfg_t, _, _ = layer
    ops_j, ops_t = _ops(layer)
    B, n = 8, 12
    rng = np.random.default_rng(3)
    slip = rng.standard_normal((B * n, 3))
    force = rng.standard_normal((B, 6))
    res_j = solvers_j.solve_saddle(ops_j, cfg_j.replace(**RAS),
                                   jnp.asarray(slip), jnp.asarray(force))
    res_t = solvers_t.solve_saddle(ops_t, cfg_t.replace(**RAS),
                                   torch.from_numpy(slip),
                                   torch.from_numpy(force))
    assert res_t.iters == int(res_j.iters)
    assert float(res_t.residual) < cfg_t.gmres_tol
    assert _rel(res_t.U, res_j.U) < 1e-9
    assert _rel(res_t.lam, res_j.lam) < 1e-9
    res_bf = solvers_t.solve_saddle(ops_t, cfg_t.replace(pc_mode="block_free"),
                                    torch.from_numpy(slip),
                                    torch.from_numpy(force))
    assert res_t.iters < res_bf.iters
    assert _rel(res_t.U, res_bf.U.numpy()) < 1e-6


def test_ras_per_body_build_equals_batched(layer, monkeypatch):
    """Past ``_RAS_BATCH_BYTES`` of K columns ``build_pc_ras`` builds the
    consistent Ñ body by body: with the limit at 0 its factors equal the
    batched build's to 1e-12 (Ñ differs in its last bits: another batching
    of the same products), float64, and a RAS solve through each takes the
    same iterations, U and λ to 1e-10 (GMRES at gmres_tol 1e-8 carries
    that last-bit change of Ñ to ~1e-12)."""
    cfg_t = layer[3].replace(**RAS)
    _, ops_t = _ops(layer)
    pc_batch = saddle_t.build_pc_ras(ops_t, cfg_t)
    monkeypatch.setattr(saddle_t, "_RAS_BATCH_BYTES", 0)
    pc_body = saddle_t.build_pc_ras(ops_t, cfg_t)
    assert torch.equal(pc_body.halo_idx, pc_batch.halo_idx)
    for name in ("halo_w", "halo_sinv", "n_full"):
        assert _rel(getattr(pc_body, name), getattr(pc_batch, name)) < 1e-12
    rng = np.random.default_rng(4)
    slip = torch.from_numpy(rng.standard_normal((8 * 12, 3)))
    force = torch.from_numpy(rng.standard_normal((8, 6)))
    res_batch = solvers_t.solve_saddle(ops_t, cfg_t, slip, force,
                                       pc=pc_batch)
    res_body = solvers_t.solve_saddle(ops_t, cfg_t, slip, force, pc=pc_body)
    assert res_body.iters == res_batch.iters
    assert _rel(res_body.U, res_batch.U) < 1e-10
    assert _rel(res_body.lam, res_batch.lam) < 1e-10


def test_ras_reduces_to_block_free_when_dispersed():
    """Bodies farther apart than the halo cutoff: every halo slot masks
    out and the RAS solve is the block_free solve (the property of
    tests/test_solver.py::test_ras_pc_reduces_to_block_free_when_dispersed),
    in the port and in the JAX package alike."""
    cfg_j, geom_j, st_j, cfg_t, geom_t, st_t = settled_layer(spacing=9.0,
                                                             z=4.0)
    ops_j = saddle_j.geometry_ops(geom_j, st_j)
    ops_t = saddle_t.geometry_ops(geom_t, st_t)
    rng = np.random.default_rng(5)
    slip = torch.from_numpy(rng.standard_normal((96, 3)))
    force = torch.from_numpy(rng.standard_normal((8, 6)))
    ras = dict(pc_mode="ras", pc_halo=2.0, pc_halo_max=8)
    pc = saddle_t.build_pc_ras(ops_t, cfg_t.replace(**ras))
    assert (pc.halo_w == 0).all()         # no halo slot within the cutoff
    res_bf = solvers_t.solve_saddle(ops_t, cfg_t.replace(pc_mode="block_free"),
                                    slip, force)
    res_ras = solvers_t.solve_saddle(ops_t, cfg_t.replace(**ras), slip, force)
    res_j = solvers_j.solve_saddle(ops_j, cfg_j.replace(**ras),
                                   jnp.asarray(slip.numpy()),
                                   jnp.asarray(force.numpy()))
    assert res_ras.iters == res_bf.iters == int(res_j.iters)
    np.testing.assert_allclose(res_ras.U.numpy(), res_bf.U.numpy(), atol=1e-9)


@pytest.mark.parametrize("err_tol", [1e-3, 1e-6])
def test_adaptive_lanczos_matches(err_tol):
    """The adaptive recurrence on an SPD operator whose square root needs
    more than ``iters`` iterations: the same iterations run (counted in
    the JAX loop by a debug callback), the same output and error to 1e-10;
    1e-6 runs to the cap."""
    rng = np.random.default_rng(7)
    sz = 80
    Qm, _ = np.linalg.qr(rng.standard_normal((sz, sz)))
    A = (Qm * np.geomspace(1e-2, 1.0, sz)) @ Qm.T
    W = rng.standard_normal((2, sz))
    calls = []

    def mv_j(vk):
        jax.debug.callback(lambda: calls.append(1))
        return vk @ jnp.asarray(A)

    out_j, err_j = lanczos_j.sqrt_matvec_batched(
        mv_j, jnp.asarray(W), iters=4, max_iters=14, err_tol=err_tol,
        return_err=True)
    jax.effects_barrier()
    out_t, err_t, s_t = lanczos_t.sqrt_matvec_batched(
        lambda vk: vk @ torch.from_numpy(A), torch.from_numpy(W), iters=4,
        max_iters=14, err_tol=err_tol, return_err=True, return_iters=True)
    assert 4 < s_t <= 14 and s_t == len(calls)
    if err_tol < 1e-5:
        assert s_t == 14
    else:
        assert s_t < 14 and float(err_t.max()) <= err_tol
    assert _rel(out_t, out_j) < 1e-10
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=1e-10)


def _settled_forces():
    g = np.array([0, 0, -1.0, 0, 0, 0])
    return (forces_j.sum_forces(forces_j.gravity(g),
                                forces_j.wall_repulsion(4.0, 0.3, 1.0)),
            forces_t.sum_forces(forces_t.gravity(g),
                                forces_t.wall_repulsion(4.0, 0.3, 1.0)))


def _jax_draws(key, B, n, dtype):
    k1, k2, k3 = jax.random.split(key, 3)
    return (np.array(jax.random.normal(k1, (B * 3 * n,), dtype)),
            np.array(jax.random.normal(k2, (B * 3 * n,), dtype)),
            np.array(jax.random.normal(k3, (B, n, 3), dtype)))


STEP = dict(kBT=1.0, dt=0.01, lanczos_iters=6, lanczos_max_iters=14,
            lanczos_err_tol=1e-5, gmres_restart=60, gmres_maxiter=60, **RAS)


def _count_lanczos(monkeypatch):
    """Record the iterations of every Lanczos recurrence the port runs."""
    runs = []
    inner = lanczos_t.sqrt_matvec_batched

    def counted(*args, return_err=False, **kw):
        out = inner(*args, return_err=return_err, return_iters=True, **kw)
        runs.append(out[-1])
        return out[:-1] if return_err else out[0]

    monkeypatch.setattr(lanczos_t, "sqrt_matvec_batched", counted)
    return runs


def test_settled_step_matches_float64(monkeypatch):
    """One settled step (RAS, adaptive Lanczos, gravity + wall repulsion)
    from identical draws: X, Q to 1e-9, equal GMRES iterations, the noise
    estimate to 1e-6 relative; the adaptive recurrence ran past its 6
    fixed iterations (an err_tol of 1e-5 on this layer)."""
    runs = _count_lanczos(monkeypatch)
    cfg_j, geom_j, st_j, cfg_t, geom_t, st_t = settled_layer(**STEP)
    f_j, f_t = _settled_forces()
    key = jax.random.key(5)
    s_j, aux_j = jax.jit(functools.partial(step_j, geom_j, cfg_j))(
        st_j, key, f_j(st_j, 0))
    force_t = f_t(st_t, 0)
    assert _rel(force_t, f_j(st_j, 0)) < 1e-14
    s_t, aux_t = step_t(geom_t, cfg_t, st_t, force_t,
                        draws=_jax_draws(key, 8, 12, jnp.float64))
    assert len(runs) == 1 and 6 < runs[0] <= 14, runs
    assert aux_t.iters == int(aux_j.iters)
    np.testing.assert_allclose(s_t.X.numpy(), np.asarray(s_j.X), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(s_t.Q.numpy(), np.asarray(s_j.Q), rtol=0,
                               atol=1e-9)
    assert float(aux_t.residual) < cfg_t.gmres_tol
    np.testing.assert_allclose(float(aux_t.noise_err),
                               float(aux_j.noise_err), rtol=1e-6)
    assert np.abs(s_t.X.numpy() - np.asarray(st_j.X)).max() > 1e-4  # moved


def test_settled_step_matches_float32():
    """The same step in float32 at tests/test_torch_step_f32.py's bounds:
    ΔX within 2e-3 of max|ΔX|, equal GMRES iterations, Q to 1e-4, unit
    quaternions."""
    cfg_j, geom_j, st_j, cfg_t, geom_t, st_t = settled_layer(
        dtype="float32", **dict(STEP, gmres_tol=1e-4, lanczos_err_tol=1e-3))
    assert cfg_t.use_pallas and cfg_t.dtype == torch.float32  # kernel path
    f_j, f_t = _settled_forces()
    key = jax.random.key(3)
    s_j, aux_j = jax.jit(functools.partial(step_j, geom_j, cfg_j))(
        st_j, key, f_j(st_j, 0))
    s_t, aux_t = step_t(geom_t, cfg_t, st_t, f_t(st_t, 0),
                        draws=_jax_draws(key, 8, 12, jnp.float32))
    assert s_t.X.dtype == torch.float32
    assert aux_t.iters == int(aux_j.iters)
    assert float(aux_t.residual) < cfg_t.gmres_tol
    dX_j = np.asarray(s_j.X) - np.asarray(st_j.X)
    dX_t = s_t.X.numpy() - st_t.X.numpy()
    assert np.abs(dX_t - dX_j).max() / np.abs(dX_j).max() < F32_STEP_TOL
    assert np.abs(s_t.Q.numpy() - np.asarray(s_j.Q)).max() < 1e-4
    np.testing.assert_allclose(torch.linalg.norm(s_t.Q, dim=1).numpy(), 1.0,
                               atol=1e-6)


def test_config_takes_the_settled_configuration():
    """The settled configuration builds; a lagged RAS halo tier is still
    refused, as in the JAX package."""
    cfg = CfgT(pc_mode="ras", pc_halo=8.0, pc_halo_max=64, lanczos_iters=6,
               lanczos_max_iters=14, lanczos_err_tol=1e-3, gmres_tol=3e-4,
               gmres_restart=60)
    assert cfg.pc_mode == "ras" and cfg.lanczos_max_iters == 14
    with pytest.raises(ValueError, match="pc_refresh"):
        CfgT(pc_mode="ras", pc_refresh=2, lanczos_iters=6,
             lanczos_max_iters=14, lanczos_err_tol=1e-3)
    with pytest.raises(ValueError, match="pc_refresh"):
        SimulationConfig(pc_mode="ras", pc_refresh=2)
