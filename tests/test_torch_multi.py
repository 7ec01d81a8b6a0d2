"""Port parity of mixtures (``multi.py``) against the JAX package on the CPU,
float64: the mixed saddle solve, one ``stochastic_step_multi`` and a 3-step
``run_bd_multi`` of a polydisperse two-species mixture from the JAX
package's own draws, the mixture RAS preconditioner, and a one-species
mixture against the single-species solve.

The mixture: 3 × shell_N_12 at the configuration's blob radius a and
2 × shell_N_42 scaled by 0.6 with their own blob radius, half their scaled
blob spacing (run.py's rule for a species' "blob_radius"), above the wall.
The JAX run's draws are rebuilt from its key splits (a step key per step,
``split(key)``; three draws a step, ``split(step_key, 3)``) and handed to
the port as numpy arrays.  One jitted JAX run serves the step and the
trajectory tests: its first step is the stochastic step from a zero warm
start and the static ``block_free`` PC.  The JAX references are compiled
at XLA's cheapest CPU optimization (:func:`jax_fast`): half the compile
time, results within 1e-11 of the default compile's.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig, load_structure  # noqa: E402
from rigid_body_light_tpu import multi as multi_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch import multi as multi_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as saddle_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import solvers as solvers_t  # noqa: E402

N_STEPS = 3
SCALE_1 = 0.6
# the mixture solve against the JAX package: |ΔUs| and |Δλ| (absolute), the
# bounds of tests/test_multi.py::test_single_species_mixture_matches_plain_stack
US_TOL, LAM_TOL = 1e-9, 1e-8
# a step's and the trajectory's X and Q against the JAX package
STATE_TOL = 1e-9
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _both(ref_cfgs, radii, XQ, **cfg_kw):
    """The mixture in both packages, float64.  Returns (cfg_j, mgeom_j,
    states_j, cfg_t, mgeom_t, states_t)."""
    cfg_j = SimulationConfig(dtype=jnp.float64, **cfg_kw)
    mg_j = multi_j.MultiGeometry.create(ref_cfgs, dtype=jnp.float64,
                                        radii=radii)
    st_j = tuple(make_state_j(X, Q, dtype=jnp.float64) for X, Q in XQ)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    mg_t = interop.multi_geometry_from_numpy(
        [np.asarray(g.ref_cfg) for g in mg_j.geoms], mg_j.radii,
        dtype=torch.float64, device="cpu")
    st_t = interop.states_from_numpy(
        [(np.asarray(s.X), np.asarray(s.Q)) for s in st_j],
        dtype=torch.float64, device="cpu")
    return cfg_j, mg_j, st_j, cfg_t, mg_t, st_t


@pytest.fixture(scope="module")
def mix():
    p12, ref12 = load_structure("shell_N_12")
    p42, ref42 = load_structure("shell_N_42")
    rng = np.random.default_rng(8)
    X0 = np.array([[0.0, 0.0, 1.3], [2.2, 0.0, 1.4], [0.0, 2.2, 1.5]])
    X1 = np.array([[1.1, 1.1, 1.0], [2.6, 2.0, 1.2]])
    XQ = [(X0, rng.standard_normal((3, 4))), (X1, rng.standard_normal((2, 4)))]
    return _both([ref12, SCALE_1 * ref42], [None, SCALE_1 * p42["sep"] / 2],
                 XQ, a=p12["sep"] / 2, wall=True, dt=0.01, kBT=1.0,
                 lanczos_iters=6, gmres_tol=1e-10, gmres_restart=40,
                 gmres_maxiter=200, pc_mode="block_free")


def _forces(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, 6)), rng.standard_normal((2, 6))


def _close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


def test_mixture_is_polydisperse(mix):
    """The species' radii, and the per-species noise factors at them equal
    to the JAX package's (carried across by interop) to 1e-12."""
    cfg_j, mg_j, _, cfg_t, mg_t, st_t = mix
    assert mg_t.is_poly() and mg_t.species_a(cfg_t)[0] == cfg_t.a
    opses = multi_t.geometry_ops_multi(mg_t, st_t)
    radii = multi_t.blob_radii_multi(mg_t, opses, cfg_t)
    assert radii.shape == (3 * 12 + 2 * 42,)
    assert float(radii[-1]) / cfg_t.a == pytest.approx(
        SCALE_1 * 0.487106112144 / 0.8328413657334993)
    npcs_j = interop.noise_pcs_from_numpy(
        [tuple(np.asarray(m) for m in lp) for lp in
         multi_j.make_noise_preconditioner_multi(mg_j, cfg_j.a, cfg_j.eta,
                                                 jnp.float64)],
        dtype=torch.float64, device="cpu")
    npcs_t = multi_t.make_noise_preconditioner_multi(mg_t, cfg_t.a, cfg_t.eta)
    for lp_t, lp_j in zip(npcs_t, npcs_j):
        for m_t, m_j in zip(lp_t, lp_j):
            assert (m_t - m_j).abs().max() / m_j.abs().max() < 1e-12


def test_solve_matches_jax(mix):
    """The mixed saddle solve from random slip and forces: equal GMRES
    iterations, Us to 1e-9 and λ to 1e-8.  At gmres_tol 1e-12: the random
    slip makes the system stiff enough that two solves stopped at 1e-10
    differ by ~3e-9 in U from their roundoff alone."""
    cfg_j, mg_j, st_j, cfg_t, mg_t, st_t = mix
    cfg_j, cfg_t = cfg_j.replace(gmres_tol=1e-12), cfg_t.replace(gmres_tol=1e-12)
    rng = np.random.default_rng(3)
    slip = rng.standard_normal((120, 3))
    F = _forces(4)
    res_j = jax_fast(lambda st, s, f: multi_j.solve_saddle_multi(
        mg_j, cfg_j, st, s, f), st_j, jnp.asarray(slip),
        tuple(jnp.asarray(f) for f in F))
    res_t = multi_t.solve_saddle_multi(mg_t, cfg_t, st_t,
                                       torch.from_numpy(slip),
                                       tuple(torch.from_numpy(f) for f in F))
    assert res_t.iters == int(res_j.iters)
    assert float(res_t.residual) < cfg_t.gmres_tol
    for u_t, u_j in zip(res_t.Us, res_j.Us):
        _close(u_t, u_j, US_TOL)
    _close(res_t.lam, res_j.lam, LAM_TOL)


def _run_draws(key, n_total, n_steps):
    """The (W1, W2, W_rfd) of each step of the JAX run_bd_multi from
    ``key``."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        k1, k2, k3 = jax.random.split(sub, 3)
        out.append(tuple(np.array(jax.random.normal(k, shape, jnp.float64))
                         for k, shape in ((k1, (3 * n_total,)),
                                          (k2, (3 * n_total,)),
                                          (k3, (n_total, 3)))))
    return out


@pytest.fixture(scope="module")
def jax_run(mix):
    cfg_j, mg_j, st_j = mix[:3]
    F = tuple(jnp.asarray(f) for f in _forces(5))
    key = jax.random.key(11)
    final, traj = jax_fast(functools.partial(
        multi_j.run_bd_multi, mg_j, cfg_j, n_steps=N_STEPS,
        force_fn=lambda ss, i: F), st_j, key)
    return final, traj, _run_draws(key, 120, N_STEPS)


def test_stochastic_step_matches_jax(mix, jax_run):
    """The JAX run's first step (zero warm start, the static block_free PC
    built at the initial geometry) from its draws: X and Q to 1e-9, equal
    GMRES iterations; the bodies moved."""
    cfg_j, mg_j, st_j, cfg_t, mg_t, st_t = mix
    _, traj, draws = jax_run
    F = tuple(torch.from_numpy(f) for f in _forces(5))
    pcs = multi_t.build_pc_multi(multi_t.geometry_ops_multi(mg_t, st_t),
                                 cfg_t, species_a=mg_t.species_a(cfg_t))
    x0 = (torch.zeros((120, 3), dtype=torch.float64),
          tuple(torch.zeros((b, 6), dtype=torch.float64) for b in (3, 2)))
    s_t, res_t = multi_t.stochastic_step_multi(mg_t, cfg_t, st_t, F, x0=x0,
                                               pcs=pcs, draws=draws[0])
    assert res_t.iters == int(traj["iters"][0])
    for s in range(2):
        _close(s_t[s].X, traj["X"][s][0], STATE_TOL)
        _close(s_t[s].Q, traj["Q"][s][0], STATE_TOL)
        assert (s_t[s].X - st_t[s].X).abs().max() > 1e-3


def test_run_bd_multi_matches_jax(mix, jax_run):
    """Three steps from the JAX run's draws (warm starts and the static PC
    threaded): every frame's X and Q to 1e-9, equal iterations a step."""
    cfg_t, mg_t, st_t = mix[3:]
    final_j, traj_j, draws = jax_run
    F = tuple(torch.from_numpy(f) for f in _forces(5))
    final_t, traj_t = multi_t.run_bd_multi(
        mg_t, cfg_t, st_t, N_STEPS, force_fn=lambda ss, i: F,
        draws_fn=lambda i: draws[i])
    assert traj_t["iters"].tolist() == np.asarray(traj_j["iters"]).tolist()
    assert float(traj_t["residual"].max()) < cfg_t.gmres_tol
    for s in range(2):
        assert traj_t["X"][s].shape == (N_STEPS, (3, 2)[s], 3)
        _close(traj_t["X"][s], traj_j["X"][s], STATE_TOL)
        _close(traj_t["Q"][s], traj_j["Q"][s], STATE_TOL)
        _close(final_t[s].X, final_j[s].X, STATE_TOL)


def test_run_bd_multi_from_a_generator(mix):
    """Draws from a torch.Generator: the trajectory is the one the same
    generator's draws give through draws_fn, saved every second step."""
    cfg_t, mg_t, st_t = mix[3:]
    cfg = cfg_t.replace(gmres_tol=1e-8)
    gen = torch.Generator().manual_seed(2)
    fin, traj = multi_t.run_bd_multi(mg_t, cfg, st_t, 2, generator=gen,
                                     save_every=2)
    gen = torch.Generator().manual_seed(2)
    draws = [multi_t.make_draws_multi(mg_t, st_t, gen) for _ in range(2)]
    fin2, _ = multi_t.run_bd_multi(mg_t, cfg, st_t, 2,
                                   draws_fn=lambda i: draws[i])
    assert traj["X"][1].shape == (1, 2, 3)
    for s in range(2):
        assert torch.equal(fin[s].X, fin2[s].X)
        assert torch.equal(traj["X"][s][0], fin[s].X)


def test_one_species_mixture_equals_the_single_solve(mix):
    """A one-species mixture is the single-species solve: equal iterations,
    U and λ to 1e-12."""
    cfg_t, mg_t, st_t = mix[3:]
    mg1 = multi_t.MultiGeometry((mg_t.geoms[0],))
    F = torch.from_numpy(_forces(6)[0])
    res_m = multi_t.solve_saddle_multi(mg1, cfg_t, st_t[:1], None, (F,))
    ops = saddle_t.geometry_ops(mg_t.geoms[0], st_t[0])
    res_s = solvers_t.solve_saddle(ops, cfg_t, torch.zeros((36, 3),
                                                           dtype=torch.float64),
                                   F)
    assert res_m.iters == res_s.iters
    _close(res_m.Us[0], res_s.U, 1e-12)
    _close(res_m.lam, res_s.lam, 1e-12)


def test_distributed_mixture_is_not_ported(mix):
    """The distributed mixture is ported (``tests/test_torch_distributed_
    multi.py`` holds it to the JAX package); a process group without the
    local operator raises the JAX package's ValueError before any
    collective."""
    cfg_t, mg_t, st_t = mix[3:]
    with pytest.raises(ValueError, match="needs an explicit local mob_apply"):
        multi_t.stochastic_step_multi(mg_t, cfg_t, st_t,
                                      tuple(torch.zeros(b, 6)
                                            for b in (3, 2)),
                                      group=object())


def dense_wall_mixture():
    """``tests/test_multi.py::_dense_wall_mixture`` in both packages: 6 ×
    shell_N_12 and 3 × shell_N_42 packed at the wall, a = 0.24, RAS."""
    _, ref12 = load_structure("shell_N_12")
    _, ref42 = load_structure("shell_N_42")
    X12 = np.array([[0, 0, 1.2], [1.4, 0, 1.2], [0, 1.4, 1.1],
                    [1.4, 1.4, 1.25], [0.7, 0.7, 2.3], [2.1, 0.7, 1.3]])
    X42 = np.array([[0.7, -1.3, 1.4], [-1.3, 0.7, 1.45], [2.8, 2.2, 1.5]])
    XQ = [(X12, np.tile([1.0, 0, 0, 0], (6, 1))),
          (X42, np.tile([1.0, 0, 0, 0], (3, 1)))]
    return _both([ref12, ref42], None, XQ, a=0.24, wall=True, gmres_tol=1e-9,
                 gmres_maxiter=300, pc_mode="ras")


def _halo_order(idx_t, idx_j):
    """Per body, the permutation of the port's halo slots into the JAX
    package's order, the slots' 3 components each; the two halo sets must
    be equal.  (Within a body the order breaks ties of distances that differ
    in their last bit between the two packages' norms.)"""
    perm = []
    for a, b in zip(idx_t, idx_j):
        assert sorted(a.tolist()) == sorted(b.tolist())
        pos = {int(v): k for k, v in enumerate(a.tolist())}
        p = np.array([pos[int(v)] for v in b.tolist()])
        perm.append((3 * p[:, None] + np.arange(3)).reshape(-1))
    return np.stack(perm)


def test_mixture_ras_matches_jax():
    """build_pc_ras_multi: the same halo sets (global blob ids across
    species), and with the halos in the same order W and the Schur
    inverses to 1e-10 of their scale; the coupled Ñ to 1e-10; a RAS solve
    takes fewer iterations than block_free for the same answer, as
    tests/test_multi.py requires of the JAX package."""
    cfg_j, mg_j, st_j, cfg_t, mg_t, st_t = dense_wall_mixture()

    def build_j(states):
        opses = multi_j.geometry_ops_multi(mg_j, states)
        pcs = multi_j.build_pc_multi(opses, cfg_j,
                                     species_a=mg_j.species_a(cfg_j))
        return multi_j.build_pc_ras_multi(opses, cfg_j, pcs,
                                          mg_j.species_a(cfg_j))

    pc_j = jax_fast(build_j, st_j)
    opses = multi_t.geometry_ops_multi(mg_t, st_t)
    pcs = multi_t.build_pc_multi(opses, cfg_t, species_a=mg_t.species_a(cfg_t))
    pc_t = multi_t.build_pc_ras_multi(opses, cfg_t, pcs,
                                      mg_t.species_a(cfg_t))
    assert isinstance(pc_t, multi_t.RasMultiPC)
    for s in range(2):
        perm = _halo_order(pc_t.halo_idx[s].numpy(),
                           np.asarray(pc_j.halo_idx[s]))
        b = np.arange(perm.shape[0])[:, None]
        W_t = pc_t.halo_w[s].numpy()[b[:, :, None], np.arange(
            pc_t.halo_w[s].shape[1])[None, :, None], perm[:, None, :]]
        S_t = pc_t.halo_sinv[s].numpy()[b[:, :, None], perm[:, :, None],
                                        perm[:, None, :]]
        for t, j in ((W_t, pc_j.halo_w[s]), (S_t, pc_j.halo_sinv[s])):
            j = np.asarray(j)
            assert np.abs(t - j).max() / np.abs(j).max() < 1e-10
    n_j = np.asarray(pc_j.n_full)
    assert np.abs(pc_t.n_full.numpy() - n_j).max() / np.abs(n_j).max() < 1e-10
    rng = np.random.default_rng(7)
    F = tuple(torch.from_numpy(rng.standard_normal((b, 6))) for b in (6, 3))
    res_ras = multi_t.solve_saddle_multi(mg_t, cfg_t, st_t, None, F)
    res_bf = multi_t.solve_saddle_multi(
        mg_t, cfg_t.replace(pc_mode="block_free"), st_t, None, F)
    assert float(res_ras.residual) < 1e-8 and float(res_bf.residual) < 1e-8
    assert res_ras.iters < res_bf.iters - 10, (res_ras.iters, res_bf.iters)
    for u_r, u_b in zip(res_ras.Us, res_bf.Us):
        _close(u_r, u_b, 1e-7)
