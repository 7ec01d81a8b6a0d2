"""Port parity of the balanced-split periodic operator through a
fluctuating step, a mixture step and the ``RigidBody`` API, against the
JAX package on the same numpy inputs (float64 on the CPU).  The saddle
dispatch itself: ``tests/test_torch_ewald_dispatch.py``.

- A step: the setup of ``tests/test_ewald_pme.py::test_grid_bd_step_runs``
  (three shell_N_12 bodies in a cubic L = 9 box, rc = 3.0, ewald_tol 1e-4)
  from the JAX step's own draws: X and Q to 1e-9 with equal GMRES
  iterations.  The grid has p = 2 nodes a cell, not that test's 4: the
  36³-cell grid at 3p³ = 192 node channels made the pair of steps take
  ~80 s on one core, and the wave part's parity at p = 3 and 4 is held in
  ``tests/test_torch_ewald_pme.py``.
- A mixture step: two shell_N_12 bodies at the configuration's radius and
  two shell_N_42 bodies scaled by 0.6 at their own radius, in the same
  box (rc = 3.0, the dense wave part with per-blob sinc weights), from the
  JAX run's draws: X and Q to 1e-9, equal iterations.  The JAX run takes
  its operators built outside its trace, as the species' radii are
  numbers there.

The JAX references are compiled at XLA's cheapest CPU optimization, as
``tests/test_torch_poly.py`` compiles its references.
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
from rigid_body_light_tpu.dynamics import stochastic_step as step_j  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin_j  # noqa: E402
from rigid_body_light_tpu.ops import saddle as saddle_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
import rigid_body_light_tpu_torch as rt  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch import multi as multi_t  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import stochastic_step as step_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as saddle_t  # noqa: E402

BOX = (9.0, 9.0, 9.0)
STEP_P = 2          # grid nodes a cell in the step tests (module doc)
STATE_TOL = 1e-9
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)`` compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _step_setup(dtype_j=jnp.float64):
    params, ref = load_structure("shell_N_12")
    xs = np.array([[2.0, 2.0, 2.0], [5.5, 4.0, 4.5], [3.0, 6.0, 6.5]])
    qs = np.random.default_rng(4).standard_normal((3, 4))
    cfg_j = SimulationConfig(
        a=params["sep"] / 2, eta=1.0, dt=0.01, kBT=1.0, box=BOX,
        ewald_rc=3.0, ewald_grid_p=STEP_P, ewald_tol=1e-4, gmres_tol=1e-8,
        gmres_restart=40, gmres_maxiter=200, dtype=dtype_j,
        use_pallas=False, lanczos_iters=6, pc_mode="block_free")
    return ref, xs, qs, cfg_j


def test_balanced_step_matches_jax():
    """One stochastic step through the balanced split with the gridded wave
    part (float64), from the JAX step's draws."""
    ref, xs, qs, cfg_j = _step_setup()
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    geom_j = kin_j.make_ref_geometry(ref, dtype=jnp.float64)
    st_j = make_state_j(xs, qs, dtype=jnp.float64)
    force = np.zeros((3, 6))
    force[:, 2] = -1.0
    key = jax.random.key(7)
    s_j, aux_j = jax_fast(functools.partial(step_j, geom_j, cfg_j), st_j,
                          key, jnp.asarray(force))
    k1, k2, k3 = jax.random.split(key, 3)
    n = ref.shape[0]
    draws = (np.array(jax.random.normal(k1, (3 * 3 * n,), jnp.float64)),
             np.array(jax.random.normal(k2, (3 * 3 * n,), jnp.float64)),
             np.array(jax.random.normal(k3, (3, n, 3), jnp.float64)))
    geom_t = interop.geometry_from_numpy(ref, dtype=torch.float64,
                                         device="cpu")
    st_t = interop.state_from_numpy(st_j.X, st_j.Q, dtype=torch.float64,
                                    device="cpu")
    s_t, aux_t = step_t(geom_t, cfg_t, st_t, torch.from_numpy(force),
                        draws=draws)
    assert aux_t.iters == int(aux_j.iters)
    assert float(aux_t.residual) < cfg_t.gmres_tol
    np.testing.assert_allclose(s_t.X.numpy(), np.asarray(s_j.X), rtol=0,
                               atol=STATE_TOL)
    np.testing.assert_allclose(s_t.Q.numpy(), np.asarray(s_j.Q), rtol=0,
                               atol=STATE_TOL)
    assert np.abs(s_t.X.numpy() - xs).max() > 1e-3   # the bodies moved


def test_balanced_mixture_step_matches_jax():
    """One stochastic_step_multi of a two-radius mixture in the 3-D box
    (balanced split, per-blob radii in the tile sweep and the wave part),
    float64, from the JAX run's draws; the static block_free PC and a zero
    warm start, as the JAX run's first step."""
    p12, ref12 = load_structure("shell_N_12")
    p42, ref42 = load_structure("shell_N_42")
    scale = 0.6
    XQ = [(np.array([[2.0, 2.0, 2.0], [6.0, 5.5, 3.0]]),
           np.random.default_rng(1).standard_normal((2, 4))),
          (np.array([[5.0, 2.5, 6.5], [2.5, 6.5, 6.0]]),
           np.random.default_rng(2).standard_normal((2, 4)))]
    cfg_j = SimulationConfig(
        a=p12["sep"] / 2, dt=0.01, kBT=1.0, box=BOX, ewald_rc=3.0,
        ewald_tol=1e-4, gmres_tol=1e-8, gmres_restart=40,
        gmres_maxiter=200, lanczos_iters=6, pc_mode="block_free",
        dtype=jnp.float64)
    radii = [None, scale * p42["sep"] / 2]
    mg_j = multi_j.MultiGeometry.create([ref12, scale * ref42],
                                        dtype=jnp.float64, radii=radii)
    st_j = tuple(make_state_j(X, Q, dtype=jnp.float64) for X, Q in XQ)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    mg_t = interop.multi_geometry_from_numpy(
        [np.asarray(g.ref_cfg) for g in mg_j.geoms], mg_j.radii,
        dtype=torch.float64, device="cpu")
    st_t = interop.states_from_numpy(
        [(np.asarray(s.X), np.asarray(s.Q)) for s in st_j],
        dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    F = (rng.standard_normal((2, 6)), rng.standard_normal((2, 6)))
    key = jax.random.key(11)
    n_total = 2 * 12 + 2 * 42
    radii_np = np.concatenate([np.full(24, cfg_j.a),
                               np.full(84, radii[1])])
    _, traj = jax_fast(functools.partial(
        multi_j.run_bd_multi, mg_j, cfg_j, n_steps=1,
        force_fn=lambda ss, i: tuple(jnp.asarray(f) for f in F),
        mob_apply=saddle_j.mobility_apply_fn(cfg_j, radii=radii_np),
        mob_multi=saddle_j.mobility_apply_multi_fn(cfg_j, radii=radii_np)),
        st_j, key)
    opses = multi_t.geometry_ops_multi(mg_t, st_t)
    np.testing.assert_array_equal(
        multi_t.blob_radii_multi(mg_t, opses, cfg_t).numpy(), radii_np)
    _, sub = jax.random.split(key)
    k1, k2, k3 = jax.random.split(sub, 3)
    draws = tuple(np.array(jax.random.normal(k, shape, jnp.float64))
                  for k, shape in ((k1, (3 * n_total,)),
                                   (k2, (3 * n_total,)),
                                   (k3, (n_total, 3))))
    pcs = multi_t.build_pc_multi(opses, cfg_t,
                                 species_a=mg_t.species_a(cfg_t))
    x0 = (torch.zeros((n_total, 3), dtype=torch.float64),
          tuple(torch.zeros((2, 6), dtype=torch.float64) for _ in range(2)))
    s_t, res_t = multi_t.stochastic_step_multi(
        mg_t, cfg_t, st_t, tuple(torch.from_numpy(f) for f in F), x0=x0,
        pcs=pcs, draws=draws)
    assert res_t.iters == int(traj["iters"][0])
    assert float(res_t.residual) < cfg_t.gmres_tol
    for s in range(2):
        np.testing.assert_allclose(s_t[s].X.numpy(), np.asarray(
            traj["X"][s][0]), rtol=0, atol=STATE_TOL)
        np.testing.assert_allclose(s_t[s].Q.numpy(), np.asarray(
            traj["Q"][s][0]), rtol=0, atol=STATE_TOL)


def test_rigid_body_apply_M_through_the_balanced_split():
    """RigidBody with an rc + grid configuration: apply_M (numpy in and
    out) is saddle's operator, with no code of its own."""
    ref, xs, qs, cfg_j = _step_setup()
    cfg = interop.config_from_dict(dataclasses.asdict(cfg_j))
    body = rt.RigidBody(ref, xs, qs, cfg.a, cfg.eta, cfg.dt, config=cfg,
                        device="cpu")
    pos = np.asarray(body.get_blob_positions()).reshape(-1, 3)
    F = np.random.default_rng(6).standard_normal(pos.shape)
    U = body.apply_M(F.ravel(), pos.ravel())
    ref_U = saddle_t.mobility_apply_fn(cfg)(torch.from_numpy(F),
                                            torch.from_numpy(pos))
    np.testing.assert_array_equal(U, ref_U.numpy().ravel())
    assert np.isfinite(U).all() and np.abs(U).max() > 0
