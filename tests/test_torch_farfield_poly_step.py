"""Port parity of mixture steps on the polydisperse far field (per-blob
radii with ``farfield_grid``) against the JAX package, on the CPU, from the
Gaussian draws the JAX run makes from its key.

The mixture of ``tests/test_torch_multi.py`` (3 × shell_N_12 at the
configuration's blob radius a and 2 × shell_N_42 scaled by 0.6 with their
own blob radius, above the wall) on a (3, 3, 2) grid at p = 4, whose cells
are wider than the largest contact distance 2a.  Float64: one
``stochastic_step_multi`` and a 3-step ``run_bd_multi``, X and Q to 1e-9
with equal GMRES iterations; float32: one step (K3's wrapper, its plain
version on the CPU) at the float32 step bound; and one float64 step in a
(4.8, 4.8) film at image_shells 2.  A gmres_tol below the p = 4 operator
error makes both configurations warn; both packages then solve the same
approximate operator to the solver's precision.  The JAX references are
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
from rigid_body_light_tpu import multi as multi_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch import multi as multi_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import farfield_cuda  # noqa: E402

N_STEPS = 3
N_TOTAL = 3 * 12 + 2 * 42
SCALE_1 = 0.6
STATE_TOL = 1e-9
# one float32 step against the JAX package's, max|ΔX_port − ΔX_jax| /
# max|ΔX_jax|: the bound of tests/test_torch_step_f32.py
F32_STEP_TOL = 2e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _mixture(dtype_j, dtype_t, **cfg_kw):
    """The mixture in both packages.  Returns (cfg_j, mgeom_j, states_j,
    cfg_t, mgeom_t, states_t)."""
    p12, ref12 = load_structure("shell_N_12")
    p42, ref42 = load_structure("shell_N_42")
    rng = np.random.default_rng(8)
    X0 = np.array([[0.0, 0.0, 1.3], [2.2, 0.0, 1.4], [0.0, 2.2, 1.5]])
    X1 = np.array([[1.1, 1.1, 1.0], [2.6, 2.0, 1.2]])
    XQ = [(X0, rng.standard_normal((3, 4))), (X1, rng.standard_normal((2, 4)))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cfg_j = SimulationConfig(
            dtype=dtype_j, a=p12["sep"] / 2, wall=True, dt=0.01, kBT=1.0,
            lanczos_iters=6, gmres_restart=40, gmres_maxiter=200,
            pc_mode="block_free", farfield_p=4, **cfg_kw)
        cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    mg_j = multi_j.MultiGeometry.create(
        [ref12, SCALE_1 * ref42], dtype=dtype_j,
        radii=[None, SCALE_1 * p42["sep"] / 2])
    st_j = tuple(make_state_j(X, Q, dtype=dtype_j) for X, Q in XQ)
    mg_t = interop.multi_geometry_from_numpy(
        [np.asarray(g.ref_cfg) for g in mg_j.geoms], mg_j.radii,
        dtype=dtype_t, device="cpu")
    st_t = interop.states_from_numpy(
        [(np.asarray(s.X), np.asarray(s.Q)) for s in st_j], dtype=dtype_t,
        device="cpu")
    return cfg_j, mg_j, st_j, cfg_t, mg_t, st_t


OPEN = dict(farfield_grid=(3, 3, 2))
FILM = dict(farfield_grid=(4, 4, 2), box=(4.8, 4.8), image_shells=2)


def _forces(dtype=np.float64):
    rng = np.random.default_rng(5)
    return (rng.standard_normal((3, 6)).astype(dtype),
            rng.standard_normal((2, 6)).astype(dtype))


def _draws(key, dtype, n_steps=None):
    """The (W1, W2, W_rfd) of ``stochastic_step_multi(key)``, or of each of
    the n_steps steps of ``run_bd_multi(key)``."""
    def one(k):
        k1, k2, k3 = jax.random.split(k, 3)
        return tuple(np.array(jax.random.normal(kk, shape, dtype))
                     for kk, shape in ((k1, (3 * N_TOTAL,)),
                                       (k2, (3 * N_TOTAL,)),
                                       (k3, (N_TOTAL, 3))))
    if n_steps is None:
        return one(key)
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(one(sub))
    return out


def _close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def mix():
    return _mixture(jnp.float64, torch.float64, gmres_tol=1e-10, **OPEN)


@pytest.fixture(scope="module")
def jax_run(mix):
    cfg_j, mg_j, st_j = mix[:3]
    F = tuple(jnp.asarray(f) for f in _forces())
    key = jax.random.key(11)
    final, traj = jax_fast(functools.partial(
        multi_j.run_bd_multi, mg_j, cfg_j, n_steps=N_STEPS,
        force_fn=lambda ss, i: F), st_j, key)
    return final, traj, _draws(key, jnp.float64, N_STEPS)


def test_far_field_mixture_step_matches_jax(mix, jax_run):
    """The JAX run's first step (zero warm start, the static block_free PC
    built at the initial geometry) from its draws: X and Q to 1e-9, equal
    GMRES iterations; the bodies moved."""
    cfg_t, mg_t, st_t = mix[3:]
    _, traj, draws = jax_run
    assert multi_t.blob_radii_multi(
        mg_t, multi_t.geometry_ops_multi(mg_t, st_t), cfg_t) is not None
    F = tuple(torch.from_numpy(f) for f in _forces())
    pcs = multi_t.build_pc_multi(multi_t.geometry_ops_multi(mg_t, st_t),
                                 cfg_t, species_a=mg_t.species_a(cfg_t))
    x0 = (torch.zeros((N_TOTAL, 3), dtype=torch.float64),
          tuple(torch.zeros((b, 6), dtype=torch.float64) for b in (3, 2)))
    s_t, res_t = multi_t.stochastic_step_multi(mg_t, cfg_t, st_t, F, x0=x0,
                                               pcs=pcs, draws=draws[0])
    assert res_t.iters == int(traj["iters"][0])
    for s in range(2):
        _close(s_t[s].X, traj["X"][s][0], STATE_TOL)
        _close(s_t[s].Q, traj["Q"][s][0], STATE_TOL)
        assert (s_t[s].X - st_t[s].X).abs().max() > 1e-3


def test_far_field_mixture_run_matches_jax(mix, jax_run):
    """Three steps from the JAX run's draws (warm starts and the static PC
    threaded): every frame's X and Q to 1e-9, equal iterations a step."""
    cfg_t, mg_t, st_t = mix[3:]
    final_j, traj_j, draws = jax_run
    F = tuple(torch.from_numpy(f) for f in _forces())
    final_t, traj_t = multi_t.run_bd_multi(
        mg_t, cfg_t, st_t, N_STEPS, force_fn=lambda ss, i: F,
        draws_fn=lambda i: draws[i])
    assert traj_t["iters"].tolist() == np.asarray(traj_j["iters"]).tolist()
    assert float(traj_t["residual"].max()) < cfg_t.gmres_tol
    for s in range(2):
        _close(traj_t["X"][s], traj_j["X"][s], STATE_TOL)
        _close(traj_t["Q"][s], traj_j["Q"][s], STATE_TOL)
        _close(final_t[s].X, final_j[s].X, STATE_TOL)


def _jax_step(cfg_j, mg_j, st_j, dtype):
    F = tuple(jnp.asarray(f) for f in _forces(dtype))
    key = jax.random.key(3)
    (s_j, aux_j) = jax_fast(lambda st, k: multi_j.stochastic_step_multi(
        mg_j, cfg_j, st, k, F), st_j, key)
    return s_j, aux_j, _draws(key, dtype)


def test_far_field_mixture_step_float32():
    """One float32 step (the near part through K3's wrapper with radii, its
    plain version here) against the JAX package's float32 step."""
    cfg_j, mg_j, st_j, cfg_t, mg_t, st_t = _mixture(
        jnp.float32, torch.float32, gmres_tol=1e-4, **OPEN)
    assert cfg_t.use_pallas
    s_j, aux_j, draws = _jax_step(cfg_j, mg_j, st_j, jnp.float32)
    F = tuple(torch.from_numpy(f) for f in _forces(np.float32))
    before = farfield_cuda.launch_counts()
    s_t, res_t = multi_t.stochastic_step_multi(mg_t, cfg_t, st_t, F,
                                               draws=draws)
    assert farfield_cuda.launch_counts() == before    # no kernel on the CPU
    assert res_t.iters == int(aux_j.iters)
    assert float(res_t.residual) < cfg_t.gmres_tol
    dX_j = np.concatenate([np.asarray(a.X) - np.asarray(b.X)
                           for a, b in zip(s_j, st_j)])
    dX_t = np.concatenate([a.X.numpy() - np.asarray(b.X)
                           for a, b in zip(s_t, st_j)])
    assert np.abs(dX_t - dX_j).max() / np.abs(dX_j).max() < F32_STEP_TOL


def test_film_far_field_mixture_step_matches_jax():
    """One float64 step of the mixture in the film (the four radius-split
    film lattices, the cyclic near sweep with radii)."""
    cfg_j, mg_j, st_j, cfg_t, mg_t, st_t = _mixture(
        jnp.float64, torch.float64, gmres_tol=1e-10, **FILM)
    s_j, aux_j, draws = _jax_step(cfg_j, mg_j, st_j, jnp.float64)
    F = tuple(torch.from_numpy(f) for f in _forces())
    s_t, res_t = multi_t.stochastic_step_multi(mg_t, cfg_t, st_t, F,
                                               draws=draws)
    assert res_t.iters == int(aux_j.iters)
    for s in range(2):
        _close(s_t[s].X, s_j[s].X, STATE_TOL)
        _close(s_t[s].Q, s_j[s].Q, STATE_TOL)
