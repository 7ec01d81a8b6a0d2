"""Port parity of ``multi.run_bd_multi`` in the stepper modes of the exact
drift and the unpreconditioned noise against the JAX package on the CPU,
float64: ``drift_mode="em_exact"`` (``multi.n_rfd_exact_multi``) and the
midpoint scheme with ``lanczos_precond=False`` (``lanczos.m_half_w_pair``
through the mixture's 2-RHS product), two steps from the JAX run's draws.

The mixture: 2 × shell_N_12 at the configuration's blob radius and
2 × shell_N_42 scaled by 0.6 with their own blob radius, above the wall,
solved to gmres_tol 1e-12 (the exact drift divides the difference of two
solves by δ = 1e-4).  The draws: the key split per step, then in three;
``em_exact`` takes one Lanczos draw, and its drift draw is split once more
per species, (B_s, 6) each, concatenated species-major.
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

from test_torch_noise_drift import jax_fast  # noqa: E402

N_STEPS = 2
SCALE_1 = 0.6
BS = (2, 2)
# a trajectory's X and Q against the JAX package, absolute
STATE_TOL = 1e-9


@pytest.fixture(scope="module")
def mix():
    p12, ref12 = load_structure("shell_N_12")
    p42, ref42 = load_structure("shell_N_42")
    rng = np.random.default_rng(8)
    XQ = [(np.array([[0.0, 0.0, 1.3], [2.2, 0.0, 1.4]]),
           rng.standard_normal((2, 4))),
          (np.array([[1.1, 1.6, 1.0], [2.6, 2.0, 1.2]]),
           rng.standard_normal((2, 4)))]
    cfg_j = SimulationConfig(a=p12["sep"] / 2, wall=True, dt=0.01, kBT=1.0,
                             lanczos_iters=6, gmres_tol=1e-12,
                             gmres_restart=40, gmres_maxiter=200,
                             pc_mode="block_free", dtype=jnp.float64)
    mg_j = multi_j.MultiGeometry.create(
        [ref12, SCALE_1 * ref42], dtype=jnp.float64,
        radii=[None, SCALE_1 * p42["sep"] / 2])
    st_j = tuple(make_state_j(X, Q, dtype=jnp.float64) for X, Q in XQ)
    mg_t = interop.multi_geometry_from_numpy(
        [np.asarray(g.ref_cfg) for g in mg_j.geoms], mg_j.radii,
        dtype=torch.float64, device="cpu")
    st_t = interop.states_from_numpy(
        [(np.asarray(s.X), np.asarray(s.Q)) for s in st_j],
        dtype=torch.float64, device="cpu")
    return cfg_j, mg_j, st_j, mg_t, st_t


def _run_draws(key, n_total, mode):
    out = []
    for _ in range(N_STEPS):
        key, sub = jax.random.split(key)
        k1, k2, k3 = jax.random.split(sub, 3)
        w1 = np.array(jax.random.normal(k1, (3 * n_total,), jnp.float64))
        if mode == "em_exact":
            ws = [np.array(jax.random.normal(k, (b, 6), jnp.float64))
                  for k, b in zip(jax.random.split(k3, len(BS)), BS)]
            out.append((w1, None, np.concatenate(ws)))
        else:
            out.append((w1, np.array(jax.random.normal(
                k2, (3 * n_total,), jnp.float64)),
                np.array(jax.random.normal(k3, (n_total, 3), jnp.float64))))
    return out


@pytest.mark.parametrize("mode,precond", [
    ("em_exact", True), ("midpoint_slip", False),
], ids=["em_exact", "midpoint_unprecond"])
def test_run_bd_multi_modes_match_jax(mix, mode, precond):
    """Two steps from the JAX run's draws (warm starts and the static PC
    threaded): X and Q of both species to 1e-9, equal iterations."""
    cfg_j, mg_j, st_j, mg_t, st_t = mix
    cfg_j = cfg_j.replace(drift_mode=mode, lanczos_precond=precond)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    rng = np.random.default_rng(5)
    F = (rng.standard_normal((2, 6)), rng.standard_normal((2, 6)))
    key = jax.random.key(11)
    fin_j, tr_j = jax_fast(functools.partial(
        multi_j.run_bd_multi, mg_j, cfg_j, n_steps=N_STEPS,
        force_fn=lambda ss, i: tuple(jnp.asarray(f) for f in F)), st_j, key)
    n_total = sum(g.ref_cfg.shape[0] * b for g, b in zip(mg_j.geoms, BS))
    draws = _run_draws(key, n_total, mode)
    F_t = tuple(torch.from_numpy(f) for f in F)
    fin_t, tr_t = multi_t.run_bd_multi(mg_t, cfg_t, st_t, N_STEPS,
                                       force_fn=lambda ss, i: F_t,
                                       draws_fn=lambda i: draws[i])
    assert tr_t["iters"].tolist() == np.asarray(tr_j["iters"]).tolist()
    for s in range(2):
        for name in ("X", "Q"):
            np.testing.assert_allclose(tr_t[name][s].numpy(),
                                       np.asarray(tr_j[name][s]), rtol=0,
                                       atol=STATE_TOL)
        assert (fin_t[s].X - st_t[s].X).abs().max() > 1e-3


def test_make_draws_multi_shapes_by_mode(mix):
    """The generator's draws in each mode's shapes, and run_bd_multi in
    em_exact from a generator equal to the same draws fed through
    draws_fn."""
    cfg_j, _, _, mg_t, st_t = mix
    cfg_t = interop.config_from_dict(dataclasses.asdict(
        cfg_j.replace(drift_mode="em_exact", gmres_tol=1e-8)))
    n_total = 2 * 12 + 2 * 42
    W1, W2, Wr = multi_t.make_draws_multi(mg_t, st_t,
                                          torch.Generator().manual_seed(1),
                                          cfg_t)
    assert W1.shape == (3 * n_total,) and W2 is None and Wr.shape == (4, 6)
    W1, W2, Wr = multi_t.make_draws_multi(mg_t, st_t,
                                          torch.Generator().manual_seed(1))
    assert W2.shape == (3 * n_total,) and Wr.shape == (n_total, 3)
    fin, _ = multi_t.run_bd_multi(mg_t, cfg_t, st_t, 1,
                                  generator=torch.Generator().manual_seed(2))
    draws = multi_t.make_draws_multi(mg_t, st_t,
                                     torch.Generator().manual_seed(2), cfg_t)
    fin2, _ = multi_t.run_bd_multi(mg_t, cfg_t, st_t, 1,
                                   draws_fn=lambda i: draws)
    for s in range(2):
        assert torch.equal(fin[s].X, fin2[s].X)
