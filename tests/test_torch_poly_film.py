"""Port parity of the polydisperse film (per-blob radii with the pseudo-2D
box) against the JAX package on the CPU: the kernels' wrapper
``rpy_cuda.pair_sum`` with radii, box and image_shells 2 (the contract of
K1's and K2's POLY × box forms) against the Pallas kernels in interpret
mode in float32, as ``tests/test_pseudo2d.py`` holds the Pallas kernels to
the XLA sweep; and ``multi.run_bd_multi`` on a polydisperse film in
float64, two steps from the JAX run's draws.

Positions are drawn off the seams: a pair within float32 rounding of
±L/2 may take the other image in either package (ROADMAP.md queue 3,
item 4).
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
from rigid_body_light_tpu.ops import rpy_pallas  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch import multi as multi_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import rpy_cuda  # noqa: E402

from test_torch_noise_drift import jax_fast  # noqa: E402

# the float32 wrapper against the Pallas kernels in interpret mode,
# relative to max|U|: tests/test_pseudo2d.py's bound
PALLAS_TOL = 3e-6
# a trajectory's X and Q against the JAX package, absolute
STATE_TOL = 1e-9
N_STEPS = 2


@pytest.mark.parametrize("k", [1, 2])
def test_wrapper_matches_pallas_poly_box(k):
    """K1's contract at 1 RHS (the self images added with each blob's
    radius) and K2's at 2 RHS (its own images kept), image_shells 2, radii
    {0.8, 1.25}: the wrapper on a CPU tensor against the Pallas kernels in
    interpret mode."""
    rng = np.random.default_rng(6)
    n = 48
    box = (float(np.float32(9.3)), float(np.float32(8.1)))
    r = rng.uniform([0.0, 0.0, 0.6], [box[0], box[1], 3.5],
                    (n, 3)).astype(np.float32)
    ahat = rng.choice([0.8, 1.25], n).astype(np.float32)
    F = rng.standard_normal((k, n, 3)).astype(np.float32)
    got = rpy_pallas.pair_sum(jnp.asarray(r), jnp.asarray(F), True,
                              interpret=True, box_over_a=box,
                              ahat=jnp.asarray(ahat), image_shells=2)
    U = rpy_cuda.pair_sum(torch.from_numpy(r), torch.from_numpy(F), True,
                          box_over_a=box, ahat=torch.from_numpy(ahat),
                          image_shells=2)
    ref = np.asarray(got)
    assert U.shape == (k, n, 3)
    assert np.abs(U.numpy() - ref).max() / np.abs(ref).max() < PALLAS_TOL


def _draws(key, n_total):
    """Each step's (W1, W2, W_rfd) of the JAX run_bd_multi from ``key``."""
    out = []
    for _ in range(N_STEPS):
        key, sub = jax.random.split(key)
        k1, k2, k3 = jax.random.split(sub, 3)
        out.append(tuple(np.array(jax.random.normal(kk, shape, jnp.float64))
                         for kk, shape in ((k1, (3 * n_total,)),
                                           (k2, (3 * n_total,)),
                                           (k3, (n_total, 3)))))
    return out


def test_run_bd_multi_film_matches_jax():
    """2 × shell_N_12 at a and 2 × shell_N_42 scaled 0.6 at their own
    radius in a (6.3, 5.9) box above the wall, image_shells 1, kBT = 1:
    two steps from the JAX run's draws, X and Q to 1e-9, equal
    iterations."""
    p12, ref12 = load_structure("shell_N_12")
    p42, ref42 = load_structure("shell_N_42")
    rng = np.random.default_rng(12)
    XQ = [(np.array([[0.4, 0.3, 1.3], [3.3, 0.5, 1.5]]),
           rng.standard_normal((2, 4))),
          (np.array([[1.7, 3.1, 1.1], [4.6, 3.4, 1.3]]),
           rng.standard_normal((2, 4)))]
    cfg_j = SimulationConfig(a=p12["sep"] / 2, wall=True, dt=0.01, kBT=1.0,
                             box=(6.3, 5.9), image_shells=1,
                             lanczos_iters=6, gmres_tol=1e-10,
                             gmres_restart=40, gmres_maxiter=200,
                             pc_mode="block_free", dtype=jnp.float64)
    mg_j = multi_j.MultiGeometry.create(
        [ref12, 0.6 * ref42], dtype=jnp.float64,
        radii=[None, 0.6 * p42["sep"] / 2])
    st_j = tuple(make_state_j(X, Q, dtype=jnp.float64) for X, Q in XQ)
    F = (rng.standard_normal((2, 6)), rng.standard_normal((2, 6)))
    key = jax.random.key(13)
    fin_j, tr_j = jax_fast(functools.partial(
        multi_j.run_bd_multi, mg_j, cfg_j, n_steps=N_STEPS,
        force_fn=lambda ss, i: tuple(jnp.asarray(f) for f in F)), st_j, key)

    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    mg_t = interop.multi_geometry_from_numpy(
        [np.asarray(g.ref_cfg) for g in mg_j.geoms], mg_j.radii,
        dtype=torch.float64, device="cpu")
    st_t = interop.states_from_numpy(
        [(np.asarray(s.X), np.asarray(s.Q)) for s in st_j],
        dtype=torch.float64, device="cpu")
    draws = _draws(key, 2 * 12 + 2 * 42)
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
