"""Port parity of ``run_bd`` in the stepper modes of the exact drift and
the unpreconditioned noise against the JAX package on the CPU, float64:
``drift_mode="em_exact"`` and the midpoint scheme with
``lanczos_precond=False``, two steps from the JAX run's draws (its key
split per step, then in three; ``em_exact`` takes one Lanczos draw and a
(B, 6) drift draw).  The system is
``tests/test_torch_noise_drift.py``'s, solved to gmres_tol 1e-12 (the
exact drift divides the difference of two solves by δ = 1e-4)."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu.dynamics import run_bd as run_bd_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import run_bd as run_bd_t  # noqa: E402

from test_torch_noise_drift import B, jax_fast, system  # noqa: E402,F401

N_STEPS = 2
# a trajectory's X and Q against the JAX package, absolute
STATE_TOL = 1e-9


def _run_draws(key, n, mode):
    """The per-step (W1, W2, W_rfd) that the JAX run_bd draws from ``key``
    in ``mode``: the draw key split in three a step; em_exact takes one
    Lanczos draw and a (B, 6) drift draw."""
    out = []
    for _ in range(N_STEPS):
        key, sub = jax.random.split(key)
        k1, k2, k3 = jax.random.split(sub, 3)
        w1 = np.array(jax.random.normal(k1, (B * 3 * n,), jnp.float64))
        if mode == "em_exact":
            out.append((w1, None,
                        np.array(jax.random.normal(k3, (B, 6), jnp.float64))))
        else:
            out.append((w1,
                        np.array(jax.random.normal(k2, (B * 3 * n,),
                                                   jnp.float64)),
                        np.array(jax.random.normal(k3, (B, n, 3),
                                                   jnp.float64))))
    return out


@pytest.mark.parametrize("mode,precond", [
    ("em_exact", True), ("midpoint_slip", False),
], ids=["em_exact", "midpoint_unprecond"])
def test_run_bd_modes_match_jax(system, mode, precond):
    """run_bd from the JAX run's draws (warm starts and the static
    block_free PC threaded): X and Q to 1e-9 every step, equal GMRES
    iterations, the truncation estimates to 1e-6 relative."""
    cfg_j, geom_j, st_j, _, geom_t, st_t = system
    cfg_j = cfg_j.replace(drift_mode=mode, lanczos_precond=precond)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    force = np.zeros((B, 6))
    force[:, 2] = -1.0
    key = jax.random.key(21)
    fin_j, tr_j = jax_fast(functools.partial(
        run_bd_j, geom_j, cfg_j, n_steps=N_STEPS,
        force_fn=lambda s, i: jnp.asarray(force)), st_j, key)
    draws = _run_draws(key, 12, mode)
    fin_t, tr_t = run_bd_t(geom_t, cfg_t, st_t, N_STEPS,
                           force_fn=lambda s, i: torch.from_numpy(force),
                           draws_fn=lambda i: draws[i])
    assert tr_t["iters"].tolist() == np.asarray(tr_j["iters"]).tolist()
    for name in ("X", "Q"):
        np.testing.assert_allclose(tr_t[name].numpy(), np.asarray(tr_j[name]),
                                   rtol=0, atol=STATE_TOL)
    np.testing.assert_allclose(tr_t["noise_err"].numpy(),
                               np.asarray(tr_j["noise_err"]), rtol=1e-6)
    assert (fin_t.X - st_t.X).abs().max() > 1e-3
