"""Port parity of ``run_bd`` against the JAX package, float64: a 3-step
trajectory from the JAX key's per-step draws (``split`` at stepper.py:384,
then ``split(sub, 3)`` inside the step), with the static block_free PC and
the lagged diag PC; and the port's own generator-driven runs."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig, load_structure  # noqa: E402
from rigid_body_light_tpu.dynamics import run_bd as run_bd_j  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import run_bd as run_bd_t  # noqa: E402

B = 4
N_STEPS = 3


def jax_run_draws(key, n, n_steps, dtype):
    """Per-step (W1, W2, W_rfd) that the JAX run_bd draws from ``key``."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        k1, k2, k3 = jax.random.split(sub, 3)
        out.append((np.array(jax.random.normal(k1, (B * 3 * n,), dtype)),
                    np.array(jax.random.normal(k2, (B * 3 * n,), dtype)),
                    np.array(jax.random.normal(k3, (B, n, 3), dtype))))
    return out


def _setup(dtype_j, **cfg_kw):
    params, ref = load_structure("shell_N_12")
    X = np.array([[2.5 * (i % 2), 2.5 * (i // 2), 1.5 + 0.3 * i]
                  for i in range(B)])
    Q = np.random.default_rng(8).standard_normal((B, 4))
    cfg_j = SimulationConfig(a=params["sep"] / 2, dt=0.01, kBT=1.0,
                             wall=True, dtype=dtype_j, lanczos_iters=6,
                             gmres_restart=20, gmres_maxiter=60, **cfg_kw)
    return cfg_j, ref, X, Q


@pytest.mark.parametrize("pc_kw", [
    dict(pc_mode="block_free", gmres_tol=1e-8),
    dict(pc_mode="diag", pc_refresh=2, gmres_tol=1e-8),
], ids=["block_free", "lagged_diag"])
def test_run_bd_matches_float64(pc_kw):
    cfg_j, ref, X, Q = _setup(jnp.float64, **pc_kw)
    n = ref.shape[0]
    geom_j = kin_j.make_ref_geometry(ref, dtype=jnp.float64)
    st_j = make_state_j(X, Q, dtype=jnp.float64)
    force = np.zeros((B, 6))
    force[:, 2] = -1.0
    key = jax.random.key(21)
    fin_j, tr_j = run_bd_j(geom_j, cfg_j, st_j, key, N_STEPS,
                           force_fn=lambda s, i: jnp.asarray(force))

    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    geom_t = interop.geometry_from_numpy(ref, dtype=torch.float64)
    st_t = interop.state_from_numpy(st_j.X, st_j.Q, dtype=torch.float64)
    draws = jax_run_draws(key, n, N_STEPS, jnp.float64)
    fin_t, tr_t = run_bd_t(geom_t, cfg_t, st_t, N_STEPS,
                           force_fn=lambda s, i: torch.from_numpy(force),
                           draws_fn=lambda i: draws[i])

    np.testing.assert_array_equal(tr_t["iters"].numpy(),
                                  np.asarray(tr_j["iters"]))
    for name in ("X", "Q"):
        np.testing.assert_allclose(tr_t[name].numpy(), np.asarray(tr_j[name]),
                                   rtol=0, atol=1e-9)
    np.testing.assert_allclose(fin_t.X.numpy(), np.asarray(fin_j.X), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(tr_t["noise_err"].numpy(),
                               np.asarray(tr_j["noise_err"]), rtol=1e-6)
    assert tr_t["residual"].max() < cfg_t.gmres_tol


def test_run_bd_generator_is_reproducible():
    """Draws from a seeded torch.Generator: the same seed gives the same
    trajectory; it stays finite, unit-quaternion and converged."""
    cfg_j, ref, X, Q = _setup(jnp.float32, pc_mode="block_free",
                              gmres_tol=1e-4)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    geom_t = interop.geometry_from_numpy(ref)
    st_t = interop.state_from_numpy(X, Q / np.linalg.norm(Q, axis=1)[:, None])

    def run(seed, save_every=1):
        gen = torch.Generator().manual_seed(seed)
        return run_bd_t(geom_t, cfg_t, st_t, 4, generator=gen,
                        save_every=save_every)

    fin_a, tr_a = run(7)
    fin_b, tr_b = run(7, save_every=2)
    torch.testing.assert_close(fin_a.X, fin_b.X, rtol=0, atol=0)
    assert tr_b["X"].shape == (2, B, 3)
    torch.testing.assert_close(tr_b["X"], tr_a["X"][1::2], rtol=0, atol=0)
    assert torch.isfinite(tr_a["X"]).all()
    assert (tr_a["residual"] < cfg_t.gmres_tol).all()
    assert (torch.linalg.norm(fin_a.Q, dim=1) - 1).abs().max() < 1e-5
    assert (fin_a.X - st_t.X).abs().max() > 0
    fin_c, _ = run(8)
    assert not torch.equal(fin_c.X, fin_a.X)
