"""Port parity of the fluctuating BD step against the JAX package, float64,
from identical Gaussian draws: the fused preconditioned two-draw Lanczos
noise, the RFD drift and one whole ``stochastic_step``.

PyTorch generators do not reproduce ``jax.random``, so the draws the JAX
step makes from its key (``split(key, 3)``, stepper.py:176) are rebuilt
here and handed to the port as numpy arrays.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig, load_structure  # noqa: E402
from rigid_body_light_tpu.dynamics import stochastic_step as step_j  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin_j  # noqa: E402
from rigid_body_light_tpu.ops import lanczos as lanczos_j  # noqa: E402
from rigid_body_light_tpu.ops import rfd as rfd_j  # noqa: E402
from rigid_body_light_tpu.ops import saddle as saddle_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import stochastic_step as step_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import lanczos as lanczos_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import rfd as rfd_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as saddle_t  # noqa: E402

B = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_step_draws(key, n, dtype):
    """The (W1, W2, W_rfd) that the JAX stochastic_step draws from ``key``."""
    k1, k2, k3 = jax.random.split(key, 3)
    return (np.array(jax.random.normal(k1, (B * 3 * n,), dtype)),
            np.array(jax.random.normal(k2, (B * 3 * n,), dtype)),
            np.array(jax.random.normal(k3, (B, n, 3), dtype)))


@pytest.fixture(scope="module")
def system():
    """4 × shell_N_42 above the wall (heights 1.6-2.5, blobs down to
    ~0.7 above it), float64, both packages."""
    params, ref = load_structure("shell_N_42")
    X = np.array([[2.5 * (i % 2), 2.5 * (i // 2), 1.6 + 0.3 * i]
                  for i in range(B)])
    Q = np.random.default_rng(4).standard_normal((B, 4))
    cfg_j = SimulationConfig(a=params["sep"] / 2, dt=0.01, kBT=1.0,
                             wall=True, dtype=jnp.float64, lanczos_iters=6,
                             gmres_tol=1e-8, gmres_restart=20,
                             gmres_maxiter=60, pc_mode="block_free")
    geom_j = kin_j.make_ref_geometry(ref, dtype=jnp.float64)
    st_j = make_state_j(X, Q, dtype=jnp.float64)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    geom_t = interop.geometry_from_numpy(ref, dtype=torch.float64,
                                         device="cpu")
    st_t = interop.state_from_numpy(st_j.X, st_j.Q, dtype=torch.float64,
                                    device="cpu")
    force = np.zeros((B, 6))
    force[:, 2] = -1.0
    return cfg_j, geom_j, st_j, cfg_t, geom_t, st_t, force, ref.shape[0]


def _rel(t, j):
    j = np.asarray(j)
    return np.abs(np.asarray(t) - j).max() / np.abs(j).max()


def test_fused_precond_noise_matches(system):
    cfg_j, geom_j, st_j, cfg_t, geom_t, st_t, _, n = system
    W1, W2, _ = jax_step_draws(jax.random.key(3), n, jnp.float64)
    L, L_inv = lanczos_j.make_noise_preconditioner(geom_j.ref_cfg, cfg_j.a,
                                                   cfg_j.eta, jnp.float64)
    ops_j = saddle_j.geometry_ops(geom_j, st_j)
    k1, k2, _ = jax.random.split(jax.random.key(3), 3)
    out_j = lanczos_j.m_half_w_precond(
        saddle_j.mobility_apply_multi_fn(cfg_j), ops_j.flat_positions,
        ops_j.rot, L, L_inv, (k1, k2), iters=6, multi=True, return_err=True)
    L_t, Li_t = lanczos_t.make_noise_preconditioner(geom_t.ref_cfg, cfg_t.a,
                                                    cfg_t.eta)
    assert _rel(L_t, L) < 1e-12 and _rel(Li_t, L_inv) < 1e-10
    # the JAX factors, carried across, drive the port's recurrence
    L_t, Li_t = interop.noise_pc_from_numpy(L, L_inv, dtype=torch.float64,
                                            device="cpu")
    ops_t = saddle_t.geometry_ops(geom_t, st_t)
    out_t = lanczos_t.m_half_w_precond(
        saddle_t.mobility_apply_multi_fn(cfg_t), ops_t.flat_positions,
        ops_t.rot, L_t, Li_t, torch.from_numpy(np.stack([W1, W2])), iters=6,
        multi=True, return_err=True)
    assert _rel(out_t[0], out_j[0]) < 1e-10
    assert _rel(out_t[1], out_j[1]) < 1e-10
    np.testing.assert_allclose(float(out_t[2]), float(out_j[2]), rtol=1e-6)


def test_rfd_drift_matches(system):
    cfg_j, geom_j, st_j, cfg_t, geom_t, st_t, _, n = system
    _, _, W_rfd = jax_step_draws(jax.random.key(3), n, jnp.float64)
    _, _, k3 = jax.random.split(jax.random.key(3), 3)
    d_j = rfd_j.m_rfd(geom_j, st_j, saddle_j.geometry_ops(geom_j, st_j),
                      cfg_j, k3)
    d_t = rfd_t.m_rfd(geom_t, st_t, saddle_t.geometry_ops(geom_t, st_t),
                      cfg_t, torch.from_numpy(W_rfd))
    # float64: the 1/δ = 1e4 amplification leaves ~1e-12 relative
    assert _rel(d_t, d_j) < 1e-9


def test_stochastic_step_matches_float64(system):
    cfg_j, geom_j, st_j, cfg_t, geom_t, st_t, force, n = system
    key = jax.random.key(5)
    s_j, aux_j = jax.jit(functools.partial(step_j, geom_j, cfg_j))(
        st_j, key, jnp.asarray(force))
    s_t, aux_t = step_t(geom_t, cfg_t, st_t, torch.from_numpy(force),
                        draws=jax_step_draws(key, n, jnp.float64))
    assert aux_t.iters == int(aux_j.iters)
    np.testing.assert_allclose(s_t.X.numpy(), np.asarray(s_j.X), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(s_t.Q.numpy(), np.asarray(s_j.Q), rtol=0,
                               atol=1e-9)
    assert float(aux_t.residual) < cfg_t.gmres_tol
    np.testing.assert_allclose(float(aux_t.noise_err),
                               float(aux_j.noise_err), rtol=1e-6)
    assert np.abs(s_t.X.numpy() - np.asarray(st_j.X)).max() > 1e-4  # moved


def test_commit_guards_match(system):
    """Per-body rejection in the commit, one guard per body: body 0 (at
    height 1.6, radius 0.89) sinks a blob below the wall by a move under
    max_move·a, body 1 translates more than max_move·a, body 2 rotates
    more than max_rotation, body 3 moves."""
    from rigid_body_light_tpu.dynamics.stepper import _commit as commit_j
    from rigid_body_light_tpu_torch.dynamics.stepper import _commit as commit_t

    cfg_j, geom_j, st_j, cfg_t, geom_t, st_t, _, _ = system
    dU = np.zeros((B, 6))
    dU[0, 2] = -4.0 * cfg_t.a
    dU[1, 0] = 6.0 * cfg_t.a
    dU[2, 5] = 0.6
    dU[3] = [0.01, 0.02, -0.01, 0.05, 0.0, 0.02]
    c_j = commit_j(geom_j, cfg_j, st_j, jnp.asarray(dU))
    c_t = commit_t(geom_t, cfg_t, st_t, torch.from_numpy(dU))
    np.testing.assert_allclose(c_t.X.numpy(), np.asarray(c_j.X), atol=1e-14)
    np.testing.assert_allclose(c_t.Q.numpy(), np.asarray(c_j.Q), atol=1e-14)
    moved = (c_t.X != st_t.X).any(dim=1) | (c_t.Q != st_t.Q).any(dim=1)
    assert moved.tolist() == [False, False, False, True]


def test_package_never_imports_jax():
    """Importing the port (every subpackage) leaves jax, and the JAX
    package, out of sys.modules."""
    code = ("import sys, rigid_body_light_tpu_torch, "
            "rigid_body_light_tpu_torch.ops, "
            "rigid_body_light_tpu_torch.dynamics, "
            "rigid_body_light_tpu_torch.interop, "
            "rigid_body_light_tpu_torch.ops.cuda_build, "
            "rigid_body_light_tpu_torch.ops.tiles, "
            "rigid_body_light_tpu_torch.ops.farfield, "
            "rigid_body_light_tpu_torch.ops.farfield_cuda, "
            "rigid_body_light_tpu_torch.ops.ewald, "
            "rigid_body_light_tpu_torch.ops.ewald_cuda, "
            "rigid_body_light_tpu_torch.utils, "
            "rigid_body_light_tpu_torch.utils.roofline, "
            "rigid_body_light_tpu_torch.utils.validation; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rigid_body_light_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)
