"""Port parity of the unpreconditioned Lanczos noise and the exact drift
against the JAX package on the CPU, float64: ``lanczos.sqrt_matvec``,
``m_half_w`` and ``m_half_w_pair``; ``rfd.m_rfd_from_u``,
``kt_rfd_from_u``, ``kt_inv_rfd`` and ``n_rfd_exact``, each from the
draws the JAX function makes from its key; and the float32 floor of
``n_rfd_exact``'s δ.

The system: 3 × shell_N_12 above the wall, solved to gmres_tol 1e-12:
``n_rfd_exact`` divides the difference of two solves by δ = 1e-4, so two
solves stopped at 1e-10 that differ in their roundoff alone put the
trajectories ~1e-9 apart after two steps.  The JAX references are
compiled at XLA's cheapest CPU optimization (:func:`jax_fast`).  The
steppers' modes: ``tests/test_torch_noise_drift_step.py`` (``run_bd``)
and ``tests/test_torch_noise_drift_multi.py`` (``run_bd_multi``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig, load_structure  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin_j  # noqa: E402
from rigid_body_light_tpu.ops import lanczos as lanczos_j  # noqa: E402
from rigid_body_light_tpu.ops import rfd as rfd_j  # noqa: E402
from rigid_body_light_tpu.ops import rpy as rpy_j  # noqa: E402
from rigid_body_light_tpu.ops import saddle as saddle_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.ops import lanczos, rfd, rpy  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as saddle_t  # noqa: E402

B = 3
# the functions against the JAX package on the same draws, absolute
FN_TOL = 1e-10
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


@pytest.fixture(scope="module")
def system():
    params, ref = load_structure("shell_N_12")
    X = np.array([[0.0, 0.0, 1.4], [2.3, 0.2, 1.6], [0.4, 2.2, 1.8]])
    Q = np.random.default_rng(4).standard_normal((B, 4))
    cfg_j = SimulationConfig(a=params["sep"] / 2, dt=0.01, kBT=1.0,
                             wall=True, dtype=jnp.float64, lanczos_iters=6,
                             gmres_tol=1e-12, gmres_restart=40,
                             gmres_maxiter=200, pc_mode="block_free")
    geom_j = kin_j.make_ref_geometry(ref, dtype=jnp.float64)
    st_j = make_state_j(X, Q, dtype=jnp.float64)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    geom_t = interop.geometry_from_numpy(ref, dtype=torch.float64,
                                         device="cpu")
    st_t = interop.state_from_numpy(st_j.X, st_j.Q, dtype=torch.float64,
                                    device="cpu")
    return cfg_j, geom_j, st_j, cfg_t, geom_t, st_t


def _close(t, j, tol=FN_TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


def test_sqrt_matvec_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((24, 24))
    A = A @ A.T + 24 * np.eye(24)
    w = rng.standard_normal(24)
    ref = jax_fast(lambda v: lanczos_j.sqrt_matvec(
        lambda x: jnp.asarray(A) @ x, v, iters=12), jnp.asarray(w))
    out = lanczos.sqrt_matvec(lambda v: torch.from_numpy(A) @ v,
                              torch.from_numpy(w), iters=12)
    _close(out, ref)


def test_m_half_w_and_pair_match_jax(system):
    """The plain-space draws through the damped wall product, from the
    draws the JAX functions make from their keys: one (with its truncation
    estimate) and the fused pair."""
    cfg_j, geom_j, st_j, cfg_t, geom_t, st_t = system
    pos_j = kin_j.blob_positions(geom_j, st_j.X, st_j.Q).reshape(-1, 3)
    a = cfg_j.a
    k1, k2 = jax.random.split(jax.random.key(3))

    def mob_j(F, r):
        return rpy_j.mobility_apply(F, r, a, 1.0, True)

    def mob2_j(Fs, r):
        return rpy_j.mobility_apply_multi(Fs, r, a, 1.0, True)

    def run_j(p):
        one = lanczos_j.m_half_w(mob_j, p, k1, iters=8, return_err=True)
        pair = lanczos_j.m_half_w_pair(mob2_j, p, k1, k2, iters=8,
                                       return_err=True)
        return one, pair

    (m1_j, e1_j), (p1_j, p2_j, pe_j) = jax_fast(run_j, pos_j)
    n3 = pos_j.size
    w1 = torch.from_numpy(np.array(jax.random.normal(k1, (n3,), jnp.float64)))
    w2 = torch.from_numpy(np.array(jax.random.normal(k2, (n3,), jnp.float64)))
    pos_t = torch.from_numpy(np.array(pos_j))
    m1_t, e1_t = lanczos.m_half_w(
        lambda F, r: rpy.mobility_apply(F, r, a, 1.0, True), pos_t, w1,
        iters=8, return_err=True)
    p1_t, p2_t, pe_t = lanczos.m_half_w_pair(
        lambda Fs, r: rpy.mobility_apply_multi(Fs, r, a, 1.0, True), pos_t,
        torch.stack([w1, w2]), iters=8, return_err=True)
    assert m1_t.shape == (B * 12, 3)
    for t, j in ((m1_t, m1_j), (p1_t, p1_j), (p2_t, p2_j)):
        _close(t, j)
    np.testing.assert_allclose(float(e1_t), float(e1_j), rtol=1e-6)
    np.testing.assert_allclose(float(pe_t), float(pe_j), rtol=1e-6)


def test_rfd_functions_match_jax(system):
    """m_rfd_from_u and kt_rfd_from_u on a caller's (u, w); kt_inv_rfd and
    n_rfd_exact from the (B, 6) draw the JAX functions make from their
    key."""
    cfg_j, geom_j, st_j, cfg_t, geom_t, st_t = system
    rng = np.random.default_rng(9)
    u = rng.standard_normal((B, 6))
    w = rng.standard_normal((B * 12, 3))
    key = jax.random.key(5)
    ops_j = saddle_j.geometry_ops(geom_j, st_j)

    def run_j(st):
        return (rfd_j.m_rfd_from_u(geom_j, st, cfg_j, u, w),
                rfd_j.kt_rfd_from_u(geom_j, st, cfg_j, u, w),
                rfd_j.kt_inv_rfd(geom_j, st, ops_j, cfg_j, key),
                rfd_j.n_rfd_exact(geom_j, st, cfg_j, key))

    refs = jax_fast(run_j, st_j)
    W = torch.from_numpy(np.array(jax.random.normal(key, (B, 6),
                                                    jnp.float64)))
    ops_t = saddle_t.geometry_ops(geom_t, st_t)
    u_t, w_t = torch.from_numpy(u), torch.from_numpy(w)
    outs = (rfd.m_rfd_from_u(geom_t, st_t, cfg_t, u_t, w_t),
            rfd.kt_rfd_from_u(geom_t, st_t, cfg_t, u_t, w_t),
            rfd.kt_inv_rfd(geom_t, st_t, ops_t, cfg_t, W),
            rfd.n_rfd_exact(geom_t, st_t, cfg_t, W))
    assert [tuple(o.shape) for o in outs] == [(B * 12, 3), (B, 6), (B, 6),
                                              (B, 6)]
    for t, j in zip(outs, refs):
        # n_rfd_exact: two solves stopped at gmres_tol, over δ
        _close(t, j, FN_TOL if t is not outs[3] else 1e-8)
        assert np.abs(np.asarray(j)).max() > 0


def test_n_rfd_exact_floors_delta_in_float32(system):
    """In float32 δ is max(rfd_delta, 1e-2): the float32 drift is the
    float64 drift at δ = 1e-2 (not at the configured 1e-4) to float32
    roundoff over δ."""
    cfg_t, geom_t, st_t = system[3:]
    assert rfd.rfd_delta(cfg_t, torch.float64) == cfg_t.rfd_delta == 1e-4
    assert rfd.rfd_delta(cfg_t, torch.float32) == 1e-2
    W = torch.from_numpy(np.random.default_rng(2).standard_normal((B, 6)))
    cfg32 = cfg_t.replace(dtype=torch.float32, gmres_tol=1e-6)
    g32 = geom_t._replace(**{f: getattr(geom_t, f).float()
                             for f in geom_t._fields})
    st32 = type(st_t)(X=st_t.X.float(), Q=st_t.Q.float())
    d32 = rfd.n_rfd_exact(g32, st32, cfg32, W.float())
    d64 = rfd.n_rfd_exact(geom_t, st_t, cfg_t.replace(rfd_delta=1e-2), W)
    rel = ((d32.double() - d64).abs().max() / d64.abs().max()).item()
    assert rel < 1e-2
