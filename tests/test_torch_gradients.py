"""Port parity of the adjoints: ``solvers.make_differentiable_solver``,
``dynamics.make_differentiable_step`` and the differentiable kernel
product ``rpy_cuda.MobilityApply``, on the CPU.

The five tests of the JAX package's ``tests/test_gradients.py`` run on the
port, each against its central differences at the JAX test's ε and bound,
and against the JAX package's ``jax.grad`` on the same inputs to 1e-9
(float64; the JAX gradients compiled at XLA's cheapest CPU optimization,
:func:`jax_fast`).  The Function's force and position cotangents are held
against ``torch.autograd`` through the plain ``rpy.mobility_apply``
directly (float32: on the CPU the Function runs the plain sweep), and the
differentiable solve through the Function (float32, ``use_pallas``)
against the float64 one.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig, load_structure  # noqa: E402
from rigid_body_light_tpu.dynamics import make_differentiable_step as mds_j  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin_j  # noqa: E402
from rigid_body_light_tpu.ops import saddle as sad_j  # noqa: E402
from rigid_body_light_tpu.ops import solvers as solvers_j  # noqa: E402
from rigid_body_light_tpu.state import BodyState as BodyState_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import make_differentiable_step  # noqa: E402
from rigid_body_light_tpu_torch.ops import cuda_build  # noqa: E402
from rigid_body_light_tpu_torch.ops import kinematics as kin_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import rpy, rpy_cuda  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as sad_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import solvers as solvers_t  # noqa: E402
from rigid_body_light_tpu_torch.state import BodyState  # noqa: E402

# the port's gradient against the JAX package's, float64
JAX_TOL = 1e-9
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
ID2 = [[1.0, 0, 0, 0]] * 2


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _setup(**kw):
    """The JAX test's setup in both packages: shell_N_12 at a = sep/2,
    float64, gmres_tol 1e-12."""
    params, ref = load_structure("shell_N_12")
    cfg_j = SimulationConfig(a=params["sep"] / 2, dtype=jnp.float64,
                             gmres_tol=1e-12, gmres_maxiter=400, **kw)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    geom_j = kin_j.make_ref_geometry(ref, dtype=jnp.float64)
    geom_t = interop.geometry_from_numpy(ref, dtype=torch.float64,
                                         device="cpu")
    return cfg_j, geom_j, cfg_t, geom_t


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _ops_t(geom, X, Q):
    return sad_t.geometry_ops(geom, BodyState(X=_t(X), Q=_t(Q)))


def test_force_gradient_is_symmetric_mobility():
    """∂(v·U)/∂F = N·v, checked by a solve with force v."""
    cfg_j, geom_j, cfg_t, geom_t = _setup()
    X, Q = [[0.0, 0, 0], [3.0, 0, 0]], ID2
    rng = np.random.default_rng(0)
    F = rng.standard_normal((2, 6))
    v = rng.standard_normal((2, 6))
    solve = solvers_t.make_differentiable_solver(cfg_t)
    ops = _ops_t(geom_t, X, Q)
    slip = torch.zeros((24, 3), dtype=torch.float64)
    Ft = _t(F).requires_grad_()
    _, U = solve(ops, slip, Ft)
    (g,) = torch.autograd.grad(torch.sum(U * _t(v)), Ft)
    _, Nv = solve(ops, slip, _t(v))
    np.testing.assert_allclose(g.numpy(), Nv.numpy(), rtol=0, atol=1e-9)

    solve_j = solvers_j.make_differentiable_solver(cfg_j)
    ops_j = sad_j.geometry_ops(geom_j, make_state_j(X, Q,
                                                    dtype=jnp.float64))
    g_j = jax_fast(jax.grad(lambda F_: jnp.sum(
        solve_j(ops_j, jnp.zeros((24, 3)), F_)[1] * jnp.asarray(v))),
        jnp.asarray(F))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=0,
                               atol=JAX_TOL)


def test_position_gradient_vs_finite_difference():
    """∂(U_z of body 0)/∂(X of body 1): the implicit adjoint against
    centered differences (ε 1e-5, within 1e-6) and JAX's gradient."""
    cfg_j, geom_j, cfg_t, geom_t = _setup()
    solve = solvers_t.make_differentiable_solver(cfg_t)
    F = torch.zeros((2, 6), dtype=torch.float64)
    F[:, 2] = -1.0
    slip = torch.zeros((24, 3), dtype=torch.float64)
    Q = _t(ID2)

    def uz(X):
        ops = sad_t.geometry_ops(geom_t, BodyState(X=X, Q=Q))
        return solve(ops, slip, F)[1][0, 2]

    X0 = np.array([[0.0, 0, 0], [3.0, 0.5, -0.2]])
    X0t = _t(X0).requires_grad_()
    (g,) = torch.autograd.grad(uz(X0t), X0t)
    eps = 1e-5
    for idx in [(1, 0), (1, 2), (0, 1)]:
        Xp, Xm = _t(X0), _t(X0)
        Xp[idx] += eps
        Xm[idx] -= eps
        with torch.no_grad():
            fd = (uz(Xp) - uz(Xm)) / (2 * eps)
        assert abs(float(g[idx]) - float(fd)) < 1e-6, (idx, float(g[idx]),
                                                       float(fd))

    solve_j = solvers_j.make_differentiable_solver(cfg_j)

    def uz_j(X):
        state = BodyState_j(X=X, Q=jnp.asarray(ID2))
        ops = sad_j.geometry_ops(geom_j, state)
        return solve_j(ops, jnp.zeros((24, 3)), jnp.asarray(F.numpy()))[1][0, 2]

    g_j = jax_fast(jax.grad(uz_j), jnp.asarray(X0))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=0,
                               atol=JAX_TOL)


def test_slip_gradient_flows():
    """d(swim speed)/d(uniform slip): the adjoint against centered
    differences (ε 1e-6, within 1e-6) and JAX's gradient."""
    cfg_j, geom_j, cfg_t, geom_t = _setup()
    solve = solvers_t.make_differentiable_solver(cfg_t)
    ops = _ops_t(geom_t, [[0.0, 0, 0]], [[1.0, 0, 0, 0]])
    F = torch.zeros((1, 6), dtype=torch.float64)

    def swim_speed(m):
        return solve(ops, m * torch.ones((12, 3), dtype=torch.float64),
                     F)[1][0, 0]

    m = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(swim_speed(m), m)
    with torch.no_grad():
        fd = (swim_speed(torch.tensor(0.1 + 1e-6, dtype=torch.float64))
              - swim_speed(torch.tensor(0.1 - 1e-6, dtype=torch.float64))
              ) / 2e-6
    assert abs(float(g) - float(fd)) < 1e-6

    solve_j = solvers_j.make_differentiable_solver(cfg_j)
    ops_j = sad_j.geometry_ops(geom_j, make_state_j([[0.0, 0, 0]],
                                                    [[1.0, 0, 0, 0]],
                                                    dtype=jnp.float64))
    g_j = jax_fast(jax.grad(lambda s: solve_j(
        ops_j, jnp.full((12, 3), s, jnp.float64),
        jnp.zeros((1, 6), jnp.float64))[1][0, 0]), jnp.float64(0.1))
    assert abs(float(g) - float(g_j)) < JAX_TOL


def test_rotation_gradient_at_zero():
    """∂q/∂ω at ω = 0 is finite, 0.5 a component, as the JAX package's (the
    square root at the origin behind a double select)."""
    Q = torch.tensor([[1.0, 0, 0, 0]], dtype=torch.float64)
    dU = torch.zeros((1, 6), dtype=torch.float64, requires_grad=True)
    _, Qn = kin_t.update_X_Q(torch.zeros((1, 3), dtype=torch.float64), Q, dU)
    (g,) = torch.autograd.grad(torch.sum(Qn), dU)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g[0, 3:].numpy(), 0.5)

    g_j = jax.grad(lambda d: jnp.sum(kin_j.update_X_Q(
        jnp.zeros((1, 3)), jnp.asarray(Q.numpy()), d)[1]))(jnp.zeros((1, 6)))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=0,
                               atol=JAX_TOL)


def test_differentiable_full_step_vs_finite_differences():
    """The adjoint through geometry → solve → quaternion commit: the
    gradient of the final heights after 3 chained steps with respect to
    the force and the initial configuration, against centered differences
    (ε 1e-6; bounds 1e-6 and 1e-5 relative above 1, as the JAX test's) and
    against JAX's gradient."""
    cfg_j, geom_j, cfg_t, geom_t = _setup(dt=0.05, use_pallas=False)
    cfg_j = cfg_j.replace(gmres_maxiter=300)
    cfg_t = cfg_t.replace(gmres_maxiter=300)
    X0 = np.array([[0.0, 0.0, 2.0], [3.0, 0.0, 2.5]])
    Q0 = _t(ID2)
    step = make_differentiable_step(geom_t, cfg_t)

    def loss(X, F):
        s = BodyState(X=X, Q=Q0)
        for _ in range(3):
            s = step(s, F)
        return torch.sum(s.X[:, 2])

    F0 = np.zeros((2, 6))
    F0[:, 2] = -1.0
    F0[0, 0] = 0.3
    Xt, Ft = _t(X0).requires_grad_(), _t(F0).requires_grad_()
    gX, gF = torch.autograd.grad(loss(Xt, Ft), (Xt, Ft))

    eps = 1e-6
    with torch.no_grad():
        for idx in [(0, 2), (1, 0), (0, 4)]:
            Fp, Fm = _t(F0), _t(F0)
            Fp[idx] += eps
            Fm[idx] -= eps
            fd = float((loss(_t(X0), Fp) - loss(_t(X0), Fm)) / (2 * eps))
            assert abs(float(gF[idx]) - fd) < 1e-6 * max(1.0, abs(fd)), idx
        for idx in [(0, 2), (1, 1)]:
            Xp, Xm = _t(X0), _t(X0)
            Xp[idx] += eps
            Xm[idx] -= eps
            fd = float((loss(Xp, _t(F0)) - loss(Xm, _t(F0))) / (2 * eps))
            assert abs(float(gX[idx]) - fd) < 1e-5 * max(1.0, abs(fd)), idx

    step_j = mds_j(geom_j, cfg_j)

    def loss_j(X, F):
        s = BodyState_j(X=X, Q=jnp.asarray(ID2))
        for _ in range(3):
            s = step_j(s, F)
        return jnp.sum(s.X[:, 2])

    gX_j, gF_j = jax_fast(jax.grad(loss_j, argnums=(0, 1)),
                          jnp.asarray(X0), jnp.asarray(F0))
    np.testing.assert_allclose(gX.numpy(), np.asarray(gX_j), rtol=0,
                               atol=JAX_TOL)
    np.testing.assert_allclose(gF.numpy(), np.asarray(gF_j), rtol=0,
                               atol=JAX_TOL)


@pytest.mark.parametrize("case", ["free", "wall", "box", "radii"])
def test_mobility_function_cotangents_match_autograd(case):
    """``rpy_cuda.MobilityApply``'s F̄ (one more product: B·M·B is
    symmetric) and r̄ against ``torch.autograd`` through the plain
    ``rpy.mobility_apply`` on the same float32 inputs; the radii get a zero
    cotangent."""
    rng = np.random.default_rng(3)
    n = 300
    r = torch.from_numpy(rng.uniform([0, 0, 0.5], [9, 9, 6], (n, 3))).float()
    F = torch.from_numpy(rng.standard_normal((n, 3))).float()
    Ub = torch.from_numpy(rng.standard_normal((n, 3))).float()
    kw = dict(a=0.9, eta=1.1, wall=case != "free")
    if case == "box":
        kw.update(box=(9.5, 9.5), image_shells=1)
    if case == "radii":
        kw["radii"] = torch.from_numpy(rng.choice([0.6, 1.0], n)).float()
        kw["radii"].requires_grad_()
    grads = []
    for fn in (rpy_cuda.mobility_apply, rpy.mobility_apply):
        r1, F1 = r.clone().requires_grad_(), F.clone().requires_grad_()
        U = fn(F1, r1, **kw)
        grads.append((U,) + torch.autograd.grad(U, (F1, r1), Ub))
    (U_k, gF_k, gr_k), (U_p, gF_p, gr_p) = grads
    # the wrapper scales the radii by 1/a, the plain sweep divides by a
    assert float((U_k - U_p).abs().max() / U_p.abs().max()) < 1e-6
    assert float((gF_k - gF_p).abs().max() / gF_p.abs().max()) < 1e-5
    assert float((gr_k - gr_p).abs().max() / gr_p.abs().max()) < 1e-6
    if case == "radii":
        U = rpy_cuda.mobility_apply(F, r, **kw)
        (g_rad,) = torch.autograd.grad(U, kw["radii"], Ub)
        assert torch.equal(g_rad, torch.zeros_like(g_rad))


def test_plain_sweep_gradient_recomputes_row_tiles():
    """Under autograd the plain sweep checkpoints its row tiles: the
    gradient equals the unchunked one's, at any row tile."""
    rng = np.random.default_rng(9)
    r = torch.from_numpy(rng.uniform([0, 0, 0.5], [6, 6, 4], (150, 3)))
    F = torch.from_numpy(rng.standard_normal((150, 3)))
    Ub = torch.from_numpy(rng.standard_normal((150, 3)))
    out = []
    for tile in (16, 512):
        r1 = r.clone().requires_grad_()
        U = rpy.mobility_apply(F, r1, wall=True, row_tile=tile)
        out.append(torch.autograd.grad(U, r1, Ub)[0])
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), rtol=0,
                               atol=1e-12)


def test_float32_solve_through_the_function():
    """The differentiable solve in float32 with ``use_pallas`` (the
    saddle's operator vjp through ``MobilityApply``, the plain sweep on
    the CPU) against the float64 one: ∂(U_z)/∂X within float32's
    reach."""
    grads = []
    for dtype in (torch.float32, torch.float64):
        _, _, cfg_t, _ = _setup(wall=True)
        cfg_t = cfg_t.replace(dtype=dtype, gmres_tol=1e-7 if dtype ==
                              torch.float32 else 1e-12)
        params, ref = load_structure("shell_N_12")
        geom = kin_t.make_ref_geometry(ref, dtype=dtype, device="cpu")
        solve = solvers_t.make_differentiable_solver(cfg_t)
        X = torch.tensor([[0.0, 0, 2.0], [3.0, 0.5, 2.4]], dtype=dtype,
                         requires_grad=True)
        Q = torch.tensor(ID2, dtype=dtype)
        F = torch.zeros((2, 6), dtype=dtype)
        F[:, 2] = -1.0
        ops = sad_t.geometry_ops(geom, BodyState(X=X, Q=Q))
        _, U = solve(ops, torch.zeros((24, 3), dtype=dtype), F)
        grads.append(torch.autograd.grad(U[0, 2], X)[0].double())
    rel = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())
    assert rel < 1e-4, rel


def test_refuse_grad_raises_only_under_autograd():
    """The guard of the kernels without a backward (K2, K3, K4): it raises
    for a tensor that requires grad with grad mode on, naming the kernel
    and the ROADMAP item, and lets everything else through."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="K3 near_sweep.*item 15"):
        cuda_build.refuse_grad("K3 near_sweep", None, x)
    with torch.no_grad():
        cuda_build.refuse_grad("K3 near_sweep", x)
    cuda_build.refuse_grad("K4 ewald_real_sweep", x.detach(), None)
