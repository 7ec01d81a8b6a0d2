"""The port's ``RigidBody`` (``rigid_body_light_tpu_torch.api``) on the CPU:
the cases of ``tests/test_interface.py``, ``test_precision.py`` and
``test_wall.py`` on the port's class; its operators and steps against the
JAX package's in float64 on the same numpy inputs; the copy rules at the
numpy boundary, the per-instance generator, the default device, and the
import graph (no module of the port, nor ``chip_smoke.py``, imports JAX or
the JAX package).  The error contract letter for letter and the float32
operators: ``tests/test_torch_validation.py``.

Tolerances: float64 operators (K, Kᵀ, the PC, M, the saddle matvec, the
sparse exports) to 1e-12 of max|ref|; one stochastic step from the JAX
key's draws and a 3-step ``run`` from its per-step draws to 1e-9 absolute
on X and Q.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import utils  # noqa: E402
from rigid_body_light_tpu import RigidBody as RigidBodyJ  # noqa: E402
from rigid_body_light_tpu import SimulationConfig as ConfigJ  # noqa: E402
from rigid_body_light_tpu.dynamics import run_bd as run_bd_j  # noqa: E402
from rigid_body_light_tpu_torch import RigidBody, SimulationConfig  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import stepper  # noqa: E402
from test_torch_noise_drift import jax_fast  # noqa: E402
from test_torch_run_bd import jax_run_draws  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHELL = utils.load_config(utils.struct_shell_12)[1]
BLOBS_PER_BODY = SHELL.shape[0]
OP_TOL = 1e-12      # float64 operators, relative to max|ref|
SOLVE_TOL = 1e-9    # float64 solves and steps, absolute


def create_solver(X, Q, rigid_config=None, wall_PC=False, block_PC=False,
                  **kw):
    """``tests/utils.create_solver`` for the port: unit parameters on the
    12-blob shell (or a given one), on the CPU."""
    if rigid_config is None:
        rigid_config = SHELL
    return RigidBody(rigid_config, X, Q, 1.0, 1.0, 1.0, wall_PC=wall_PC,
                     block_PC=block_PC, device="cpu", **kw)


def _random_system(n_bodies, wall_PC=False, seed=0, **solver_kw):
    X, Q = utils.create_random_positions(n_bodies, wall_PC=wall_PC, seed=seed)
    solver = create_solver(X=X, Q=Q, rigid_config=SHELL, wall_PC=wall_PC,
                           **solver_kw)
    return solver, X, Q


def _rel(t, j):
    j = np.asarray(j)
    return np.abs(np.asarray(t) - j).max() / np.abs(j).max()


# ------------------------------------------------- test_interface.py cases


def test_constructor_and_flag_combinations():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((10, 3))
    Q = rng.standard_normal((10, 4))
    for flags in ({}, {"wall_PC": True}, {"block_PC": True}):
        RigidBody(SHELL, X, Q, 1.0, 1.0, dt=0.01, device="cpu", **flags)


def test_constructor_rejects_non_3n_blob_config():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((10, 3))
    Q = rng.standard_normal((10, 4))
    truncated = SHELL.flatten()[:-1]
    with pytest.raises(RuntimeError):
        RigidBody(truncated, X, Q, 1.0, 1.0, dt=0.01, device="cpu")


def test_config_roundtrip_normalizes_quaternions():
    rng = np.random.default_rng(3)
    X_in = rng.random((10, 3))
    Q_in = rng.random((10, 4))
    solver = create_solver(X=X_in, Q=Q_in)
    solver.set_config(X_in, Q_in)
    X_out, Q_out = solver.get_config()
    assert np.allclose(X_out, X_in, atol=1e-6)
    Q_unit = Rotation.from_quat(Q_in).as_quat()
    assert np.allclose(Q_out, Q_unit, atol=1e-6)


def test_set_config_rejects_mismatched_body_counts():
    rng = np.random.default_rng(4)
    X = rng.random((10, 3))
    Q = rng.random((10, 4))
    solver = create_solver(X=X, Q=Q)
    for bad_X, bad_Q in ((X, Q[:9]), (X[:9], Q)):
        with pytest.raises(RuntimeError):
            solver.set_config(bad_X, bad_Q)


def test_blob_positions_match_independent_rotation():
    n_bodies = 5
    solver, X, Q = _random_system(n_bodies, seed=10)
    pos = solver.get_blob_positions()
    assert pos.shape == (n_bodies * BLOBS_PER_BODY, 3)
    centered = SHELL - SHELL.mean(axis=0)
    expected = np.concatenate([
        Rotation.from_quat(Q[b], scalar_first=True).apply(centered) + X[b]
        for b in range(n_bodies)
    ])
    assert np.allclose(pos, expected, atol=1e-5)


@pytest.mark.parametrize(
    ("method", "in_size", "out_rows"),
    [
        ("K_dot", lambda s: 6 * s.N_bodies, lambda s: s.total_blobs),
        ("KT_dot", lambda s: 3 * s.total_blobs, lambda s: 2 * s.N_bodies),
    ],
)
def test_kinematic_matvec_shapes_and_size_errors(method, in_size, out_rows):
    solver, _, _ = _random_system(3, seed=11)
    rng = np.random.default_rng(12)
    good = rng.standard_normal(in_size(solver))
    out = getattr(solver, method)(good)
    assert out.shape == (out_rows(solver), 3)
    assert np.linalg.norm(out) > 0.0
    with pytest.raises(RuntimeError):
        getattr(solver, method)(good[:-3])


def test_sparse_K_export_and_pseudoinverse_identity():
    solver, _, _ = _random_system(3, seed=13)
    K = solver.get_K()
    K_pinv = solver.get_Kinv()
    assert abs(K).sum() > 0.0
    assert abs(K_pinv).sum() > 0.0
    identity = (K_pinv @ K).toarray()
    assert np.allclose(identity, np.eye(6 * solver.N_bodies), atol=1e-4)


@pytest.mark.parametrize("wall_PC", [False, True])
@pytest.mark.parametrize("block_PC", [False, True])
def test_apply_PC_all_flag_combos(block_PC, wall_PC):
    solver, _, _ = _random_system(3, wall_PC=wall_PC, seed=14,
                                  block_PC=block_PC)
    n_sys = 3 * solver.total_blobs + 6 * solver.N_bodies
    rng = np.random.default_rng(15)
    out = solver.apply_PC(rng.standard_normal(n_sys))
    assert out.shape == (n_sys,)
    assert np.linalg.norm(out) > 0.0
    with pytest.raises(RuntimeError):
        solver.apply_PC(rng.standard_normal(n_sys - 4))


def test_apply_M_contract_and_free_blobs():
    solver, _, _ = _random_system(2, seed=16)
    rng = np.random.default_rng(17)
    F = rng.standard_normal(3 * solver.total_blobs)
    pos = solver.get_blob_positions()
    for bad_F, bad_pos in ((F[:-4], pos), (F, pos[:-3]),
                           (F[:-1], pos.ravel()[:-1])):
        with pytest.raises(RuntimeError):
            solver.apply_M(bad_F, bad_pos)
    out = solver.apply_M(F, pos)
    assert out.shape == F.shape
    assert np.linalg.norm(out) > 0.0
    F_ext = np.concatenate([F, rng.standard_normal(3)])
    pos_ext = np.concatenate([pos, rng.uniform(11.0, 15.0, (1, 3))])
    out_ext = solver.apply_M(F_ext, pos_ext)
    assert out_ext.shape == (F.size + 3,)
    assert np.linalg.norm(out_ext) > 0.0


def test_apply_saddle_shape_and_size_error():
    solver, _, _ = _random_system(2, seed=18)
    n_sys = 3 * solver.total_blobs + 6 * solver.N_bodies
    rng = np.random.default_rng(19)
    out = solver.apply_saddle(rng.standard_normal(n_sys))
    assert out.shape == (n_sys,)
    assert np.linalg.norm(out) > 0.0
    with pytest.raises(RuntimeError):
        solver.apply_saddle(rng.standard_normal(n_sys - 2))


def test_evolve_moves_state_without_mutating_input():
    solver, X, Q = _random_system(3, seed=20)
    U = np.random.default_rng(21).standard_normal(6 * 3)
    U_before = U.copy()
    solver.evolve_rigid_bodies(U)
    X_new, Q_new = solver.get_config()
    assert np.linalg.norm(X_new - X) > 0.0
    assert np.linalg.norm(Q_new - Q) > 0.0
    # the reference scales the caller's U in place (c_rigid_obj.cpp:869)
    assert np.array_equal(U, U_before)


def test_evolve_matches_axis_angle_update():
    dt = 0.125
    solver, X, Q = _random_system(2, seed=22)
    solver.config = solver.config.replace(dt=dt)
    U = np.random.default_rng(23).standard_normal(6 * 2)
    solver.evolve_rigid_bodies(U)
    X_new, Q_new = solver.get_config()
    V = U.reshape(-1, 6)
    assert np.allclose(X_new, X + dt * V[:, :3], atol=1e-6)
    for b in range(2):
        step_rot = Rotation.from_rotvec(dt * V[b, 3:])
        expected = (
            step_rot * Rotation.from_quat(Q[b], scalar_first=True)
        ).as_quat(scalar_first=True)
        got = Q_new[b]
        flip = np.sign(got @ expected)
        assert np.allclose(got, flip * expected, atol=1e-5)


@pytest.mark.medium
def test_stepping_methods_drive_the_system():
    """deterministic_step / stochastic_step / run on the class surface."""
    solver = create_solver(
        X=np.array([[0.0, 0.0, 0.0]]),
        Q=np.array([[1.0, 0.0, 0.0, 0.0]]),
        rigid_config=SHELL,
        kBT=0.5,
    )
    solver.config = solver.config.replace(dt=0.05, lanczos_iters=10)
    gravity = np.zeros((1, 6))
    gravity[0, 2] = -1.0
    U = solver.deterministic_step(gravity)
    assert U.shape == (1, 6)
    assert U[0, 2] < 0
    assert solver.get_config()[0][0, 2] < 0
    U_sto = solver.stochastic_step(
        gravity, generator=torch.Generator().manual_seed(3))
    assert np.isfinite(U_sto).all()
    traj = solver.run(5, torch.Generator().manual_seed(4))
    assert traj["X"].shape == (5, 1, 3)
    assert np.isfinite(traj["X"]).all()


# ------------------------------------------------- test_precision.py cases


@pytest.fixture(params=[np.float32, np.float64], ids=["f32-in", "f64-in"])
def in_dtype(request):
    return request.param


def test_kinematic_matvecs_accept_either_input_dtype(in_dtype):
    n_bodies = 5
    X, Q = utils.create_random_positions(n_bodies, seed=5)
    solver = create_solver(X.astype(in_dtype), Q.astype(in_dtype))
    solver.set_config(X.astype(in_dtype), Q.astype(in_dtype))
    rng = np.random.default_rng(6)
    body_vec = rng.standard_normal(6 * n_bodies).astype(in_dtype)
    blob_vec = rng.standard_normal(3 * solver.total_blobs).astype(in_dtype)
    assert np.linalg.norm(solver.K_dot(body_vec)) > 0.0
    assert np.linalg.norm(solver.KT_dot(blob_vec)) > 0.0


@pytest.mark.parametrize(("block_PC", "wall_PC"),
                         [(b, w) for b in (False, True) for w in (False, True)])
def test_preconditioner_accepts_either_input_dtype(in_dtype, block_PC,
                                                   wall_PC):
    n_bodies = 3
    X, Q = utils.create_random_positions(n_bodies, wall_PC=wall_PC, seed=7)
    solver = create_solver(X.astype(in_dtype), Q.astype(in_dtype),
                           block_PC=block_PC, wall_PC=wall_PC)
    b = np.random.default_rng(8).standard_normal(
        3 * solver.total_blobs + 6 * n_bodies).astype(in_dtype)
    assert np.linalg.norm(solver.apply_PC(b)) > 0.0


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.float64])
def test_runtime_compute_precision(compute_dtype):
    X, Q = utils.create_random_positions(2, seed=1)
    solver = create_solver(X, Q, dtype=compute_dtype)
    expect = "double" if compute_dtype == torch.float64 else "single"
    assert solver.precision == expect
    pos = solver.get_blob_positions()
    out = solver.apply_M(
        np.random.default_rng(2).standard_normal(pos.size), pos)
    assert out.dtype == (np.float64 if compute_dtype == torch.float64
                         else np.float32)


# ------------------------------------------------------ test_wall.py cases


def _solver_at_height(z):
    solver = create_solver(X=np.array([[0.0, 0.0, z]]),
                           Q=np.array([[1.0, 0.0, 0.0, 0.0]]), wall_PC=True)
    rng = np.random.default_rng(42)
    sys_vec = rng.standard_normal(3 * solver.total_blobs
                                  + 6 * solver.N_bodies)
    return solver, sys_vec


def _invoke(solver, op, sys_vec):
    if op == "apply_M":
        lam = sys_vec[: 3 * solver.total_blobs]
        return solver.apply_M(lam, solver.get_blob_positions())
    return getattr(solver, op)(sys_vec)


@pytest.mark.parametrize("op", ["apply_PC", "apply_saddle", "apply_M"])
def test_operator_finite_above_wall(op):
    solver, vec = _solver_at_height(z=1.0)
    out = _invoke(solver, op, vec)
    assert np.isfinite(out).all()
    assert np.linalg.norm(out) > 0.0


@pytest.mark.parametrize("op", ["apply_PC", "apply_saddle", "apply_M"])
def test_operator_raises_below_wall(op):
    solver, vec = _solver_at_height(z=0.0)
    with pytest.raises(RuntimeError, match="below the wall"):
        _invoke(solver, op, vec)


# ------------------------------------------- parity with the JAX package


@pytest.fixture(scope="module")
def pair64():
    """Both packages' RigidBody on 3 × shell_N_12 above the wall, float64,
    at the reference surface's unit parameters with the block PC."""
    X, Q = utils.create_random_positions(3, wall_PC=True, seed=30)
    rb_j = RigidBodyJ(SHELL, X, Q, 1.0, 1.0, 1.0, wall_PC=True,
                      block_PC=True, dtype=jnp.float64)
    rb_t = create_solver(X, Q, wall_PC=True, block_PC=True,
                         dtype=torch.float64)
    return rb_j, rb_t


def test_operators_match_jax_float64(pair64):
    rb_j, rb_t = pair64
    rng = np.random.default_rng(31)
    n_sys = 3 * rb_t.total_blobs + 6 * rb_t.N_bodies
    assert _rel(rb_t.get_blob_positions(), rb_j.get_blob_positions()) < OP_TOL
    for X_t, X_j in zip(rb_t.get_config(), rb_j.get_config()):
        assert _rel(X_t, X_j) < OP_TOL
    U = rng.standard_normal(6 * rb_t.N_bodies)
    lam = rng.standard_normal(3 * rb_t.total_blobs)
    x = rng.standard_normal(n_sys)
    for name, args in (("K_dot", (U,)), ("KT_dot", (lam,)),
                       ("apply_PC", (x,)), ("apply_saddle", (x,))):
        out_t, out_j = getattr(rb_t, name)(*args), getattr(rb_j, name)(*args)
        assert out_t.shape == out_j.shape, name
        assert _rel(out_t, out_j) < OP_TOL, name
    # apply_M with one extra free blob beyond the rigid ones
    pos = np.concatenate([rb_t.get_blob_positions(), [[9.0, 9.0, 4.0]]])
    F = rng.standard_normal(pos.size)
    assert _rel(rb_t.apply_M(F, pos), rb_j.apply_M(F, pos)) < OP_TOL
    for name in ("get_K", "get_Kinv"):
        a, b = getattr(rb_t, name)(), getattr(rb_j, name)()
        assert a.shape == b.shape
        assert _rel(a.toarray(), b.toarray()) < OP_TOL, name


def test_evolve_matches_jax_float64(pair64):
    rb_j, rb_t = pair64
    X, Q = rb_t.get_config()
    U = np.random.default_rng(32).standard_normal(6 * rb_t.N_bodies)
    rb_j.evolve_rigid_bodies(U)
    rb_t.evolve_rigid_bodies(U)
    for a, b in zip(rb_t.get_config(), rb_j.get_config()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)
    rb_j.set_config(X, Q)
    rb_t.set_config(X, Q)


@pytest.fixture(scope="module")
def noisy64():
    """4 × shell_N_12 above the wall at a = sep/2, kBT = 1, float64,
    ``block_free``, through ``config=`` on both packages."""
    params, ref = utils.load_config(utils.struct_shell_12)
    X = np.array([[2.5 * (i % 2), 2.5 * (i // 2), 1.5 + 0.3 * i]
                  for i in range(4)])
    Q = np.random.default_rng(33).standard_normal((4, 4))
    kw = dict(kBT=1.0, wall=True, pc_mode="block_free", lanczos_iters=6,
              gmres_tol=1e-10, gmres_restart=20, gmres_maxiter=60)
    cfg_j = ConfigJ(dtype=jnp.float64, **kw)
    cfg_t = SimulationConfig(dtype=torch.float64, **kw)
    a = params["sep"] / 2
    rb_j = RigidBodyJ(ref, X, Q, a, 1.0, 0.01, config=cfg_j)
    make = lambda: RigidBody(ref, X, Q, a, 1.0, 0.01, config=cfg_t,  # noqa: E731
                             device="cpu")
    force = np.zeros((4, 6))
    force[:, 2] = -1.0
    return rb_j, make, force


@pytest.fixture(scope="module")
def jax_run(noisy64):
    """The JAX package's 3-step ``dynamics.run_bd`` (what its
    RigidBody.run calls) on its instance's state, compiled here at XLA's
    cheapest optimization: (trajectory, final X, the key)."""
    rb_j, _, force = noisy64
    key = jax.random.key(35)
    fin_j, tr_j = jax_fast(
        lambda s, k: run_bd_j(rb_j._geom, rb_j.config, s, k, 3,
                              force_fn=lambda s_, i: jnp.asarray(force)),
        rb_j.state, key)
    return {k: np.asarray(v) for k, v in tr_j.items()}, np.asarray(fin_j.X), key


def test_stochastic_step_matches_jax_float64(noisy64, jax_run):
    """One step from the draws of the JAX run's first step key: that step
    is the JAX RigidBody.stochastic_step with that key (pc and warm start
    are its defaults at a first step: the static block_free PC, zeros)."""
    _, make, force = noisy64
    tr_j, _, key = jax_run
    rb_t = make()
    X0 = rb_t.get_config()[0]
    draws = jax_run_draws(key, rb_t.blobs_per_body, 1, jnp.float64)[0]
    U_t = rb_t.stochastic_step(force, draws=draws)
    X_t, Q_t = rb_t.get_config()
    np.testing.assert_allclose(X_t, tr_j["X"][0], rtol=0, atol=SOLVE_TOL)
    np.testing.assert_allclose(Q_t, tr_j["Q"][0], rtol=0, atol=SOLVE_TOL)
    np.testing.assert_allclose(X0 + 0.01 * U_t[:, :3], X_t, rtol=0,
                               atol=1e-14)
    assert np.abs(X_t - X0).max() > 1e-6


def test_run_matches_jax_float64(noisy64, jax_run):
    """A 3-step ``run`` from the JAX run's per-step draws."""
    _, make, force = noisy64
    tr_j, X_fin, key = jax_run
    rb_t = make()
    draws = jax_run_draws(key, rb_t.blobs_per_body, 3, jnp.float64)
    tr_t = rb_t.run(3, force_fn=lambda s, i: force,
                    draws_fn=lambda i: draws[i])
    for name in ("X", "Q"):
        np.testing.assert_allclose(tr_t[name], tr_j[name], rtol=0,
                                   atol=SOLVE_TOL)
    np.testing.assert_array_equal(tr_t["iters"], tr_j["iters"])
    np.testing.assert_allclose(rb_t.get_config()[0], X_fin, rtol=0,
                               atol=SOLVE_TOL)


def test_stochastic_step_adds_nothing_to_the_stepper(noisy64):
    """The wrapper's step from given draws is bitwise the stepper's."""
    _, make, force = noisy64
    rb_t = make()
    draws = stepper.make_draws(rb_t._geom, rb_t.state,
                               torch.Generator().manual_seed(36))
    st, aux = stepper.stochastic_step(rb_t._geom, rb_t.config, rb_t.state,
                                      torch.from_numpy(force), draws=draws)
    U = rb_t.stochastic_step(force, draws=draws)
    assert np.array_equal(U, aux.U.numpy())
    assert np.array_equal(rb_t.get_config()[0], st.X.numpy())
    assert np.array_equal(rb_t.get_config()[1], st.Q.numpy())


def test_instance_counter_seeds_fresh_generators(noisy64):
    """Without a generator or draws each step seeds a fresh generator from
    a per-instance counter: two fresh instances repeat each other, and a
    generator seeded as the first step's gives that step."""
    _, make, force = noisy64
    a, b, c = make(), make(), make()
    U_a1, U_b1 = a.stochastic_step(force), b.stochastic_step(force)
    assert np.array_equal(U_a1, U_b1)
    U_c1 = c.stochastic_step(force,
                             generator=torch.Generator().manual_seed(1))
    assert np.array_equal(U_a1, U_c1)
    U_a2 = a.stochastic_step(force)
    assert not np.array_equal(U_a1, U_a2)
    tr_d, tr_e = make().run(2), make().run(2)
    assert np.array_equal(tr_d["X"], tr_e["X"])


def test_default_device_is_the_card():
    """RigidBody runs on the card unless the caller names the CPU; without
    a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RigidBody(SHELL, np.zeros((1, 3)), np.array([[1.0, 0, 0, 0]]), 1.0,
                  1.0, 0.1)


# -------------------------------------------------- the numpy boundary


def test_numpy_boundary_copies():
    """On the CPU no array crosses the boundary as a view: set_config copies
    the caller's arrays, get_config / get_blob_positions return copies,
    evolve_rigid_bodies leaves the caller's U alone (float64 in, float64
    instance, where torch.as_tensor would share the buffer)."""
    X, Q = utils.create_random_positions(2, seed=41)
    X = X.copy()
    rb = create_solver(X, Q, dtype=torch.float64)
    X_keep = X.copy()
    X[:] += 100.0
    assert np.array_equal(rb.get_config()[0], X_keep)
    X_out, Q_out = rb.get_config()
    X_out[:] = 0.0
    Q_out[:] = 0.0
    pos = rb.get_blob_positions()
    pos[:] = 0.0
    assert np.array_equal(rb.get_config()[0], X_keep)
    assert np.abs(rb.get_blob_positions()).max() > 0
    U = np.random.default_rng(42).standard_normal(12)
    U_keep = U.copy()
    rb.evolve_rigid_bodies(U)
    assert np.array_equal(U, U_keep)
    flat = create_solver(X_keep.ravel(), Q.ravel(), dtype=torch.float64)
    assert flat.get_config()[0].shape == (6,)
    assert flat.K_dot(U).shape == (3 * flat.total_blobs,)


# ---------------------------------------------------------- import graph


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_port_imports_jax():
    """Every source file of the port, and chip_smoke.py, imports neither
    jax nor the JAX package (statically, at any depth of a function); and
    importing every module of the port loads neither."""
    pkg = os.path.join(REPO, "rigid_body_light_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    modules = []
    for root, _, names in os.walk(pkg):
        for name in sorted(names):
            if name.endswith(".py"):
                files.append(os.path.join(root, name))
                rel = os.path.relpath(os.path.join(root, name), REPO)[:-3]
                modules.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    assert len(modules) > 30
    for path in files:
        bad = [m for m in _imports(path)
               if m.split(".")[0] in ("jax", "jaxlib", "rigid_body_light_tpu")]
        assert not bad, (path, bad)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rigid_body_light_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)
