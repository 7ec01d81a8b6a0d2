"""The port's state validation (``utils/validation.py``), the RigidBody
error contract and the dense and grand mobility helpers on the CPU,
against the JAX package on the same numpy inputs.

The cases of ``tests/test_validation.py`` and
``tests/test_periodic.py::test_box_too_small_for_body_raises`` /
``::test_overlap_check_sees_wrapped_distance`` on the port; ``diagnose``,
``rpy.apply_M_dense`` and ``saddle.grand_body_mobility`` against the JAX
package to 1e-12 of max|ref| in float64; every RuntimeError / ValueError
text of ``RigidBody`` and ``assert_valid`` letter for letter the JAX
package's; the float32 instance's products at the JAX tests' float32
bounds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import utils  # noqa: E402
from rigid_body_light_tpu import RigidBody as RigidBodyJ  # noqa: E402
from rigid_body_light_tpu import SimulationConfig as ConfigJ  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin_j  # noqa: E402
from rigid_body_light_tpu.ops import rpy as rpy_j  # noqa: E402
from rigid_body_light_tpu.ops import saddle as saddle_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu.utils import validation as validation_j  # noqa: E402
from rigid_body_light_tpu_torch import RigidBody, SimulationConfig  # noqa: E402
from rigid_body_light_tpu_torch import interop, load_structure  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import run_bd  # noqa: E402
from rigid_body_light_tpu_torch.ops import rpy, saddle  # noqa: E402
from rigid_body_light_tpu_torch.utils import validation  # noqa: E402
from test_torch_noise_drift import jax_fast  # noqa: E402

OP_TOL = 1e-12      # float64, relative to max|ref|
SHELL = utils.load_config(utils.struct_shell_12)[1]


def _rel(t, j):
    j = np.asarray(j)
    return np.abs(np.asarray(t) - j).max() / np.abs(j).max()


def _t(x):
    return torch.as_tensor(np.array(x))


# ------------------------------------------------ test_validation.py cases


def test_diagnose_clean_state():
    r = _t([[0.0, 0, 1], [3.0, 0, 1], [0, 3.0, 2]])
    Q = _t([[1.0, 0, 0, 0]])
    d = validation.diagnose(r, Q)
    assert abs(float(d.min_separation) - 3.0) < 1e-6
    assert int(d.n_below_wall) == 0
    assert float(d.max_quat_err) < 1e-7
    validation.assert_valid(d, wall=True)


def test_diagnose_overlap_and_below_wall():
    r = _t([[0.0, 0, 1], [1e-9, 0, 1], [0, 0, -0.5]])
    Q = _t([[1.0, 0, 0, 0]])
    d = validation.diagnose(r, Q, a=1.0)
    assert float(d.min_separation) < 1e-6
    assert int(d.n_below_wall) == 1
    with pytest.raises(RuntimeError, match="OVERLAPPING"):
        validation.assert_valid(d)
    d2 = validation.diagnose(_t([[0.0, 0, 1], [0, 0, -0.5]]), Q)
    with pytest.raises(RuntimeError, match="below the wall"):
        validation.assert_valid(d2, wall=True)


def test_diagnose_tiled_matches_direct():
    rng = np.random.default_rng(0)
    r = rng.uniform(-5, 5, (77, 3))
    Q = rng.standard_normal((4, 4))
    d_tiled = validation.diagnose(_t(r), _t(Q), a=0.5, row_tile=16)
    dist = np.linalg.norm(r[:, None] - r[None, :], axis=-1)
    dist[np.arange(77), np.arange(77)] = np.inf
    assert abs(float(d_tiled.min_separation) - dist.min() / 0.5) < 1e-6


def test_bad_quaternions_flagged():
    d = validation.diagnose(_t([[0.0, 0, 1], [3.0, 0, 1]]),
                            _t([[1.1, 0, 0, 0]]))
    with pytest.raises(RuntimeError, match="unit norm"):
        validation.assert_valid(d)


def test_api_rejects_coincident_blobs_on_set_config():
    params, cfgb = load_structure("shell_N_12")
    Q = np.tile([1.0, 0, 0, 0], (2, 1))
    with pytest.raises(RuntimeError, match="OVERLAPPING"):
        RigidBody(cfgb, np.array([[0.0, 0, 3], [0.0, 0, 3]]), Q,
                  params["sep"] / 2, 1.0, 0.1, device="cpu")


def test_api_rejects_overlap_in_apply_m_positions():
    params, cfgb = load_structure("shell_N_12")
    Q = np.tile([1.0, 0, 0, 0], (2, 1))
    rb = RigidBody(cfgb, np.array([[0.0, 0, 3], [5.0, 0, 3]]), Q,
                   params["sep"] / 2, 1.0, 0.1, device="cpu")
    r_bad = np.array([[0.0, 0, 3], [0.0, 0, 3]])
    with pytest.raises(RuntimeError, match="OVERLAPPING"):
        rb.apply_M(np.ones(6), r_bad.ravel())


def test_api_rejects_collinear_body():
    dimer = np.array([[0.0, 0, 0], [0.0, 0, 2.0]])
    X = np.array([[0.0, 0, 3], [5.0, 0, 3]])
    Q = np.tile([1.0, 0, 0, 0], (2, 1))
    with pytest.raises(RuntimeError, match="dimer"):
        RigidBody(dimer, X, Q, 1.0, 1.0, 0.1, device="cpu")


def test_validate_config_opt_out():
    """validate_config=False skips the O(N²) overlap sweep."""
    params, cfgb = load_structure("shell_N_12")
    Q = np.tile([1.0, 0, 0, 0], (2, 1))
    rb = RigidBody(cfgb, np.array([[0.0, 0, 3], [0.0, 0, 3]]), Q,
                   params["sep"] / 2, 1.0, 0.1,
                   config=SimulationConfig(validate_config=False),
                   device="cpu")
    assert rb.total_blobs == 24


# ------------------------------------------------- test_periodic.py cases


def test_box_too_small_for_body_raises():
    """A box smaller than twice the body diameter is rejected wherever
    geometry meets the config (API constructor and run_bd)."""
    params, cfgb = load_structure("shell_N_42")
    with pytest.raises(ValueError, match="too small"):
        RigidBody(np.asarray(cfgb).ravel(), np.array([0.0, 0, 3.0]),
                  np.array([1.0, 0, 0, 0]), a=params["sep"] / 2, eta=1.0,
                  dt=0.01, config=SimulationConfig(
                      wall=True, box=(3.0, 3.0), dtype=torch.float32),
                  device="cpu")
    geom = interop.geometry_from_numpy(cfgb, dtype=torch.float64,
                                       device="cpu")
    cfg = SimulationConfig(a=params["sep"] / 2, dt=0.01, kBT=0.5, wall=True,
                           box=(3.0, 3.0), dtype=torch.float64)
    state = interop.state_from_numpy([[0.0, 0, 3.0]], [[1.0, 0, 0, 0]],
                                     dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="too small"):
        run_bd(geom, cfg, state, 2, generator=torch.Generator())


def test_overlap_check_sees_wrapped_distance():
    """Blobs coincident modulo the box are the r=0 failure the API's
    overlap validation exists for — it must measure wrapped distances."""
    params, cfgb = load_structure("shell_N_12")
    cfg = SimulationConfig(box=(8.0, 8.0), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="OVERLAP"):
        RigidBody(np.asarray(cfgb).ravel(),
                  np.array([[0.0, 2.0, 3.0], [8.0, 2.0, 3.0]]),
                  np.tile([1.0, 0, 0, 0], (2, 1)),
                  a=params["sep"] / 2, eta=1.0, dt=0.01, config=cfg,
                  device="cpu")


# ------------------------------------------------ parity with the JAX package


@pytest.mark.parametrize("box", [None, (9.0, 7.5), (9.0, 7.5, 8.0)],
                         ids=["open", "film", "cube"])
def test_diagnose_matches_jax(box):
    """Float64, row tiles of 16 over 77 blobs (a short last tile), with
    and without a box, a pair close only through the seam."""
    rng = np.random.default_rng(1)
    r = rng.uniform([-4, -3, -0.5], [4, 3, 4], (77, 3))
    r[5] = r[40] + [9.0 - 0.3, 0.0, 0.0]
    Q = rng.standard_normal((6, 4)) * 0.3
    Q[0] = [1.0, 0, 0, 0]
    d_j = validation_j.diagnose(jnp.asarray(r), jnp.asarray(Q), a=0.4,
                                row_tile=16, box=box)
    d_t = validation.diagnose(_t(r), _t(Q), a=0.4, row_tile=16, box=box)
    for name in d_t._fields:
        assert _rel(getattr(d_t, name).numpy(),
                    getattr(d_j, name)) < OP_TOL, name
    assert int(d_t.n_below_wall) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seam_pair_separation(dtype):
    """A pair exactly L/2 apart on x has the same distance through either
    image, so the port's float32 wrap rule at the seam (which may take the
    other image than the JAX package's, ROADMAP.md queue 3 item 4) gives
    the JAX package's min separation, and both give L/2 / a."""
    box = (6.0, 7.0)
    r = np.array([[-1.5, 0.25, 1.0], [1.5, 0.25, 1.0],
                  [0.25, -1.75, 6.0], [0.25, 1.75, 6.0]])
    Q = np.array([[1.0, 0, 0, 0]])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    d_j = validation_j.diagnose(jnp.asarray(r, jdt), jnp.asarray(Q, jdt),
                                a=0.5, box=box)
    d_t = validation.diagnose(_t(r).to(dtype), _t(Q).to(dtype), a=0.5,
                              box=box)
    assert float(d_t.min_separation) == float(d_j.min_separation) == 6.0


def test_assert_valid_texts_match_jax():
    r = np.array([[0.0, 0, 1], [1e-9, 0, 1], [0, 0, -0.5]])
    cases = [(r, [[1.0, 0, 0, 0]], {}),
             (r[[0, 2]], [[1.0, 0, 0, 0]], {"wall": True}),
             (r[[0, 2]], [[1.1, 0, 0, 0]], {})]
    for pos, Q, kw in cases:
        d_j = validation_j.diagnose(jnp.asarray(pos), jnp.asarray(Q))
        d_t = validation.diagnose(_t(pos), _t(Q))
        with pytest.raises(RuntimeError) as e_j:
            validation_j.assert_valid(d_j, **kw)
        with pytest.raises(RuntimeError) as e_t:
            validation.assert_valid(d_t, **kw)
        assert str(e_t.value) == str(e_j.value)


def _cloud(seed, n=40):
    rng = np.random.default_rng(seed)
    r = rng.uniform([-3, -3, 0.2], [3, 3, 3], (n, 3))
    return r, rng.uniform(0.3, 0.6, n), rng.standard_normal((n, 3))


@pytest.mark.parametrize("kw", [
    dict(wall=False), dict(wall=True), dict(wall=True, box=(5.0, 6.0)),
    dict(wall=True, radii=True), dict(wall=False, box=(5.0, 6.0, 5.5)),
], ids=["free", "wall", "film", "wall-poly", "cube"])
def test_apply_M_dense_matches_jax(kw):
    """B·M·B·F through the dense matrix, against the JAX package and the
    port's own streamed sweep (float64)."""
    r, radii, F = _cloud(2)
    kw = dict(kw)
    use_radii = kw.pop("radii", False)
    rad_j = jnp.asarray(radii) if use_radii else None
    rad_t = _t(radii) if use_radii else None
    U_j = rpy_j.apply_M_dense(jnp.asarray(F), jnp.asarray(r), a=0.4,
                              eta=1.3, radii=rad_j, **kw)
    U_t = rpy.apply_M_dense(_t(F), _t(r), a=0.4, eta=1.3, radii=rad_t, **kw)
    assert U_t.shape == (40, 3)
    assert _rel(U_t.numpy(), U_j) < OP_TOL
    if len(kw.get("box") or ()) != 3:
        U_s = rpy.mobility_apply(_t(F), _t(r), a=0.4, eta=1.3, radii=rad_t,
                                 **kw)
        assert _rel(U_t.numpy(), U_s.numpy()) < OP_TOL


@pytest.fixture(scope="module")
def bodies():
    """4 × shell_N_12 above the wall (one across a 9 × 9 box's x seam from
    another), float64: the JAX geometry, its block_free n_ref and the
    port's geometry at the same state."""
    params, ref = load_structure("shell_N_12")
    X = np.array([[0.0, 0.0, 1.6], [2.6, 0.3, 1.9], [0.2, 2.7, 2.2],
                  [7.8, 0.1, 1.7]])
    Q = np.random.default_rng(3).standard_normal((4, 4))
    cfg_j = ConfigJ(a=params["sep"] / 2, wall=True, dtype=jnp.float64,
                    pc_mode="block_free")
    geom_j = kin_j.make_ref_geometry(ref, dtype=jnp.float64)
    st_j = make_state_j(X, Q, dtype=jnp.float64)
    ops_j = saddle_j.geometry_ops(geom_j, st_j)
    n_ref = jax_fast(lambda o: saddle_j.build_pc(o, cfg_j).n_ref, ops_j)
    geom_t = interop.geometry_from_numpy(ref, dtype=torch.float64,
                                         device="cpu")
    st_t = interop.state_from_numpy(st_j.X, st_j.Q, dtype=torch.float64,
                                    device="cpu")
    return cfg_j, ops_j, n_ref, saddle.geometry_ops(geom_t, st_t)


@pytest.mark.parametrize("include_rot", [False, True])
@pytest.mark.parametrize("box", [None, (9.0, 9.0)], ids=["open", "film"])
def test_grand_body_mobility_matches_jax(bodies, include_rot, box):
    cfg_j, ops_j, n_ref, ops_t = bodies
    cfg_j = cfg_j.replace(box=box)
    # eager: with a box, its image wrap takes the radius as a Python number
    G_j = saddle_j.grand_body_mobility(ops_j, cfg_j, n_ref,
                                       include_rot=include_rot)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    G_t = saddle.grand_body_mobility(ops_t, cfg_t, _t(n_ref),
                                     include_rot=include_rot)
    assert G_t.shape == (24, 24)
    assert _rel(G_t.numpy(), G_j) < OP_TOL


# ------------------------------------------------- the RigidBody contract


def _create(R, X, Q, **kw):
    return R(SHELL, X, Q, 1.0, 1.0, 1.0, wall_PC=True, **kw)


def test_float32_operators_match_jax():
    """The float32 default instance against the JAX package's at the JAX
    tests' float32 bounds (positions 1e-5, the kernels' 5e-6·max|U|)."""
    X, Q = utils.create_random_positions(2, wall_PC=True, seed=40)
    rb_j = _create(RigidBodyJ, X, Q)
    rb_t = _create(RigidBody, X, Q, device="cpu")
    pos = rb_j.get_blob_positions()
    assert np.abs(rb_t.get_blob_positions() - pos).max() < 1e-5
    F = np.random.default_rng(38).standard_normal(pos.size)
    U_t, U_j = rb_t.apply_M(F, pos), rb_j.apply_M(F, pos)
    assert U_t.dtype == U_j.dtype == np.float32
    assert _rel(U_t, U_j) < 5e-6


def _message(fn):
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        return type(e), str(e)
    raise AssertionError("no exception")


def test_error_texts_match_jax():
    """Every RuntimeError / ValueError the class raises, letter for letter
    the JAX package's, on the same inputs."""
    X, Q = utils.create_random_positions(2, wall_PC=True, seed=40)
    rb_j = _create(RigidBodyJ, X, Q)
    rb_t = _create(RigidBody, X, Q, device="cpu")
    n_sys = 3 * rb_t.total_blobs + 6 * rb_t.N_bodies
    pos = rb_t.get_blob_positions()
    below = pos.copy()
    below[0, 2] = -0.5
    twin = np.concatenate([pos[:1], pos[:1]])
    dimer = np.array([[0.0, 0, 0], [0.0, 0, 2.0]])
    Q_id = np.tile([1.0, 0, 0, 0], (2, 1))
    ctors = {
        "rigid config": lambda R, C: R(SHELL.ravel()[:-1], X, Q, 1.0, 1.0,
                                       0.1),
        "config and kwargs": lambda R, C: R(SHELL, X, Q, 1.0, 1.0, 0.1,
                                            wall_PC=True, config=C()),
        "dimer": lambda R, C: R(dimer, X, Q, 1.0, 1.0, 0.1),
        "overlap": lambda R, C: R(SHELL, np.array([[0.0, 0, 3]] * 2), Q_id,
                                  0.4, 1.0, 0.1),
        "box": lambda R, C: R(SHELL, X, Q, 0.4, 1.0, 0.1,
                              config=C(wall=True, box=(3.0, 3.0))),
    }
    port = lambda *a, **kw: RigidBody(*a, device="cpu", **kw)  # noqa: E731
    for what, make in ctors.items():
        assert (_message(lambda: make(port, SimulationConfig))
                == _message(lambda: make(RigidBodyJ, ConfigJ))), what
    calls = {
        "X not 3N": lambda rb: rb.set_config(X.ravel()[:-1], Q),
        "Q not 4N": lambda rb: rb.set_config(X, Q.ravel()[:-1]),
        "body counts": lambda rb: rb.set_config(X, Q[:1]),
        "K_dot": lambda rb: rb.K_dot(np.ones(11)),
        "KT_dot": lambda rb: rb.KT_dot(np.ones(5)),
        "evolve": lambda rb: rb.evolve_rigid_bodies(np.ones(7)),
        "apply_PC size": lambda rb: rb.apply_PC(np.ones(n_sys - 1)),
        "apply_saddle size": lambda rb: rb.apply_saddle(np.ones(n_sys + 1)),
        "apply_M sizes": lambda rb: rb.apply_M(np.ones(6), np.ones(9)),
        "apply_M 3N": lambda rb: rb.apply_M(np.ones(7), np.ones(7)),
        "apply_M below": lambda rb: rb.apply_M(np.ones(below.size), below),
        "apply_M overlap": lambda rb: rb.apply_M(np.ones(6), twin),
    }
    for what, call in calls.items():
        assert _message(lambda: call(rb_t)) == _message(lambda: call(rb_j)), \
            what
    for rb in (rb_j, rb_t):
        rb.set_config(X - [0.0, 0.0, 10.0], Q)
    sinks = {
        "apply_PC": lambda rb: rb.apply_PC(np.ones(n_sys)),
        "apply_saddle": lambda rb: rb.apply_saddle(np.ones(n_sys)),
        "solve_mobility": lambda rb: rb.solve_mobility(np.ones((2, 6))),
        "deterministic_step": lambda rb: rb.deterministic_step(
            np.ones((2, 6))),
    }
    for what, call in sinks.items():
        assert _message(lambda: call(rb_t)) == _message(lambda: call(rb_j)), \
            what
