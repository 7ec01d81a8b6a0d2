"""Port parity of quaternions, rigid kinematics, structures, config and
geometry_ops against the JAX package, float64, same numpy inputs."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import SimulationConfig, load_structure  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin_j  # noqa: E402
from rigid_body_light_tpu.ops import quaternion as quat_j  # noqa: E402
from rigid_body_light_tpu.ops import saddle as saddle_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu_torch import interop  # noqa: E402
from rigid_body_light_tpu_torch import structures as structures_t  # noqa: E402
from rigid_body_light_tpu_torch.config import SimulationConfig as CfgT  # noqa: E402
from rigid_body_light_tpu_torch.ops import kinematics as kin_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import quaternion as quat_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle as saddle_t  # noqa: E402
from rigid_body_light_tpu_torch.state import make_state as make_state_t  # noqa: E402

TOL = 1e-13


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


@pytest.fixture
def bodies():
    rng = np.random.default_rng(3)
    B = 5
    X = rng.uniform(-3, 3, (B, 3)) + np.array([0, 0, 4.0])
    Q = rng.standard_normal((B, 4))
    # one rotation vector under the small-angle cutoff |ω|² < 1e-12
    om = rng.standard_normal((B, 3)) * 0.3
    om[0] = 1e-7
    return X, Q, om


def test_quaternion_ops_match(bodies):
    X, Q, om = bodies
    q = Q / np.linalg.norm(Q, axis=-1, keepdims=True)
    t = torch.from_numpy
    _close(quat_t.normalize(t(Q)), quat_j.normalize(jnp.asarray(Q)))
    _close(quat_t.multiply(t(q), t(q[::-1].copy())),
           quat_j.multiply(jnp.asarray(q), jnp.asarray(q[::-1])))
    _close(quat_t.to_rotation_matrix(t(q)),
           quat_j.to_rotation_matrix(jnp.asarray(q)))
    _close(quat_t.from_rotation_vector(t(om)),
           quat_j.from_rotation_vector(jnp.asarray(om)))


def test_kinematic_operators_match(bodies):
    X, Q, om = bodies
    _, ref = load_structure("shell_N_12")
    geom_j = kin_j.make_ref_geometry(ref, dtype=jnp.float64)
    geom_t = kin_t.make_ref_geometry(ref, dtype=torch.float64, device="cpu")
    _close(geom_t.ref_cfg, geom_j.ref_cfg)
    _close(geom_t.moi, geom_j.moi)
    q = Q / np.linalg.norm(Q, axis=-1, keepdims=True)
    Qj, Qt = jnp.asarray(q), torch.from_numpy(q)
    off_j = kin_j.blob_offsets(geom_j, Qj)
    off_t = kin_t.blob_offsets(geom_t, Qt)
    _close(off_t, off_j)
    _close(kin_t.blob_positions(geom_t, torch.from_numpy(X), Qt),
           kin_j.blob_positions(geom_j, jnp.asarray(X), Qj))
    rng = np.random.default_rng(5)
    U = rng.standard_normal((5, 6))
    lam = rng.standard_normal((5, 12, 3))
    _close(kin_t.K_dot(torch.from_numpy(U), off_t),
           kin_j.K_dot(jnp.asarray(U), off_j))
    _close(kin_t.KT_dot(torch.from_numpy(lam), off_t),
           kin_j.KT_dot(jnp.asarray(lam), off_j))
    kk_t, kk_j = kin_t.ktk_inv(geom_t, Qt), kin_j.ktk_inv(geom_j, Qj)
    _close(kk_t, kk_j, 1e-11)
    _close(kin_t.Kinv_dot(torch.from_numpy(lam), off_t, kk_t),
           kin_j.Kinv_dot(jnp.asarray(lam), off_j, kk_j), 1e-11)
    _close(kin_t.KinvT_dot(torch.from_numpy(U), off_t, kk_t),
           kin_j.KinvT_dot(jnp.asarray(U), off_j, kk_j), 1e-11)
    dU = np.concatenate([U[:, :3], om], axis=1)
    for a, b in zip(kin_t.update_X_Q(torch.from_numpy(X), Qt,
                                     torch.from_numpy(dU)),
                    kin_j.update_X_Q(jnp.asarray(X), Qj, jnp.asarray(dU))):
        _close(a, b)


def test_geometry_ops_match(bodies):
    X, Q, _ = bodies
    _, ref = load_structure("shell_N_42")
    st_j = make_state_j(X, Q, dtype=jnp.float64)
    st_t = make_state_t(X, Q, dtype=torch.float64, device="cpu")
    _close(st_t.Q, st_j.Q)
    ops_j = saddle_j.geometry_ops(kin_j.make_ref_geometry(ref, jnp.float64),
                                  st_j)
    ops_t = saddle_t.geometry_ops(kin_t.make_ref_geometry(ref, torch.float64,
                                                          device="cpu"),
                                  st_t)
    for name in ("offsets", "positions", "rot"):
        _close(getattr(ops_t, name), getattr(ops_j, name))
    _close(ops_t.ktkinv, ops_j.ktkinv, 1e-11)
    _close(saddle_t.body_K_blocks(ops_t.offsets),
           saddle_j.body_K_blocks(ops_j.offsets))


def test_structures_read_the_shared_files():
    for name in ("shell_N_12", "shell_N_642"):
        p_t, c_t = structures_t.load_structure(name)
        p_j, c_j = load_structure(name)
        assert p_t == p_j
        np.testing.assert_array_equal(c_t, c_j)


def test_config_carries_across():
    cfg_j = SimulationConfig(a=0.3, dt=0.01, kBT=1.0, wall=True,
                             dtype=jnp.float64, pc_mode="block_free",
                             lanczos_iters=6, gmres_tol=1e-5)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    assert cfg_t.dtype == torch.float64
    assert ({f.name for f in dataclasses.fields(CfgT)}
            == {f.name for f in dataclasses.fields(SimulationConfig)})
    for f in dataclasses.fields(CfgT):
        if f.name != "dtype":
            assert getattr(cfg_t, f.name) == getattr(cfg_j, f.name), f.name
    assert cfg_t.replace(dt=0.5).dt == 0.5


@pytest.mark.parametrize("kw", [
    dict(farfield_grid=(4, 4, 2), farfield_band_p=3, gmres_tol=5e-3),
    dict(farfield_grid="auto", farfield_band_p=4),
])
def test_config_takes_the_band_tier(kw):
    """The far field's band tier, once refused: the port's config carries
    it as the JAX package's does, field by field, and both warn alike (each
    gmres_tol lies below the two-tier operator-error estimate)."""
    with pytest.warns(UserWarning, match="operator error") as w_j:
        cfg_j = SimulationConfig(dtype=jnp.float64, **kw)
    with pytest.warns(UserWarning, match="operator error") as w_t:
        cfg_t = CfgT(dtype=torch.float64, **kw)
    assert ([str(w.message) for w in w_t]
            == [str(w.message) for w in w_j])
    for f in dataclasses.fields(CfgT):
        if f.name != "dtype":
            assert getattr(cfg_t, f.name) == getattr(cfg_j, f.name), f.name


@pytest.mark.parametrize("kw", [
    dict(box=(12.0, 12.0, 12.0), ewald_rc=4.0),
    dict(box=(12.0, 12.0, 12.0), ewald_rc=4.0, ewald_grid_p=16),
])
def test_config_takes_the_balanced_split(kw):
    """The balanced split and its gridded wave part, once refused: the
    port's config carries them as the JAX package's does, field by
    field."""
    cfg_j = SimulationConfig(dtype=jnp.float64, **kw)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    for f in dataclasses.fields(CfgT):
        if f.name != "dtype":
            assert getattr(cfg_t, f.name) == getattr(cfg_j, f.name), f.name
    assert cfg_t == CfgT(dtype=torch.float64, **kw)


@pytest.mark.parametrize("kw", [
    dict(drift_mode="em_exact"), dict(kBT=1.0, lanczos_precond=False),
])
def test_config_takes_the_exact_drift_and_plain_noise(kw):
    """The exact drift and the unpreconditioned noise, once refused: the
    port's config carries them as the JAX package's does, field by
    field."""
    cfg_j = SimulationConfig(dtype=jnp.float64, **kw)
    cfg_t = interop.config_from_dict(dataclasses.asdict(cfg_j))
    for f in dataclasses.fields(CfgT):
        if f.name != "dtype":
            assert getattr(cfg_t, f.name) == getattr(cfg_j, f.name), f.name
    assert cfg_t == CfgT(dtype=torch.float64, **kw)


@pytest.mark.parametrize("kw", [
    dict(drift_mode="midpont"), dict(gmres_tol=0.1),
    dict(lanczos_iters=10, lanczos_max_iters=5),
])
def test_config_validates_like_jax(kw):
    with pytest.raises(ValueError):
        SimulationConfig(**kw)
    with pytest.raises(ValueError):
        CfgT(**kw)


def test_entry_points_default_to_the_card():
    """make_state, make_ref_geometry and the interop helpers build on the
    card unless the caller names a device; without a CUDA device that
    default raises instead of quietly running on the CPU."""
    _, ref = load_structure("shell_N_12")
    X, Q = np.zeros((1, 3)), np.array([[1.0, 0.0, 0.0, 0.0]])
    calls = [lambda **kw: make_state_t(X, Q, **kw),
             lambda **kw: kin_t.make_ref_geometry(ref, **kw),
             lambda **kw: interop.geometry_from_numpy(ref, **kw),
             lambda **kw: interop.state_from_numpy(X, Q, **kw),
             lambda **kw: interop.noise_pc_from_numpy(np.eye(3), np.eye(3),
                                                      **kw),
             lambda **kw: interop.pc_from_numpy(np.eye(3), np.eye(6), **kw)]
    for call in calls:
        assert _first_tensor(call(device="cpu")).device.type == "cpu"
        if torch.cuda.is_available():
            assert _first_tensor(call()).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


def _first_tensor(out):
    return next(v for v in out if isinstance(v, torch.Tensor))
