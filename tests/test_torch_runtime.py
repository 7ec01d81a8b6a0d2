"""The port's run-time files on the CPU: the trajectory writer and reader
(``runtime/``: the native writer thread and the Python writer, byte for
byte the JAX package's files) and the checkpoint writer
(``utils/checkpoint.save_checkpoint``: formats 1 and 2, read back by the
JAX package's reader, and the JAX package's files read by the port's;
the generator's state saved and restored)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu import runtime as runtime_j  # noqa: E402
from rigid_body_light_tpu.state import make_state as make_state_j  # noqa: E402
from rigid_body_light_tpu.utils import checkpoint as ckpt_j  # noqa: E402
from rigid_body_light_tpu_torch.runtime import (  # noqa: E402
    TrajectoryWriter, native_available, read_trajectory)
from rigid_body_light_tpu_torch.runtime import trajectory  # noqa: E402
from rigid_body_light_tpu_torch.state import make_state  # noqa: E402
from rigid_body_light_tpu_torch.utils import checkpoint as ckpt_t  # noqa: E402


def _frames(T, B, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, B, 3)).astype(dtype),
            rng.standard_normal((T, B, 4)).astype(dtype))


def test_native_writer_builds():
    assert native_available()
    assert trajectory.library_path().startswith(trajectory._BUILD_DIR)


@pytest.mark.parametrize("force_python", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_trajectory_roundtrip(tmp_path, force_python, dtype):
    path = str(tmp_path / "traj.rblt")
    B, T = 7, 25
    Xs, Qs = _frames(T, B, dtype, 0)
    with TrajectoryWriter(path, B, dtype=dtype,
                          force_python=force_python) as w:
        for t in range(T):
            w.append(t, 0.01 * t, Xs[t], Qs[t])
        w.flush()
        assert w.frames == T
    steps, times, X, Q = read_trajectory(path)
    assert steps.tolist() == list(range(T))
    assert np.allclose(times, 0.01 * np.arange(T))
    assert np.array_equal(X, Xs) and np.array_equal(Q, Qs)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_writers_match_the_jax_writer_byte_for_byte(tmp_path, dtype):
    """The port's native and Python writers and the JAX package's writer on
    the same frames: identical files, and an append (a resume) of each
    identical too; each package reads the other's file."""
    B, T = 3, 9
    Xs, Qs = _frames(T, B, dtype, 1)
    paths = {}
    for name, make in (
            ("native", lambda p, **kw: TrajectoryWriter(p, B, dtype=dtype,
                                                        **kw)),
            ("python", lambda p, **kw: TrajectoryWriter(
                p, B, dtype=dtype, force_python=True, **kw)),
            ("jax", lambda p, **kw: runtime_j.TrajectoryWriter(
                p, B, dtype=dtype, **kw))):
        p = str(tmp_path / f"{name}.rblt")
        with make(p) as w:
            for t in range(5):
                w.append(t, float(t), Xs[t], Qs[t])
        with make(p, append=True) as w:
            assert w.frames == 5
            for t in range(5, T):
                w.append(t, float(t), Xs[t], Qs[t])
        paths[name] = p
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["native"] == data["python"] == data["jax"]
    for read in (read_trajectory, runtime_j.read_trajectory):
        _, _, X, Q = read(paths["native"] if read is not read_trajectory
                          else paths["jax"])
        assert np.array_equal(X, Xs) and np.array_equal(Q, Qs)


def test_append_refuses_a_mismatched_header(tmp_path):
    p = str(tmp_path / "t.rblt")
    with TrajectoryWriter(p, 3) as w:
        w.append(0, 0.0, np.zeros((3, 3)), np.zeros((3, 4)))
    with pytest.raises(RuntimeError, match="header mismatch"):
        TrajectoryWriter(p, 4, append=True)
    with pytest.raises(RuntimeError, match="header mismatch"):
        TrajectoryWriter(p, 3, dtype=np.float64, append=True)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent fallback: a writer whose build fails raises unless the
    caller asked for the Python writer."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(trajectory, "_SRC", str(bad))
    monkeypatch.setattr(trajectory, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(trajectory, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TrajectoryWriter(str(tmp_path / "t.rblt"), 2)
    assert not native_available()
    with TrajectoryWriter(str(tmp_path / "p.rblt"), 2,
                          force_python=True) as w:
        w.append(0, 0.0, np.zeros((2, 3)), np.zeros((2, 4)))
    assert read_trajectory(str(tmp_path / "p.rblt"))[0].tolist() == [0]


def test_checkpoint_roundtrip_restores_the_generator(tmp_path):
    """X, Q, step and metadata back exactly; the restored generator draws
    the saved one's stream."""
    path = str(tmp_path / "ckpt.npz")
    rng = np.random.default_rng(2)
    state = make_state(rng.standard_normal((4, 3)),
                       rng.standard_normal((4, 4)), dtype=torch.float64,
                       device="cpu")
    gen = torch.Generator().manual_seed(123)
    torch.randn(7, generator=gen)
    ckpt_t.save_checkpoint(path, state, gen, step=77,
                           metadata={"note": "hello"})
    s2, rng_state, step, meta = ckpt_t.load_checkpoint(
        path, dtype=torch.float64, device="cpu")
    assert torch.equal(s2.X, state.X) and torch.equal(s2.Q, state.Q)
    assert step == 77 and meta == {"note": "hello"}
    assert rng_state.dtype == np.uint8
    g2 = ckpt_t.restore_generator(rng_state, "cpu")
    assert torch.equal(torch.randn(5, generator=g2),
                       torch.randn(5, generator=gen))
    bare = str(tmp_path / "bare.npz")
    ckpt_t.save_checkpoint(bare, state)
    _, r, step, meta = ckpt_t.load_checkpoint(bare, device="cpu")
    assert r is None and step == 0 and meta == {}
    assert ckpt_t.restore_generator(None, "cpu") is None


@pytest.mark.parametrize("mixture", [False, True], ids=["v1", "v2"])
def test_port_checkpoints_load_in_jax(tmp_path, mixture):
    """Formats 1 and 2 as the JAX writer lays them out: the JAX reader
    takes the port's file (the generator field ignored) with equal arrays,
    step and metadata."""
    rng = np.random.default_rng(3)
    states = [make_state(rng.standard_normal((b, 3)),
                         rng.standard_normal((b, 4)), dtype=torch.float64,
                         device="cpu") for b in (3, 2)]
    state = tuple(states) if mixture else states[0]
    path = str(tmp_path / "port.npz")
    ckpt_t.save_checkpoint(path, state, torch.Generator().manual_seed(1),
                           step=12, metadata={"config": {"dt": 0.01}})
    with np.load(path) as z:
        assert int(z["format_version"]) == (2 if mixture else 1)
    st_j, key_j, step_j, meta_j = ckpt_j.load_checkpoint(path,
                                                         dtype=jnp.float64)
    assert key_j is None and step_j == 12
    assert meta_j == {"config": {"dt": 0.01}}
    for s_j, s_t in zip(st_j if mixture else (st_j,),
                        state if mixture else (state,)):
        np.testing.assert_array_equal(np.asarray(s_j.X), s_t.X.numpy())
        np.testing.assert_array_equal(np.asarray(s_j.Q), s_t.Q.numpy())


@pytest.mark.parametrize("mixture", [False, True], ids=["v1", "v2"])
def test_jax_checkpoints_load_in_the_port(tmp_path, mixture):
    """The JAX writer's files, with a key: equal arrays, step and metadata;
    the key data returned, and a generator seeded from it the same way
    every time."""
    rng = np.random.default_rng(4)
    states = [make_state_j(rng.standard_normal((b, 3)),
                           rng.standard_normal((b, 4)), dtype=jnp.float64)
              for b in (2, 3)]
    state = tuple(states) if mixture else states[0]
    key = jax.random.key(9)
    path = str(tmp_path / "jax.npz")
    ckpt_j.save_checkpoint(path, state, key, step=40,
                           metadata={"note": "jax"})
    st_t, key_t, step_t, meta_t = ckpt_t.load_checkpoint(
        path, dtype=torch.float64, device="cpu")
    assert step_t == 40 and meta_t == {"note": "jax"}
    np.testing.assert_array_equal(key_t,
                                  np.asarray(jax.random.key_data(key)))
    for s_t, s_j in zip(st_t if mixture else (st_t,),
                        state if mixture else (state,)):
        np.testing.assert_array_equal(s_t.X.numpy(), np.asarray(s_j.X))
    g1 = ckpt_t.restore_generator(key_t, "cpu")
    g2 = ckpt_t.restore_generator(key_t, "cpu")
    assert torch.equal(torch.randn(4, generator=g1),
                       torch.randn(4, generator=g2))


def test_checkpoint_format_versions(tmp_path):
    """A newer format is refused with its version in the message."""
    future = str(tmp_path / "future.npz")
    np.savez(future, format_version=np.asarray(99), step=np.asarray(0),
             metadata=json.dumps({}))
    with pytest.raises(RuntimeError, match="format v99"):
        ckpt_t.load_checkpoint(future, device="cpu")
