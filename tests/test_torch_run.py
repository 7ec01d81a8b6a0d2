"""The port's run driver (``python -m rigid_body_light_tpu_torch.run``) on
the CPU (``--device cpu``): the single-device cases of
``tests/test_run_driver.py`` (run and resume, bad chunking, random and
file placement, a mixture run and resume, a ``"mesh"`` key larger than
the run's processes, or on a mixture, refused before anything is
written); a resume that reproduces the uninterrupted run
bitwise; and parity with the JAX package's driver on the same float64
configs at kBT = 0 — a monodisperse film and a small polydisperse film
(per-species ``"blob_radius"``, image_shells 1), frames within 1e-9 of
max|X| and equal GMRES iterations a chunk.  The films' boxes keep every
blob pair off the seams: the two packages scale positions by 1/a in
different orders, so a pair exactly at ±L/2 may take the other image in
one of them (ROADMAP.md queue 3, item 4).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rigid_body_light_tpu import run as run_j  # noqa: E402
from rigid_body_light_tpu_torch import run as run_t  # noqa: E402
from rigid_body_light_tpu_torch.runtime import read_trajectory  # noqa: E402
from rigid_body_light_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint)

# the port's frames against the JAX driver's, relative to max|X|
PARITY_TOL = 1e-9


def _write(tmp_path, conf, name="config.json"):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        json.dump(conf, f)
    return p


def _config(tmp_path, name="config.json", **overrides):
    conf = {
        "structure": "shell_N_12", "n_bodies": 2,
        "placement": {"type": "grid", "spacing": 4.0, "z0": 2.0},
        "a": None, "eta": 1.0, "dt": 0.02, "kBT": 0.5, "wall": True,
        "dtype": "float64", "n_steps": 8, "save_every": 2,
        "checkpoint_every": 4,
        "forces": [
            {"type": "gravity", "value": [0, 0, -0.5, 0, 0, 0]},
            {"type": "wall_repulsion", "strength": 2.0, "debye_length": 0.5},
        ],
        "seed": 3, "output_dir": str(tmp_path / "out"),
        "solver": {"gmres_tol": 1e-7, "gmres_restart": 30,
                   "gmres_maxiter": 90, "lanczos_iters": 10},
    }
    conf.update(overrides)
    return _write(tmp_path, conf, name), conf


def _traj(conf):
    return read_trajectory(os.path.join(conf["output_dir"],
                                        "trajectory.rblt"))


def _lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_run_and_resume(tmp_path, capsys):
    cfg_path, conf = _config(tmp_path)
    run_t.main([cfg_path, "--device", "cpu"])
    lines = _lines(capsys.readouterr().out)
    assert [ln["step"] for ln in lines[:-1]] == [4, 8]
    assert set(lines[0]) == {"step", "steps_per_sec", "max_residual",
                             "mean_gmres_iters"}
    assert lines[-1]["done"] and lines[-1]["frames"] == 4
    steps, times, X, Q = _traj(conf)
    assert steps.tolist() == [2, 4, 6, 8] and X.dtype == np.float64
    assert np.isfinite(X).all()
    assert np.allclose(times, np.asarray(steps, float) * conf["dt"])
    ckpt = os.path.join(conf["output_dir"], "checkpoint.npz")
    state, rng, step, meta = load_checkpoint(ckpt, dtype=torch.float64,
                                             device="cpu")
    assert step == 8 and rng is not None and rng.dtype == np.uint8
    assert meta["config"]["n_steps"] == 8
    np.testing.assert_array_equal(state.X.numpy(), X[-1])

    # resume: the trajectory is appended to, not truncated
    run_t.main([cfg_path, "--resume", ckpt, "--device", "cpu"])
    steps2, _, X2, _ = _traj(conf)
    assert steps2.tolist() == [2, 4, 6, 8, 10, 12, 14, 16]
    assert np.array_equal(X2[:4], X)


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    """8 steps in two chunks, against 4 steps then a resume for 4 more
    from the checkpoint (the generator's state restored): the same frames,
    bitwise."""
    cfg_a, conf_a = _config(tmp_path, "a.json",
                            output_dir=str(tmp_path / "a"))
    run_t.main([cfg_a, "--device", "cpu"])
    cfg_b, conf_b = _config(tmp_path, "b.json", n_steps=4,
                            output_dir=str(tmp_path / "b"))
    run_t.main([cfg_b, "--device", "cpu"])
    run_t.main([cfg_b, "--device", "cpu", "--resume",
                os.path.join(conf_b["output_dir"], "checkpoint.npz")])
    sa, ta, Xa, Qa = _traj(conf_a)
    sb, tb, Xb, Qb = _traj(conf_b)
    assert sa.tolist() == sb.tolist() == [2, 4, 6, 8]
    assert np.array_equal(Xa, Xb) and np.array_equal(Qa, Qb)
    with open(os.path.join(conf_a["output_dir"], "trajectory.rblt"),
              "rb") as fa, open(os.path.join(conf_b["output_dir"],
                                             "trajectory.rblt"), "rb") as fb:
        assert fa.read() == fb.read()


def test_invalid_chunking_rejected(tmp_path):
    cfg_path, conf = _config(tmp_path, save_every=3)  # 4 % 3 != 0
    with pytest.raises(ValueError, match="multiple of save_every"):
        run_t.main([cfg_path, "--device", "cpu"])
    cfg_path, _ = _config(tmp_path, n_steps=10)  # 10 % 4 != 0
    with pytest.raises(ValueError, match="multiple of checkpoint_every"):
        run_t.main([cfg_path, "--device", "cpu"])
    assert not os.path.exists(conf["output_dir"])


def test_random_and_file_placement(tmp_path):
    """Random placement is the JAX driver's (the same numpy draws); a file
    placement sediments deterministically from its positions."""
    for wall in (True, False):
        rng_j, rng_t = (np.random.default_rng(4) for _ in range(2))
        Xj, Qj = run_j.place_bodies({"type": "random"}, 5, rng_j, wall)
        Xt, Qt = run_t.place_bodies({"type": "random"}, 5, rng_t, wall)
        np.testing.assert_array_equal(Xt, Xj)
        np.testing.assert_array_equal(Qt, Qj)
    init = str(tmp_path / "init.npz")
    X = np.array([[0.0, 0, 2.0], [5.0, 0, 2.0]])
    np.savez(init, X=X, Q=np.tile([1.0, 0, 0, 0], (2, 1)))
    cfg_path, conf = _config(
        tmp_path, placement={"type": "file", "path": init}, kBT=0.0,
        forces=[{"type": "gravity", "value": [0, 0, -1.0, 0, 0, 0]}])
    run_t.main([cfg_path, "--device", "cpu"])
    Xs = _traj(conf)[2]
    assert Xs[0, 0, 2] < 2.0
    assert np.allclose(Xs[0, :, :2], X[:, :2], atol=1e-2)


def _mixture(tmp_path, name, **overrides):
    conf = {
        "species": [
            {"structure": "shell_N_12", "n_bodies": 2,
             "placement": {"type": "grid", "spacing": 4.0, "z0": 2.0}},
            {"structure": "shell_N_12", "n_bodies": 1, "scale": 0.5,
             "blob_radius": 0.2,
             "placement": {"type": "grid", "spacing": 4.0, "z0": 4.0},
             "forces": [{"type": "gravity", "value": [0, 0, -0.1, 0, 0, 0]}]},
        ],
        "a": 0.4, "eta": 1.0, "dt": 0.02, "kBT": 0.4, "wall": True,
        "dtype": "float64", "n_steps": 8, "save_every": 2,
        "checkpoint_every": 4,
        "forces": [{"type": "gravity", "value": [0, 0, -0.5, 0, 0, 0]},
                   {"type": "wall_repulsion", "strength": 2.0,
                    "debye_length": 0.5}],
        "seed": 5, "output_dir": str(tmp_path / name),
        "solver": {"gmres_tol": 1e-7, "gmres_restart": 30,
                   "gmres_maxiter": 90, "lanczos_iters": 10},
    }
    conf.update(overrides)
    return _write(tmp_path, conf, name + ".json"), conf


def test_mixture_run_and_resume(tmp_path, capsys):
    """A polydisperse "species" config: concatenated frames, a format-2
    checkpoint whose state is the last frame, an appending resume."""
    cfg_path, conf = _mixture(tmp_path, "mix")
    run_t.main([cfg_path, "--device", "cpu"])
    assert _lines(capsys.readouterr().out)[-1]["species_sizes"] == [2, 1]
    steps, _, X, _ = _traj(conf)
    assert steps.tolist() == [2, 4, 6, 8] and X.shape[1] == 3
    assert np.isfinite(X).all()
    ckpt = os.path.join(conf["output_dir"], "checkpoint.npz")
    states, rng, step, meta = load_checkpoint(ckpt, dtype=torch.float64,
                                              device="cpu")
    assert isinstance(states, tuple) and len(states) == 2
    assert meta["species_sizes"] == [2, 1] and step == 8 and rng is not None
    np.testing.assert_array_equal(
        np.concatenate([states[0].X.numpy(), states[1].X.numpy()]), X[-1])
    run_t.main([cfg_path, "--resume", ckpt, "--device", "cpu"])
    steps2, _, X2, _ = _traj(conf)
    assert steps2.tolist() == [2, 4, 6, 8, 10, 12, 14, 16]
    assert np.array_equal(X2[:4], X)


def test_mesh_key_refused_before_anything_is_written(tmp_path):
    # one process: a mesh of 8 devices raises with the JAX driver's text
    for mesh in ({"shape": [8]}, {"shape": [8], "mode": "distributed"}):
        cfg_path, conf = _config(tmp_path, mesh=mesh)
        with pytest.raises(ValueError,
                           match="needs 8 devices but only 1 are visible"):
            run_t.main([cfg_path, "--device", "cpu"])
        assert not os.path.exists(conf["output_dir"])
    # a mixture runs on the gather mesh now, checked the same way
    cfg_path, conf = _mixture(tmp_path, "mixmesh", mesh={"shape": [2]})
    with pytest.raises(ValueError,
                       match="needs 2 devices but only 1 are visible"):
        run_t.main([cfg_path, "--device", "cpu"])
    assert not os.path.exists(conf["output_dir"])


def _parity(tmp_path, capsys, make):
    """The same config through both drivers: frames within PARITY_TOL of
    max|X|, equal GMRES iterations and steps a chunk."""
    cfg_j, conf_j = make(tmp_path, "jax")
    cfg_t, conf_t = make(tmp_path, "port")
    run_j.main([cfg_j])
    lines_j = _lines(capsys.readouterr().out)
    run_t.main([cfg_t, "--device", "cpu"])
    lines_t = _lines(capsys.readouterr().out)
    sj, tj, Xj, Qj = _traj(conf_j)
    st, tt, Xt, Qt = _traj(conf_t)
    assert st.tolist() == sj.tolist() and np.array_equal(tt, tj)
    scale = np.abs(Xj).max()
    assert np.abs(Xt - Xj).max() <= PARITY_TOL * scale
    assert np.abs(Qt - Qj).max() <= PARITY_TOL
    assert np.abs(Xt[-1] - Xt[0]).max() > 1e-3
    for lt, lj in zip(lines_t[:-1], lines_j[:-1]):
        assert lt["step"] == lj["step"]
        assert lt["mean_gmres_iters"] == lj["mean_gmres_iters"]
    assert lines_t[-1]["frames"] == lines_j[-1]["frames"]


def test_film_matches_the_jax_driver(tmp_path, capsys):
    """A monodisperse film: 4 × shell_N_12 in a (7.4, 7.4) box above the
    wall, gravity, wall repulsion and box-wrapped Yukawa pairs,
    image_shells 1, kBT = 0."""
    def make(tp, name):
        return _config(
            tp, name + ".json", n_bodies=4, kBT=0.0, box=[7.4, 7.4],
            placement={"type": "grid", "spacing": 3.5, "z0": 1.6},
            forces=[{"type": "gravity", "value": [0, 0, -1.0, 0, 0, 0]},
                    {"type": "wall_repulsion", "strength": 4.0,
                     "debye_length": 0.3},
                    {"type": "pair_yukawa", "strength": 1.0,
                     "debye_length": 0.5, "diameter": 2.0}],
            output_dir=str(tp / name),
            solver={"gmres_tol": 1e-10, "gmres_restart": 30,
                    "gmres_maxiter": 90, "lanczos_iters": 10,
                    "image_shells": 1, "pc_mode": "block_free"})
    _parity(tmp_path, capsys, make)


def test_polydisperse_film_matches_the_jax_driver(tmp_path, capsys):
    """A small polydisperse film: 2 × shell_N_12 at a = 0.4 and 2 ×
    shell_N_12 scaled 0.5 with blob_radius 0.2 in a (7.4, 7.4) box,
    image_shells 1, kBT = 0."""
    def make(tp, name):
        return _mixture(
            tp, name, kBT=0.0, box=[7.4, 7.4],
            species=[
                {"structure": "shell_N_12", "n_bodies": 2,
                 "placement": {"type": "grid", "spacing": 3.5, "z0": 2.0}},
                {"structure": "shell_N_12", "n_bodies": 2, "scale": 0.5,
                 "blob_radius": 0.2,
                 "placement": {"type": "grid", "spacing": 3.5, "z0": 3.4},
                 "forces": [{"type": "gravity",
                             "value": [0, 0, -0.125, 0, 0, 0]}]}],
            solver={"gmres_tol": 1e-10, "gmres_restart": 30,
                    "gmres_maxiter": 90, "lanczos_iters": 10,
                    "image_shells": 1, "pc_mode": "block_free"})
    _parity(tmp_path, capsys, make)
