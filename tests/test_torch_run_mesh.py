"""The port's run driver with a ``"mesh"`` key on 2 gloo ranks of the CPU
(``tests/torch_dist_ranks.py``, one spawn for the file; the run driver joins
the ranks' group as it joins ``torch.distributed.run``'s), float64:

- mode ``"distributed"`` and mode ``"gather"`` at kBT = 0 against the
  one-process run of the same config, frames within 1e-9 of max|X|;
- a stochastic distributed run of 8 steps against 4 steps and a resume
  from their checkpoint: frames equal bitwise (each rank's generator
  state goes through rank 0's checkpoint);
- rank 0 alone writes; the mesh's error texts (the JAX driver's, the
  devices being the processes).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_ranks  # noqa: E402
from rigid_body_light_tpu_torch import run as run_t  # noqa: E402
from rigid_body_light_tpu_torch.runtime import read_trajectory  # noqa: E402
from rigid_body_light_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint)

WORLD = 2
PARITY_TOL = 1e-9


def _config(tmp_path, name, **overrides):
    conf = {
        "structure": "shell_N_12", "n_bodies": 4,
        "placement": {"type": "grid", "spacing": 4.0, "z0": 2.0},
        "a": None, "eta": 1.0, "dt": 0.02, "kBT": 0.0, "wall": True,
        "dtype": "float64", "n_steps": 8, "save_every": 2,
        "checkpoint_every": 4,
        "forces": [
            {"type": "gravity", "value": [0, 0, -0.5, 0, 0, 0]},
            {"type": "wall_repulsion", "strength": 2.0, "debye_length": 0.5},
        ],
        "seed": 3, "output_dir": str(tmp_path / name),
        "solver": {"gmres_tol": 1e-9, "gmres_restart": 30,
                   "gmres_maxiter": 90, "lanczos_iters": 8,
                   "pc_mode": "block_free"},
    }
    conf.update(overrides)
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path, conf


def _traj(conf):
    return read_trajectory(os.path.join(conf["output_dir"],
                                        "trajectory.rblt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run_mesh")
    dist_mesh = {"shape": [WORLD], "mode": "distributed"}
    confs = {
        "distributed": _config(tmp, "distributed", mesh=dist_mesh),
        "gather": _config(tmp, "gather", mesh={"shape": [WORLD]}),
        "stoch_full": _config(tmp, "stoch_full", kBT=0.5, mesh=dist_mesh),
        "stoch_half": _config(tmp, "stoch_half", kBT=0.5, n_steps=4,
                              mesh=dist_mesh),
    }
    cpu = ["--device", "cpu"]
    half = confs["stoch_half"][1]["output_dir"]
    runs_ = [[confs[k][0]] + cpu
             for k in ("distributed", "gather", "stoch_full", "stoch_half")]
    runs_.append([confs["stoch_half"][0], "--resume",
                  os.path.join(half, "checkpoint.npz")] + cpu)
    bad = {
        "too_big": _config(tmp, "too_big", mesh={"shape": [4]})[0],
        "not_1d": _config(tmp, "not_1d", mesh={"shape": [1, 2],
                                               "mode": "distributed"})[0],
        "odd_bodies": _config(tmp, "odd_bodies", n_bodies=3,
                              mesh=dist_mesh)[0],
        "bad_mode": _config(tmp, "bad_mode",
                            mesh={"shape": [2], "mode": "ring"})[0],
        "smaller": _config(tmp, "smaller", mesh={"shape": [1]})[0],
    }
    handle = torch_dist_ranks.launch("run_mesh_task", WORLD, tmp,
                                     {"runs": runs_, "bad": bad})
    ref_path, ref_conf = _config(tmp, "one_process")
    run_t.main([ref_path] + cpu)
    errors = torch_dist_ranks.collect(handle)
    return confs, ref_conf, errors


@pytest.mark.parametrize("mode", ["distributed", "gather"])
def test_mesh_run_matches_the_one_process_run(runs, mode):
    confs, ref_conf, _ = runs
    steps, _, X, Q = _traj(confs[mode][1])
    steps_r, _, X_r, Q_r = _traj(ref_conf)
    assert steps.tolist() == steps_r.tolist() == [2, 4, 6, 8]
    assert np.abs(X - X_r).max() < PARITY_TOL * np.abs(X_r).max()
    assert np.abs(Q - Q_r).max() < PARITY_TOL
    assert np.abs(X_r[-1] - X_r[0]).max() > 1e-3   # the bodies moved


def test_distributed_resume_continues_without_a_gap(runs):
    confs, _, _ = runs
    steps, _, X, Q = _traj(confs["stoch_full"][1])
    steps_h, _, X_h, Q_h = _traj(confs["stoch_half"][1])
    assert steps.tolist() == steps_h.tolist() == [2, 4, 6, 8]
    assert np.isfinite(X).all()
    np.testing.assert_array_equal(X_h, X)
    np.testing.assert_array_equal(Q_h, Q)
    _, rng, step, meta = load_checkpoint(
        os.path.join(confs["stoch_full"][1]["output_dir"], "checkpoint.npz"),
        dtype=torch.float64, device="cpu")
    assert step == 8 and len(meta["rank_generator_states"]) == WORLD


def test_mesh_errors_use_the_jax_texts(runs):
    _, _, errors = runs
    for e in errors:
        assert "mesh shape [4] needs 4 devices but only 2 are visible" in \
            e["too_big"]
        assert e["not_1d"] == ("mesh mode 'distributed' needs a 1-D shape, "
                               "got [1, 2]")
        assert e["odd_bodies"] == ("mesh mode 'distributed' needs n_bodies "
                                   "divisible by the mesh size: B=3, D=2")
        assert e["bad_mode"] == ("mesh mode must be 'gather' or "
                                 "'distributed', got 'ring'")
        assert "a mesh of 1 devices over a process group of 2" in \
            e["smaller"]
