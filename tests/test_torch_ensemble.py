"""Port parity of the ensemble runner (``parallel.make_hybrid_mesh``,
``parallel.make_ensemble_run_bd``: walkers over the mesh's ``"dcn"``
dimension, each walker's bodies over ``"chips"``) against the JAX
package's on a (2, 2) mesh of 4 of conftest's 8 virtual devices, on 4
gloo ranks of the CPU as a (2, 2) hybrid mesh (``tests/torch_dist_ranks.py``,
one spawn for the file), float64, ``tests/test_ensemble.py``'s setup cut
to 2 walkers of 4 × shell_N_12 and 2 steps with gravity and wall
repulsion:

- the mesh's dimensions and the refusal of a size that does not split;
- the kBT = 0 ensemble and the stochastic one, each rank fed the draws
  the JAX ensemble makes for its walker on its device: the walkers'
  final X and Q and trajectories to 1e-12, equal GMRES iterations;
- the walker and body counts that must divide (the JAX texts).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_dist_ranks  # noqa: E402
from rigid_body_light_tpu import (SimulationConfig, forces,  # noqa: E402
                                  load_structure, parallel)
from rigid_body_light_tpu.ops import kinematics as kin  # noqa: E402
from rigid_body_light_tpu.state import BodyState  # noqa: E402

W, B, CHIPS = 2, 4, 2
N_STEPS = 2
TOL = 1e-12
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _walker_draws(key, n):
    """Per step and chip, the draws the JAX ensemble's walker with ``key``
    makes: the key split once a step, the step's key folded with the chip
    index, then split in three (the distributed step's draws)."""
    b = B // CHIPS
    out = []
    for _ in range(N_STEPS):
        key, sub = jax.random.split(key)
        step = []
        for c in range(CHIPS):
            k1, k2, k3 = jax.random.split(jax.random.fold_in(sub, c), 3)
            step.append(tuple(
                np.array(jax.random.normal(k, s, jnp.float64))
                for k, s in ((k1, (b * 3 * n,)), (k2, (b * 3 * n,)),
                             (k3, (b, n, 3)))))
        out.append(step)
    return out


def _cfg_dict(cfg):
    return dict(dataclasses.asdict(cfg), dtype="float64")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    params, ref = load_structure("shell_N_12")
    rng = np.random.default_rng(0)
    X = rng.uniform([-4, -4, 2.0], [4, 4, 6.0], (W, B, 3))
    Q = rng.standard_normal((W, B, 4))
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    cfg = SimulationConfig(a=params["sep"] / 2, dt=0.01, kBT=0.0, wall=True,
                           dtype=jnp.float64, lanczos_iters=8,
                           use_pallas=False, gmres_tol=1e-8,
                           pc_mode="block_free")
    cfg_st = cfg.replace(kBT=0.5, gmres_tol=1e-6)
    keys = jax.vmap(jax.random.key)(jnp.arange(10, 10 + W))
    payload = dict(ref=np.asarray(ref), X=X, Q=Q, n_steps=N_STEPS,
                   det=_cfg_dict(cfg), stoch=_cfg_dict(cfg_st),
                   draws=[_walker_draws(keys[w], ref.shape[0])
                          for w in range(W)])
    handle = torch_dist_ranks.launch("ensemble_task", 4,
                                     tmp_path_factory.mktemp("ensemble"),
                                     payload)

    geom = kin.make_ref_geometry(ref, dtype=jnp.float64)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(W, CHIPS),
                ("dcn", "chips"))
    force_fn = forces.sum_forces(
        forces.gravity(np.array([0, 0, -1.0, 0, 0, 0])),
        forces.wall_repulsion(strength=2.0, debye_length=0.5, radius=1.0))
    states = BodyState(X=jnp.asarray(X), Q=jnp.asarray(Q))
    out = {}
    for name, c in (("det", cfg), ("stoch", cfg_st)):
        run = parallel.make_ensemble_run_bd(geom, c, mesh, N_STEPS,
                                            force_fn=force_fn)
        fin, traj = jax_fast(run, states, keys)
        out[name] = dict(X=np.asarray(fin.X), Q=np.asarray(fin.Q),
                         tX=np.asarray(traj["X"]),
                         iters=np.asarray(traj["iters"]))
    return torch_dist_ranks.collect(handle), out, X


def test_hybrid_mesh_dimensions(results):
    res, _, _ = results
    for r in res:
        assert r["dims"] == (("dcn", "chips"), (W, CHIPS))
        assert r["dcn3"] == "4 devices do not split over dcn=3"


@pytest.mark.parametrize("name", ["det", "stoch"])
def test_ensemble_matches_jax(results, name):
    res, ref, X0 = results
    want = ref[name]
    for r in res:
        got = r[name]
        assert got["tX"].shape == (W, N_STEPS, B, 3)
        for key in ("X", "Q", "tX"):
            assert np.abs(got[key] - want[key]).max() < TOL, key
        np.testing.assert_array_equal(got["iters"], want["iters"])
    assert np.abs(want["X"] - X0).max() > 1e-4
    if name == "stoch":   # the walkers' noise differs
        assert not np.allclose(want["X"][0] - X0[0], want["X"][1] - X0[1])


def test_ensemble_counts_must_divide(results):
    res, _, _ = results
    for r in res:
        assert r["walkers"] == ("ensemble run needs n_walkers divisible by "
                                "the DCN mesh extent: W=1, dcn=2")
        assert r["bodies"] == ("ensemble run needs n_bodies divisible by "
                               "the ICI mesh extent: B=3, chips=2")
