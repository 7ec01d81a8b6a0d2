"""Port parity of the fully distributed stepper
(``rigid_body_light_tpu_torch.parallel.make_distributed_step`` and
``make_distributed_run_bd``) against the JAX package's, on 4 gloo ranks
of the CPU (``tests/torch_dist_ranks.py``, one spawn for the file) beside
the JAX package on 4 of conftest's 8 virtual CPU devices, float64, at
``tests/test_distributed.py::_setup``'s 8 × shell_N_12 above the wall:

- the deterministic step through the ring and on the far-field backend:
  X and Q to 1e-9, equal GMRES iterations on every rank;
- the stochastic step, each rank fed the draws the JAX step makes on its
  device (the key folded with the device index): X and Q to 1e-9, equal
  GMRES iterations on every rank;
- a 3-step ``make_distributed_run_bd`` with gravity and wall repulsion,
  from the JAX run's per-step, per-device draws;
- the stochastic step on the far field, from the same per-device draws:
  X and Q to 1e-9, equal GMRES iterations on every rank;
- the body count that must divide and a group without its operator (the
  JAX texts), and the four paths that refused naming ROADMAP.md item 16
  until it was done (distributed RAS, a 3-D box, the film's far field,
  the mixture), each now taking a finite deterministic step; their
  parity is in ``tests/test_torch_distributed_{ras,ewald,film,multi}.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks  # noqa: E402
from rigid_body_light_tpu import (SimulationConfig, forces,  # noqa: E402
                                  load_structure, parallel)
from rigid_body_light_tpu.ops import kinematics as kin  # noqa: E402
from rigid_body_light_tpu.state import make_state  # noqa: E402

D = 4
B = 8
AX = "bodies"
STATE_TOL = 1e-9
N_RUN = 3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _cfg_dict(cfg):
    return dict(dataclasses.asdict(cfg), dtype="float64")


def _device_draws(key, n):
    """The (W1, W2, W_rfd) that the JAX stochastic step draws on each
    device from ``key``: the key folded with the device index, then split
    in three, at the device's B/D bodies."""
    b = B // D
    out = []
    for d in range(D):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, d), 3)
        out.append((np.array(jax.random.normal(k1, (b * 3 * n,), jnp.float64)),
                    np.array(jax.random.normal(k2, (b * 3 * n,), jnp.float64)),
                    np.array(jax.random.normal(k3, (b, n, 3), jnp.float64))))
    return out


def _run_draws(key, n):
    """Per device, per step, the draws of the JAX run_bd: the key split
    once a step, the step's key folded with the device index."""
    per_step = []
    k = key
    for _ in range(N_RUN):
        k, sub = jax.random.split(k)
        per_step.append(_device_draws(sub, n))
    return [[per_step[i][d] for i in range(N_RUN)] for d in range(D)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    params, ref = load_structure("shell_N_12")
    n = ref.shape[0]
    xs = np.array([[2.5 * (i % 4), 2.5 * (i // 4), 2.0 + 0.2 * (i % 3)]
                   for i in range(B)])
    qs = np.random.default_rng(0).standard_normal((B, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    geom = kin.make_ref_geometry(ref, dtype=jnp.float64)
    state = make_state(xs, qs, dtype=jnp.float64)
    cfg = SimulationConfig(a=params["sep"] / 2, dt=0.01, kBT=0.0, wall=True,
                           dtype=jnp.float64, lanczos_iters=8,
                           use_pallas=False, gmres_tol=1e-8,
                           pc_mode="block_free")
    with pytest.warns(UserWarning, match="operator error"):
        cfg_far = cfg.replace(farfield_grid=(2, 2, 2), farfield_p=3)
    cfg_st = cfg.replace(kBT=1.0)
    F = np.zeros((B, 6))
    F[:, 2] = -1.0
    key_st, key_run = jax.random.key(3), jax.random.key(1)
    payload = dict(
        ref=np.asarray(ref), X=np.asarray(state.X), Q=np.asarray(state.Q),
        force=F, n_run=N_RUN,
        det=_cfg_dict(cfg), det_far=_cfg_dict(cfg_far),
        stoch=_cfg_dict(cfg_st),
        stoch_far=_cfg_dict(cfg_far.replace(kBT=1.0)),
        draws=_device_draws(key_st, n), run_draws=_run_draws(key_run, n),
        ras=_cfg_dict(cfg.replace(pc_mode="ras")),
        box3=_cfg_dict(cfg.replace(box=(14.0, 14.0, 14.0), wall=False,
                                   ewald_tol=1e-4)),
        film_far=_cfg_dict(cfg.replace(box=(11.0, 11.0), image_shells=2,
                                       farfield_grid=(4, 4, 2))))
    handle = torch_dist_ranks.launch("distributed_task", D,
                                     tmp_path_factory.mktemp("dist"), payload)

    mesh = parallel.make_mesh(D, axis_name=AX)
    Fj = jnp.asarray(F)
    ref_out = {}
    for name, c in (("det", cfg), ("det_far", cfg_far)):
        step = parallel.make_distributed_step(geom, c, mesh,
                                              deterministic=True)
        s, aux = jax_fast(step, state, jax.random.key(0), Fj)
        ref_out[name] = dict(X=np.asarray(s.X), Q=np.asarray(s.Q),
                             U=np.asarray(aux.U), iters=int(aux.iters))
    step = parallel.make_distributed_step(geom, cfg_st, mesh)
    s, aux = jax_fast(step, state, key_st, Fj)
    ref_out["stoch"] = dict(X=np.asarray(s.X), Q=np.asarray(s.Q),
                            iters=int(aux.iters))
    force_fn = forces.sum_forces(
        forces.gravity(np.array([0, 0, -1.0, 0, 0, 0])),
        forces.wall_repulsion(strength=2.0, debye_length=0.5, radius=1.0))
    run = parallel.make_distributed_run_bd(geom, cfg_st, mesh, n_steps=N_RUN,
                                           force_fn=force_fn)
    final, traj = jax_fast(run, state, key_run)
    ref_out["run"] = dict(X=np.asarray(final.X), Q=np.asarray(final.Q),
                          tX=np.asarray(traj["X"]),
                          iters=np.asarray(traj["iters"]))
    step = parallel.make_distributed_step(geom, cfg_far.replace(kBT=1.0),
                                          mesh)
    s, aux = jax_fast(step, state, key_st, Fj)
    ref_out["stoch_far"] = dict(X=np.asarray(s.X), Q=np.asarray(s.Q),
                                iters=int(aux.iters))
    return torch_dist_ranks.collect(handle), ref_out, np.asarray(state.X)


@pytest.mark.parametrize("name", ["det", "det_far", "stoch", "stoch_far"])
def test_distributed_step_matches_jax(results, name):
    res, ref, X0 = results
    for r in res:   # every rank returns the global state
        got = r[name]
        assert np.abs(got["X"] - ref[name]["X"]).max() < STATE_TOL
        assert np.abs(got["Q"] - ref[name]["Q"]).max() < STATE_TOL
        assert got["iters"] == ref[name]["iters"]
    assert np.abs(ref[name]["X"] - X0).max() > 1e-4   # the bodies moved
    if "U" in ref[name]:
        assert np.abs(res[0][name]["U"] - ref[name]["U"]).max() < 1e-8


def test_distributed_noise_is_the_same_on_every_rank(results):
    res, _, _ = results
    errs = {r["stoch"]["noise_err"] for r in res}
    assert len(errs) == 1 and errs.pop() > 0


def test_distributed_run_bd_matches_jax(results):
    res, ref, _ = results
    for r in res:
        got = r["run"]
        assert got["tX"].shape == (N_RUN, B, 3)
        assert np.abs(got["tX"] - ref["run"]["tX"]).max() < STATE_TOL
        assert np.abs(got["X"] - ref["run"]["X"]).max() < STATE_TOL
        assert np.abs(got["Q"] - ref["run"]["Q"]).max() < STATE_TOL
        assert got["iters"].tolist() == ref["run"]["iters"].tolist()


def test_distributed_body_count_must_divide(results):
    res, _, _ = results
    for r in res:
        assert r["divide"] == ("distributed step needs n_bodies divisible "
                               "by the mesh size: B=6, D=4")


def test_distributed_stochastic_step_needs_its_operator(results):
    """``stochastic_step`` with a group and no ``mob_apply``: the JAX
    package's ValueError."""
    res, _, _ = results
    for r in res:
        assert r["no_mob"] == ("distributed stochastic_step needs an "
                               "explicit ring mob_apply "
                               "(parallel.ring_mobility_apply_fn)")


@pytest.mark.parametrize("name", ["ras", "box3", "film_far", "mixture"])
def test_item_16_refusals(results, name):
    """Item 16 is done: no path raises NotImplementedError any more, and
    each takes a finite step on the group."""
    res, _, _ = results
    for r in res:
        raised, finite = r[name]
        assert raised is None and finite, r[name]
