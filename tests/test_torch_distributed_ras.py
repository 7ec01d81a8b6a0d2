"""Port parity of distributed RAS (``saddle.build_pc_ras`` /
``apply_pc`` with a process group: the gathered halo clusters, the
replicated coupled Ñ) against the JAX package, on 4 gloo ranks of the CPU
(``tests/torch_dist_ranks.py``, one spawn for the file) beside the JAX
package in the pytest process, at ``tests/test_distributed.py``'s settled
layer (8 × shell_N_12 packed at the wall, halo 4a, 16 halo blobs, two
bodies a rank, so every cluster crosses ranks):

- the build: each rank's halo ids equal the JAX single-device build's rows
  of its bodies, and every rank's Ñ is the JAX one to 1e-12 of its max;
- a RAS solve with a random slip and force: float64 (gmres_tol 1e-12, so
  that both solves carry the operator's rounding, not a Krylov path's) U
  and λ to 1e-12 of their max against the JAX single-device RAS solve,
  the same GMRES iterations, fewer than ``block_free``'s; float32 (gmres_tol 1e-5) to
  2e-3 of max|U| (``tests/test_torch_settled.py``'s float32 bound: two
  float32 solves stopped at gmres_tol), fewer iterations than
  ``block_free``'s;
- the deterministic and the stochastic distributed RAS steps against the
  JAX package's on 4 of conftest's 8 virtual devices (each rank fed the
  draws of its device): X and Q to 1e-12, equal iterations.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks  # noqa: E402
from rigid_body_light_tpu import (SimulationConfig, load_structure,  # noqa: E402
                                  parallel)
from rigid_body_light_tpu.ops import kinematics as kin  # noqa: E402
from rigid_body_light_tpu.ops import saddle, solvers  # noqa: E402
from rigid_body_light_tpu.state import make_state  # noqa: E402

D = 4
B = 8
N_BLOB = 12
AX = "bodies"
TOL = 1e-12
F32_TOL = 2e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _device_draws(key, n):
    """The (W1, W2, W_rfd) the JAX stochastic step draws on each device."""
    b = B // D
    out = []
    for d in range(D):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, d), 3)
        out.append((np.array(jax.random.normal(k1, (b * 3 * n,), jnp.float64)),
                    np.array(jax.random.normal(k2, (b * 3 * n,), jnp.float64)),
                    np.array(jax.random.normal(k3, (b, n, 3), jnp.float64))))
    return out


def _settled_layer_8(seed=11):
    """``tests/test_distributed.py::_settled_layer_8``."""
    params, ref = load_structure("shell_N_12")
    rng = np.random.default_rng(seed)
    xs = np.array([[2.3 * (i % 4), 2.3 * (i // 4), 1.35]
                   for i in range(B)], float)
    xs[:, :2] += 0.1 * rng.standard_normal((B, 2))
    xs[:, 2] += 0.05 * rng.standard_normal(B)
    qs = rng.standard_normal((B, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    cfg = SimulationConfig(a=params["sep"] / 2, wall=True, dtype=jnp.float64,
                           gmres_tol=1e-8, gmres_maxiter=200,
                           use_pallas=False, pc_mode="ras", pc_halo=4.0,
                           pc_halo_max=16, dt=0.01, lanczos_iters=8)
    return ref, xs, qs, cfg


def _cfg_dict(cfg):
    return dict(dataclasses.asdict(cfg), dtype="float64")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ref, xs, qs, cfg = _settled_layer_8()
    rng = np.random.default_rng(3)
    slip = rng.standard_normal((B * N_BLOB, 3))
    solve_force = rng.standard_normal((B, 6))
    F = np.zeros((B, 6))
    F[:, 2] = -1.0
    cfg_st = cfg.replace(kBT=1.0)
    key = jax.random.key(5)
    cfg64 = cfg.replace(gmres_tol=1e-12)
    cfg32 = cfg.replace(gmres_tol=1e-5)
    payload = dict(ref=np.asarray(ref), X=xs, Q=qs, slip=slip,
                   solve_force=solve_force, force=F, cfg=_cfg_dict(cfg),
                   cfg64=_cfg_dict(cfg64), cfg32=_cfg_dict(cfg32),
                   cfg_st=_cfg_dict(cfg_st),
                   draws=_device_draws(key, N_BLOB))
    handle = torch_dist_ranks.launch("ras_task", D,
                                     tmp_path_factory.mktemp("ras"), payload)

    out = {}
    for dt, c in (("float64", cfg64), ("float32", cfg32)):
        jdt = jnp.float64 if dt == "float64" else jnp.float32
        c = c.replace(dtype=jdt)
        geom = kin.make_ref_geometry(ref, dtype=jdt)
        state = make_state(xs, qs, dtype=jdt)
        ops = saddle.geometry_ops(geom, state)
        s_, f_ = jnp.asarray(slip, jdt), jnp.asarray(solve_force, jdt)
        res = jax_fast(lambda o, s, f: solvers.solve_saddle(o, c, s, f),
                       ops, s_, f_)
        bf = jax_fast(lambda o, s, f: solvers.solve_saddle(
            o, c.replace(pc_mode="block_free"), s, f), ops, s_, f_)
        out[dt] = dict(U=np.asarray(res.U), lam=np.asarray(res.lam),
                       iters=int(res.iters), iters_block_free=int(bf.iters))
        if dt == "float64":
            pc = jax_fast(lambda o: saddle.build_pc_ras(o, c), ops)
            out["halo_idx"] = np.asarray(pc.halo_idx)
            out["n_full"] = np.asarray(pc.n_full)
    geom = kin.make_ref_geometry(ref, dtype=jnp.float64)
    state = make_state(xs, qs, dtype=jnp.float64)
    mesh = parallel.make_mesh(D, axis_name=AX)
    step = parallel.make_distributed_step(geom, cfg, mesh, deterministic=True)
    s, aux = jax_fast(step, state, jax.random.key(0), jnp.asarray(F))
    out["det"] = dict(X=np.asarray(s.X), Q=np.asarray(s.Q),
                      iters=int(aux.iters))
    step = parallel.make_distributed_step(geom, cfg_st, mesh)
    s, aux = jax_fast(step, state, key, jnp.asarray(F))
    out["stoch"] = dict(X=np.asarray(s.X), Q=np.asarray(s.Q),
                        iters=int(aux.iters))
    return torch_dist_ranks.collect(handle), out, xs


def _own(x, rank):
    n = x.shape[0] // D
    return x[rank * n:(rank + 1) * n]


def test_distributed_ras_build_matches_jax(results):
    res, ref, _ = results
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r["halo_idx"],
                                      _own(ref["halo_idx"], rank))
        scale = np.abs(ref["n_full"]).max()
        assert np.abs(r["n_full"] - ref["n_full"]).max() < TOL * scale


def test_distributed_ras_solve_matches_jax_float64(results):
    res, ref, _ = results
    want = ref["float64"]
    for rank, r in enumerate(res):
        got = r["float64"]
        for key in ("U", "lam"):
            scale = np.abs(want[key]).max()
            assert np.abs(got[key] - _own(want[key], rank)).max() \
                < TOL * scale, key
        assert got["iters"] == want["iters"]
        assert got["iters_block_free"] == want["iters_block_free"]
        assert got["iters"] < got["iters_block_free"]


def test_distributed_ras_solve_matches_jax_float32(results):
    res, ref, _ = results
    want = ref["float32"]
    for rank, r in enumerate(res):
        got = r["float32"]
        assert got["U"].dtype == np.float32
        scale = np.abs(want["U"]).max()
        assert np.abs(got["U"] - _own(want["U"], rank)).max() \
            < F32_TOL * scale
        assert got["iters"] < got["iters_block_free"]


@pytest.mark.parametrize("name", ["det", "stoch"])
def test_distributed_ras_step_matches_jax(results, name):
    res, ref, X0 = results
    for r in res:
        got = r[name]
        assert np.abs(got["X"] - ref[name]["X"]).max() < TOL
        assert np.abs(got["Q"] - ref[name]["Q"]).max() < TOL
        assert got["iters"] == ref[name]["iters"]
    assert np.abs(ref[name]["X"] - X0).max() > 1e-4
