"""Port parity of the film's far field over a process group (a 2-D box
with ``farfield_grid``: the z bounds by MIN / MAX over the group, the
image-summed lattices built alike on every rank, the cyclic neighbor
lists of the gathered tiles, K3's box slice) against the JAX package, on
4 gloo ranks of the CPU (``tests/torch_dist_ranks.py``, one spawn for the
file) beside the JAX package in the pytest process:

- the operator at ``tests/test_distributed.py``'s film case (640 blobs in
  a (14, 14) box above the wall, grid (4, 4, 2), p = 3, image_shells 3),
  monodisperse and with per-blob radii from {0.8, 1.2} (the polydisperse
  film, POLY × BOX), against the JAX package's single-device film
  operator: float64 to 1e-12 of max|U|, with a prepared ctx and with a
  pinned geometry tier too; float32 through K3's box slice (its CPU
  version, the plain slice) to 1e-5 of max|U| (the float32 bound of
  ``tests/test_torch_farfield_poly.py``);
- the deterministic and the stochastic film far-field steps of
  ``tests/test_distributed.py``'s setup (8 × shell_N_12, box (11, 11),
  image_shells 2, grid (4, 4, 2), p = 3) against the JAX package's
  distributed steps on 4 of conftest's 8 virtual devices, each rank fed
  the draws of its device: X and Q to 1e-12, equal GMRES iterations.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks  # noqa: E402
from rigid_body_light_tpu import (SimulationConfig, load_structure,  # noqa: E402
                                  parallel)
from rigid_body_light_tpu.ops import farfield as ff_j  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin  # noqa: E402
from rigid_body_light_tpu.state import make_state  # noqa: E402

D = 4
B = 8
AX = "bodies"
TOL = 1e-12
F32_TOL = 1e-5
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


def _ops_cases():
    rng = np.random.default_rng(7)
    n = 640
    r = np.stack([rng.uniform(0, 14.0, n), rng.uniform(0, 14.0, n),
                  rng.uniform(1.0, 3.5, n)], axis=1)
    F = rng.standard_normal((n, 3))
    return {"mono": dict(r=r, F=F),
            "poly": dict(r=r, F=F, radii=rng.choice([0.8, 1.2], n))}


def _film_setup():
    """``tests/test_distributed.py::_setup`` with the film far field."""
    params, ref = load_structure("shell_N_12")
    xs = np.array([[2.5 * (i % 4), 2.5 * (i // 4), 2.0 + 0.2 * (i % 3)]
                   for i in range(B)])
    qs = np.random.default_rng(0).standard_normal((B, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cfg = SimulationConfig(a=params["sep"] / 2, dt=0.01, kBT=0.0,
                               wall=True, dtype=jnp.float64, lanczos_iters=8,
                               use_pallas=False, gmres_tol=1e-6,
                               pc_mode="block_free", box=(11.0, 11.0),
                               image_shells=2, farfield_grid=(4, 4, 2),
                               farfield_p=3)
    return ref, xs, qs, cfg


def _cfg_dict(cfg):
    return dict(dataclasses.asdict(cfg), dtype="float64")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ops = _ops_cases()
    kw = dict(a=1.0, eta=1.3, grid=(4, 4, 2), p=3, wall=True,
              box=(14.0, 14.0), image_shells=3)
    ref, xs, qs, cfg = _film_setup()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cfg_st = cfg.replace(kBT=1.0)
    key = jax.random.key(3)
    F = np.zeros((B, 6))
    F[:, 2] = -1.0
    payload = dict(ops=ops, kw=kw, ref=np.asarray(ref), X=xs, Q=qs, force=F,
                   cfg=_cfg_dict(cfg), cfg_st=_cfg_dict(cfg_st),
                   draws=_device_draws(key, ref.shape[0]))
    handle = torch_dist_ranks.launch("film_task", D,
                                     tmp_path_factory.mktemp("film"),
                                     payload)

    out = {}
    for name, c in ops.items():
        radii = c.get("radii")
        for dt in (jnp.float64, jnp.float32):
            rad = None if radii is None else jnp.asarray(radii, dt)
            U = jax_fast(lambda f, x: ff_j.mobility_apply(
                f, x, radii=rad, use_pallas=False, **kw),
                jnp.asarray(c["F"], dt), jnp.asarray(c["r"], dt))
            out[name + ("" if dt == jnp.float64 else "_f32")] = np.asarray(U)
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


def _rows(U, rank):
    n = U.shape[0] // D
    return U[rank * n:(rank + 1) * n]


@pytest.mark.parametrize("name", ["mono", "poly"])
@pytest.mark.parametrize("form", ["", "_ctx", "_pinned"])
def test_distributed_film_operator_float64(results, name, form):
    res, ref, _ = results
    scale = np.abs(ref[name]).max()
    for rank, r in enumerate(res):
        assert np.abs(r[name + form] - _rows(ref[name], rank)).max() \
            < TOL * scale


@pytest.mark.parametrize("name", ["mono", "poly"])
def test_distributed_film_operator_float32(results, name):
    res, ref, _ = results
    want = ref[name + "_f32"]
    scale = np.abs(want).max()
    for rank, r in enumerate(res):
        assert r[name + "_f32"].dtype == np.float32
        assert np.abs(r[name + "_f32"] - _rows(want, rank)).max() \
            < F32_TOL * scale


@pytest.mark.parametrize("name", ["det", "stoch"])
def test_distributed_film_step_matches_jax(results, name):
    res, ref, X0 = results
    for r in res:
        got = r[name]
        assert np.abs(got["X"] - ref[name]["X"]).max() < TOL
        assert np.abs(got["Q"] - ref[name]["Q"]).max() < TOL
        assert got["iters"] == ref[name]["iters"]
    assert np.abs(ref[name]["X"] - X0).max() > 1e-4
