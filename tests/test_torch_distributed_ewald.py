"""Port parity of the distributed triply periodic operator
(``ewald.mobility_apply_local`` over a process group,
``parallel.ewald_mobility_apply_local_fn``, and the distributed step in a
3-D box) against the JAX package on 4 gloo ranks of the CPU
(``tests/torch_dist_ranks.py``, one spawn for the file), the JAX
references computed meanwhile in the pytest process:

- the classic split's ring of slabs, 256 blobs in a (9, 11, 8) box at
  ``ewald_tol`` 1e-4 (as every case here, to keep the fits cheap): to
  1e-12 of max|U| in float64 against the JAX operator; in float32 through
  K4's wrappers (their CPU versions, the plain blocks) to 5e-6 of max|U|,
  the float32 tolerance of ``tests/test_torch_ewald.py``;
- the balanced split's tile slices, 512 blobs in L = 12 at rc = 4, 2 RHS,
  monodisperse and with radii from {0.4, 0.65} in a species pattern
  that differs from rank to rank: float64 to 1e-12; float32 with the
  species-pair tables built from the gathered global radii, through the
  config's operator, to 5e-6 of the JAX package's single-device float32
  operator (its distributed form tiles one rank's radii, which is wrong
  for this pattern: ROADMAP.md queue 3, fault 3);
- the deterministic distributed steps of ``tests/test_distributed.py``'s
  periodic setup (8 × shell_N_12 in a (12, 12, 10) box), classic and
  balanced (rc = 4), against the JAX package's distributed steps on 4 of
  conftest's 8 virtual devices: X and Q to 1e-12, equal GMRES iterations;
- the refusals: radii on the classic ring (the JAX text) and
  ``ewald_grid_p`` with a group.

In the pytest process: the tile sweep's slices for 1, 2 and 4 ranks,
whose union is bitwise the whole sweep.
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
from rigid_body_light_tpu.ops import ewald as ewald_j  # noqa: E402
from rigid_body_light_tpu.ops import kinematics as kin  # noqa: E402
from rigid_body_light_tpu.state import make_state  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald, ewald_cells  # noqa: E402

D = 4
AX = "bodies"
TOL = 1e-12
F32_TOL = 5e-6
EWALD_TOL = 1e-4
RC = 4.0
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _cfg_dict(cfg, dtype="float64"):
    return dict(dataclasses.asdict(cfg), dtype=dtype)


def _rank_radii(n, rng):
    """Radii whose species pattern differs from rank to rank: rank 0 one
    species, rank 1 both, rank 2 the other one, rank 3 both in another
    proportion."""
    q = n // D
    return np.concatenate([np.full(q, 0.4), rng.choice([0.4, 0.65], q),
                           np.full(q, 0.65),
                           rng.choice([0.4, 0.65], q, p=[0.8, 0.2])])


def _ops_cases():
    rng = np.random.default_rng(5)
    box_r = (9.0, 11.0, 8.0)
    box_c = (12.0, 12.0, 12.0)
    n_r, n_c = 256, 512
    r_c = rng.uniform(0, 1, (n_c, 3)) * np.array(box_c)
    F_c = rng.standard_normal((2, n_c, 3))
    return {
        "ring": dict(box=box_r, a=0.5, eta=1.3, tol=EWALD_TOL, f32=True,
                     r=rng.uniform(0, 1, (n_r, 3)) * np.array(box_r),
                     F=rng.standard_normal((n_r, 3))),
        "cells": dict(box=box_c, a=0.5, eta=1.3, tol=EWALD_TOL, rc=RC, r=r_c,
                      F=F_c),
        "cells_poly": dict(box=box_c, a=0.5, eta=1.3, tol=EWALD_TOL, rc=RC,
                           r=r_c, F=F_c,
                           radii=_rank_radii(n_c, rng), f32=True),
    }


def _periodic():
    """``tests/test_distributed.py::_setup_periodic``."""
    params, ref = load_structure("shell_N_12")
    B = 8
    xs = np.array([[3.0 + 5.0 * (i % 2), 3.0 + 5.0 * ((i // 2) % 2),
                    2.0 + 2.5 * (i // 4)] for i in range(B)])
    qs = np.tile([1.0, 0, 0, 0], (B, 1))
    cfg = SimulationConfig(a=params["sep"] / 2, dt=0.01, kBT=0.0, wall=False,
                           box=(12.0, 12.0, 10.0), dtype=jnp.float64,
                           use_pallas=False, gmres_tol=1e-9,
                           pc_mode="block_free", ewald_tol=EWALD_TOL)
    return ref, xs, qs, cfg


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ops = _ops_cases()
    ref, xs, qs, cfg = _periodic()
    cfg_rc = cfg.replace(ewald_rc=RC)
    cfg_poly = SimulationConfig(a=0.5, eta=1.3, box=(12.0, 12.0, 12.0),
                                wall=False, ewald_rc=RC, ewald_tol=EWALD_TOL)
    F = np.zeros((8, 6))
    F[:, 2] = -1.0
    payload = dict(ops=ops, ref=np.asarray(ref), X=xs, Q=qs, force=F,
                   step_classic=_cfg_dict(cfg), step_rc=_cfg_dict(cfg_rc),
                   cfg_poly=_cfg_dict(cfg_poly, "float32"),
                   cfg_grid=_cfg_dict(cfg_poly.replace(ewald_grid_p=4)))
    handle = torch_dist_ranks.launch("ewald_task", D,
                                     tmp_path_factory.mktemp("ewald"),
                                     payload)

    out = {}
    for name, c in ops.items():
        params = ewald_j.make_params(c["box"], c["a"], c["eta"],
                                     tol=c["tol"], rc=c.get("rc"))
        radii = c.get("radii")
        F_ = jnp.asarray(c["F"])
        r_ = jnp.asarray(c["r"])
        fn = ewald_j.mobility_apply_multi if F_.ndim == 3 else \
            ewald_j.mobility_apply
        out[name] = np.asarray(jax_fast(
            lambda f, x: fn(f, x, params, radii=None if radii is None
                            else jnp.asarray(radii)), F_, r_))
        if c.get("f32"):
            pt = (None if radii is None
                  else ewald_j.make_poly_tables(params, radii))
            f32 = F_[0] if F_.ndim == 3 else F_
            out[name + "_f32"] = np.asarray(jax_fast(
                lambda f, x: ewald_j.mobility_apply(
                    f, x, params, poly_tables=pt,
                    radii=None if radii is None
                    else jnp.asarray(radii, jnp.float32)),
                f32.astype(jnp.float32), r_.astype(jnp.float32)))
    geom = kin.make_ref_geometry(ref, dtype=jnp.float64)
    state = make_state(xs, qs, dtype=jnp.float64)
    mesh = parallel.make_mesh(D, axis_name=AX)
    for name, c in (("step_classic", cfg), ("step_rc", cfg_rc)):
        step = parallel.make_distributed_step(geom, c, mesh,
                                              deterministic=True)
        s, aux = jax_fast(step, state, jax.random.key(0), jnp.asarray(F))
        out[name] = dict(X=np.asarray(s.X), Q=np.asarray(s.Q),
                         U=np.asarray(aux.U), iters=int(aux.iters))
    return torch_dist_ranks.collect(handle), out, xs


def _rows(ref):
    """Each rank's rows of a global (N, 3) or (k, N, 3) result."""
    n = ref.shape[-2] // D
    return [ref[..., d * n:(d + 1) * n, :] for d in range(D)]


@pytest.mark.parametrize("name", ["ring", "cells", "cells_poly"])
def test_distributed_ewald_operator_float64(results, name):
    res, ref, _ = results
    scale = np.abs(ref[name]).max()
    for r, want in zip(res, _rows(ref[name])):
        assert np.abs(r[name] - want).max() < TOL * scale


def test_distributed_ewald_operator_float32(results):
    """The ring through K4's wrappers (the diagonal block K4's sweep, the
    others its slab form; on the CPU their plain versions)."""
    res, ref, _ = results
    scale = np.abs(ref["ring_f32"]).max()
    for r, want in zip(res, _rows(ref["ring_f32"])):
        assert r["ring_f32"].dtype == np.float32
        assert np.abs(r["ring_f32"] - want).max() < F32_TOL * scale


def test_distributed_ewald_poly_tables_from_gathered_radii(results):
    """``ewald_mobility_apply_local_fn`` with this rank's float32 radii
    (the balanced split's tile slice with species-pair tables built from
    the gathered radii): right for a species pattern that differs from
    rank to rank."""
    res, ref, _ = results
    scale = np.abs(ref["cells_poly_f32"]).max()
    for r, want in zip(res, _rows(ref["cells_poly_f32"])):
        assert r["fn_poly_f32"].dtype == np.float32
        assert np.abs(r["fn_poly_f32"] - want).max() < F32_TOL * scale


@pytest.mark.parametrize("name", ["step_classic", "step_rc"])
def test_distributed_periodic_step_matches_jax(results, name):
    res, ref, X0 = results
    for r in res:
        got = r[name]
        assert np.abs(got["X"] - ref[name]["X"]).max() < TOL
        assert np.abs(got["Q"] - ref[name]["Q"]).max() < TOL
        assert got["iters"] == ref[name]["iters"]
    assert np.abs(ref[name]["X"] - X0).max() > 1e-4


def test_distributed_ewald_refusals(results):
    res, _, _ = results
    for r in res:
        assert r["ring_radii"] == (
            "distributed polydisperse Ewald needs balanced splitting "
            "(ewald_rc > 0) — the classic-split ring sweep is monodisperse")
        assert r["grid_p"] is not None and r["grid_p"].startswith(
            "ewald_grid_p=4 with a process group")


@pytest.mark.parametrize("poly", [False, True])
def test_tile_slices_union_is_the_whole_sweep(poly):
    """The balanced split's sorted tiles padded for 1, 2 and 4 ranks: each
    rank's slice of ``_cell_sweep`` keeps the sum of each of its rows, so
    the slices' union is the one-device sweep bit for bit, float32."""
    rng = np.random.default_rng(9)
    n = 900
    box = (10.0, 10.0, 10.0)
    params = ewald.make_params(box, 0.4, rc=2.5)
    r = torch.tensor(rng.uniform(0, 10, (n, 3)), dtype=torch.float32)
    F = torch.tensor(rng.standard_normal((2, n, 3)), dtype=torch.float32)
    radii = pt = None
    if poly:
        radii = torch.tensor(rng.choice([0.3, 0.45], n), dtype=torch.float32)
        pt = ewald.make_poly_tables(params, radii)
    rf = ewald_cells._fold(r, params)
    whole = None
    for d in (1, 2, 4):
        order, r_pad, ids_pad, F_pad, pp, nbr, overflow = \
            ewald_cells.sorted_tiles(rf, F, params, 64, d, radii=radii,
                                     poly_tables=pt)
        nt = nbr.shape[0] // d
        U = torch.cat([ewald_cells._cell_sweep(
            r_pad, ids_pad, F_pad, nbr, params, poly=pp, t0=i * nt, nt=nt)
            for i in range(d)], dim=1)[:, :n]
        assert not bool(overflow)
        if whole is None:
            whole = U
        assert torch.equal(U, whole)
