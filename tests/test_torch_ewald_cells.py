"""Port parity of the balanced split's tile sweep (``ops/ewald_cells.py``)
and its tile helpers (``ops/tiles.py``) against the JAX package on the same
numpy inputs.

The cloud of ``tests/test_ewald_cells.py`` at 600 blobs: a (10, 12, 9) box,
positions deliberately outside [0, L) (the sweep folds them), a = 0.3,
tol 1e-5, rc = 2.5; radii from {0.2, 0.45} for the polydisperse sweep
(two species: three species-pair fits, whose float32 Clenshaw chains
dominate the JAX compile).

Tolerances: integer outputs (orders, adjacency, neighbor lists, widths)
exactly equal; float64 operators within 1e-10 of max|U|; float32 within
5e-6 of max|U|, the bound ``tests/test_ewald_cells.py`` holds the JAX tile
sweep to against its all-pairs sweep.  The JAX sweeps are compiled at
XLA's cheapest CPU optimization (:func:`jax_fast`), as
``tests/test_torch_poly.py`` compiles its references.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu.ops import ewald as ewald_j  # noqa: E402
from rigid_body_light_tpu.ops import ewald_cells as cells_j  # noqa: E402
from rigid_body_light_tpu.ops import tiles as tiles_j  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald as ewald_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald_cells as cells_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import tiles as tiles_t  # noqa: E402

N = 600
BOX = (10.0, 12.0, 9.0)
A, TOL, RC = 0.3, 1e-5, 2.5
F64_TOL = 1e-10
F32_TOL = 5e-6
DTYPES = {"float64": (jnp.float64, torch.float64, F64_TOL),
          "float32": (jnp.float32, torch.float32, F32_TOL)}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args):
    """``jax.jit(fn)(*args)`` compiled with :data:`FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(5)
    r = rng.uniform(-5, 15, (N, 3))
    F = rng.standard_normal((2, N, 3))
    radii = rng.choice([0.2, 0.45], size=N)
    return (ewald_j.make_params(BOX, A, tol=TOL, rc=RC),
            ewald_t.make_params(BOX, A, tol=TOL, rc=RC), r, F, radii)


def _rel(U, ref):
    U, ref = np.asarray(U, np.float64), np.asarray(ref, np.float64)
    return np.abs(U - ref).max() / np.abs(ref).max()


def test_make_params_rc_matches_jax(cloud):
    """The balanced split's params field by field: ξ = s/rc, the k-lattice
    grown to match, and the short-range fit (initial degree 12, fitted up
    to rc) — its arrays exactly equal."""
    pj, pt = cloud[:2]
    assert pt.rc == pj.rc == RC
    classic = ewald_t.make_params(BOX, A, tol=TOL)
    assert pt.xi > classic.xi and len(pt.kvecs) > len(classic.kvecs)
    for name in pj._fields:
        vj, vt = getattr(pj, name), getattr(pt, name)
        if isinstance(vj, np.ndarray):
            np.testing.assert_array_equal(vt, vj, err_msg=name)
        else:
            assert vt == vj, name
    assert pt.cheb_bounds[-1] == pytest.approx(RC * 1.001)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tile_helpers_match_jax(cloud, dtype):
    """column_width, serpentine_order (two stable sorts), bbox_adjacency
    (minimum image), pack_neighbor_lists (with its overflow flag) and
    default_max_nbr: every integer output exactly the JAX package's."""
    pj, pt, r = cloud[0], cloud[1], cloud[2]
    dj, dt, _ = DTYPES[dtype]
    V = float(np.prod(BOX))
    rf = np.asarray(cells_j._fold(jnp.asarray(r, dj), pj))
    rf_t = cells_t._fold(torch.from_numpy(r).to(dt), pt)
    np.testing.assert_array_equal(rf_t.numpy(), rf)
    assert tiles_t.column_width(N, V) == pytest.approx(
        float(tiles_j.column_width(N, V)), rel=1e-15)
    o_j = np.asarray(tiles_j.serpentine_order(
        jnp.asarray(rf), tiles_j.column_width(N, V)))
    o_t = tiles_t.serpentine_order(rf_t, tiles_t.column_width(N, V))
    np.testing.assert_array_equal(o_t.numpy(), o_j)
    t = -(-N // tiles_t.TILE)
    pad = t * tiles_t.TILE - N
    r_pad = np.concatenate([rf[o_j], np.broadcast_to(rf[o_j][:1], (pad, 3))])
    adj_j = np.asarray(tiles_j.bbox_adjacency(jnp.asarray(r_pad), t, RC,
                                              box=BOX))
    adj_t = tiles_t.bbox_adjacency(torch.from_numpy(r_pad), t, RC, box=BOX)
    np.testing.assert_array_equal(adj_t.numpy(), adj_j)
    width = tiles_t.default_max_nbr(N, V, RC)
    assert width == tiles_j.default_max_nbr(N, V, RC)
    assert width == cells_t.default_max_nbr(N, pt) == cells_j.default_max_nbr(
        N, pj)
    for m in (width, 3):
        nb_j, of_j = tiles_j.pack_neighbor_lists(jnp.asarray(adj_j), m)
        nb_t, of_t = tiles_t.pack_neighbor_lists(adj_t, m)
        np.testing.assert_array_equal(nb_t.numpy(), np.asarray(nb_j))
        assert bool(of_t) == bool(of_j)
    assert bool(of_t)   # 3 slots overflow at this density


@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cells_match_jax(cloud, dtype, poly):
    """The tile sweep at 1 and 2 RHS against the JAX package's, and against
    the port's all-pairs sweep with the same rc cut (the same pair set)."""
    pj, pt, r, F, radii = cloud
    dj, dt, tol = DTYPES[dtype]
    rad_j = jnp.asarray(radii, dj) if poly else None
    rad_t = torch.from_numpy(radii).to(dt) if poly else None
    r_t, F_t = torch.from_numpy(r).to(dt), torch.from_numpy(F).to(dt)
    # the float32 species-pair fits, built once a package (the JAX ones
    # outside jit: they need concrete radii)
    f32_poly = poly and dtype == "float32"
    pt_j = ewald_j.make_poly_tables(pj, radii) if f32_poly else None
    tabs = ewald_t.make_poly_tables(pt, radii) if f32_poly else None
    U_j = np.asarray(jax_fast(
        lambda F_, r_, a_: cells_j.real_space_apply_cells(
            F_, r_, pj, radii=a_, poly_tables=pt_j),
        jnp.asarray(F, dj), jnp.asarray(r, dj), rad_j))
    U_t = cells_t.real_space_apply_cells(F_t, r_t, pt, radii=rad_t,
                                         poly_tables=tabs)
    assert U_t.dtype == dt and U_t.shape == F.shape
    assert _rel(U_t, U_j) < tol
    U1 = cells_t.real_space_apply_cells(F_t[0], r_t, pt, radii=rad_t,
                                        poly_tables=tabs)
    assert _rel(U1, U_j[0]) < tol
    U_all = ewald_t.real_space_apply(F_t, r_t, pt, radii=rad_t,
                                     poly_tables=tabs)
    assert _rel(U_t, U_all) < tol


def test_overflow_poisons_with_nan(cloud):
    """Every tile is adjacent to many others at this density: one slot must
    overflow and poison the whole result, never truncate silently; so must
    one slot fewer than neighbor_width, and neighbor_width itself not."""
    pt, r = cloud[1], cloud[2]
    ones = torch.ones((N, 3), dtype=torch.float64)
    U = cells_t.real_space_apply_cells(ones, torch.from_numpy(r), pt,
                                       max_nbr=1)
    assert bool(torch.isnan(U).all())
    # neighbor_width is the least width that does not overflow
    w = cells_t.neighbor_width(torch.from_numpy(r), pt)
    assert 1 < w <= -(-N // cells_t.TILE)
    for m, finite in ((w, True), (w - 1, False)):
        U = cells_t.real_space_apply_cells(ones, torch.from_numpy(r), pt,
                                           max_nbr=m)
        assert bool(torch.isfinite(U).all()) is finite


def test_clustered_bodies_do_not_overflow():
    """One rigid body's blobs all in one place (the case that defeats
    uniform cells): a tight 500-blob cluster with the default width stays
    finite and equals the all-pairs sweep, as in the JAX package's test."""
    params = ewald_t.make_params(BOX, 0.04, tol=TOL, rc=RC)
    rng = np.random.default_rng(2)
    cluster = 5.0 + 0.4 * rng.standard_normal((500, 3))
    sparse = rng.uniform(0, 9, (200, 3))
    r = torch.from_numpy(np.concatenate([cluster, sparse]))
    F = torch.from_numpy(rng.standard_normal((700, 3)))
    U = cells_t.real_space_apply_cells(F, r, params)
    assert bool(torch.isfinite(U).all())
    assert _rel(U, ewald_t.real_space_apply(F, r, params)) < 1e-12


@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
def test_chunk_sizes_are_bitwise_equal(cloud, poly):
    """Chunking groups row tiles only: one or seven tiles a chunk and the
    default chunk give bitwise equal sums (float32, the card's dtype)."""
    pt, r, F, radii = cloud[1:]
    kw = dict(radii=torch.from_numpy(radii).float(),
              poly_tables=ewald_t.make_poly_tables(pt, radii)) if poly else {}
    args = (torch.from_numpy(F).float(), torch.from_numpy(r).float(), pt)
    U1 = cells_t.real_space_apply_cells(*args, chunk_tiles=1, **kw)
    U7 = cells_t.real_space_apply_cells(*args, chunk_tiles=7, **kw)
    Ud = cells_t.real_space_apply_cells(*args, **kw)
    assert torch.equal(U1, Ud) and torch.equal(U7, Ud)
    # the default chunks: whole row tiles within the budget of live tile
    # pairs, at least one row tile a chunk
    offs = np.array([0, 5, 9, 20, 21, 30])
    assert cells_t._chunk_bounds(offs, 10) == [0, 2, 3, 5]
    assert cells_t._chunk_bounds(offs, 100) == [0, 5]
    assert cells_t._chunk_bounds(offs, 1) == [0, 1, 2, 3, 4, 5]


def test_cells_need_rc(cloud):
    p0 = ewald_t.make_params(BOX, A, tol=TOL)
    with pytest.raises(ValueError, match="rc="):
        cells_t.real_space_apply_cells(torch.zeros(4, 3), torch.zeros(4, 3),
                                       p0)
