"""The balanced split's tile kernel "K4 tiles" (``ops/ewald_cuda.py::
tile_pair_sum``, ``csrc/ewald_real_sweep.cu::ewald_tile_kernel``) on the
CPU: its work list, a Python mirror of its summation order, its refusals
and the CPU route to its plain twin ``ewald_cells._cell_sweep``.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 59).  It sweeps each unordered pair of neighbor
tiles once (``ewald_cuda.tile_list``: K3's ``tiles.tile_pairs``, sliced by
``tiles.slice_pairs``, and ``tiles.pair_slots``), which needs the
balanced split's neighbor lists to be symmetric and the minimum image to
be odd: both are checked here, with pad tiles and a tile adjacent to
itself across the box's face.  The mirror replays, in the working dtype,
what each warp adds and in which order: a tile pair's 8 × 8 sub-blocks
(R, C), lane (ρ, γ) taking rows 8R + ρ and 8R + ρ + 4 against column
8C + γ; a row's terms summed over C per γ and then over the 8 γ by a
butterfly, a column's over its sub-block's rows by a butterfly and then
over R; a diagonal pair keeping j > i and adding its two sides; the
slice's sides written alone; a tile's partials summed in its list's
order; masked pairs an exact 0; the minimum image the twin's and the
kernel's ``_min_image`` (the period off the coordinate past L/2 before
the difference).  It is held against the plain twin and the JAX
package's ``real_space_apply_cells`` on the same numpy inputs: to 1e-12
of max|U| in float64 (the closed forms, the same pair set, another
summation order) and to 5e-6 of max|U| in float32 (the species-pair or
monodisperse fits; ``tests/test_ewald_cells.py``'s float32 bound),
monodisperse and with two radii, at 1 and 2 RHS, on a slice of the row
tiles and on the whole.  The cloud is small (320 blobs in a (8, 9, 7)
box, a = 0.3, tol 1e-5, rc 2.5), and the JAX sweeps are compiled at
XLA's cheapest CPU optimization, once a module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rigid_body_light_tpu.ops import ewald as ewald_j  # noqa: E402
from rigid_body_light_tpu.ops import ewald_cells as cells_j  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald as ewald_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald_cells as cells_t  # noqa: E402
from rigid_body_light_tpu_torch.ops import ewald_cuda, tiles  # noqa: E402
from rigid_body_light_tpu_torch.utils import profiling  # noqa: E402

N = 320
BOX = (8.0, 9.0, 7.0)
A, TOL, RC = 0.3, 1e-5, 2.5
T = tiles.TILE
SUB = 8                 # the kernel's kTileSub: a warp step's sub-block
DTYPES = {"float64": (jnp.float64, torch.float64, 1e-12),
          "float32": (jnp.float32, torch.float32, 5e-6)}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(11)
    r = rng.uniform(-3, 11, (N, 3))
    F = rng.standard_normal((2, N, 3))
    radii = rng.choice([0.2, 0.45], size=N)
    pt = ewald_t.make_params(BOX, A, tol=TOL, rc=RC)
    return (ewald_j.make_params(BOX, A, tol=TOL, rc=RC), pt, r, F, radii,
            ewald_t.make_poly_tables(pt, radii))


@pytest.fixture(scope="module")
def jax_refs(cloud):
    """The JAX package's tile sweep at 2 RHS for each (dtype, poly), each
    compiled once."""
    pj, _, r, F, radii, _ = cloud
    out = {}

    def ref(dtype, poly):
        if (dtype, poly) not in out:
            dj = DTYPES[dtype][0]
            rad = jnp.asarray(radii, dj) if poly else None
            tabs = (ewald_j.make_poly_tables(pj, radii)
                    if poly and dtype == "float32" else None)

            def fn(F_, r_, a_):
                return cells_j.real_space_apply_cells(F_, r_, pj, radii=a_,
                                                      poly_tables=tabs)
            args = (jnp.asarray(F, dj), jnp.asarray(r, dj), rad)
            out[dtype, poly] = np.asarray(
                jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args))
        return out[dtype, poly]
    return ref


def _rel(U, ref):
    U, ref = np.asarray(U, np.float64), np.asarray(ref, np.float64)
    return np.abs(U - ref).max() / np.abs(ref).max()


def _tiles_of(cloud, dtype, poly):
    """ewald_cells.sorted_tiles of the cloud (width the tile count)."""
    _, pt, r, F, radii, tabs = cloud
    dt = DTYPES[dtype][1]
    r_t = torch.from_numpy(r).to(dt)
    rad = torch.from_numpy(radii).to(dt) if poly else None
    return cells_t.sorted_tiles(
        cells_t._fold(r_t, pt), torch.from_numpy(F).to(dt), pt,
        -(-N // T), radii=rad,
        poly_tables=tabs if poly and dt == torch.float32 else None)


def _pair_terms(r_pad, ids_pad, F_pad, params, poly, I, J):
    """The kernel's terms of row tile I against column tile J, each pair's
    fields once: (into the rows, into the columns), each (32 rows, 32
    columns, k, 3) — [A·I + B·r̂r̂] times the column's force and times the
    row's; its minimum image, r² summed as the plain sweep sums it, A and
    B as ``_cell_sweep`` picks them, B·(d·F)/r²·d, masked pairs (a pad on
    either side, the self pair, r > rc) an exact 0."""
    rows, cols = slice(I * T, (I + 1) * T), slice(J * T, (J + 1) * T)
    d = cells_t._min_image(r_pad[rows][:, None], r_pad[cols][None],
                           params.box)
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    idr, idc = ids_pad[rows][:, None], ids_pad[cols][None]
    ok = (idr >= 0) & (idc >= 0) & (idr != idc)
    r2 = torch.where(ok, torch.clamp(r2, min=1e-24), torch.ones_like(r2))
    rr = torch.sqrt(r2)
    valid = ok & (rr <= params.rc)
    if poly is not None and poly[1] is not None:
        A_, B_ = ewald_t.pair_scalars(rr, params, True, si=poly[1][rows, None],
                                      sj=poly[1][None, cols], pt=poly[2])
    elif poly is not None:
        A_, B_ = ewald_t.pair_scalars(rr, params, False, ai=poly[0][rows, None],
                                      aj=poly[0][None, cols])
    else:
        A_, B_ = ewald_t.pair_scalars(rr, params,
                                      r_pad.dtype == torch.float32)
    zero = torch.zeros_like(rr)
    A_ = torch.where(valid, A_, zero)
    Bh = torch.where(valid, B_ / r2, zero)
    Fj = F_pad[:, cols].permute(1, 0, 2)                  # (32 cols, k, 3)
    Fi = F_pad[:, rows].permute(1, 0, 2)                  # (32 rows, k, 3)
    dFj = torch.einsum("rcx,ckx->rck", d, Fj)
    dFi = torch.einsum("rcx,rkx->rck", d, Fi)
    return (A_[..., None, None] * Fj[None]
            + (Bh[..., None] * dFj)[..., None] * d[:, :, None, :],
            A_[..., None, None] * Fi[:, None]
            + (Bh[..., None] * dFi)[..., None] * d[:, :, None, :])


def _tree(v, dim):
    """The kernel's butterfly sum over ``dim`` (2, 4 or 8 lanes): pairs of
    neighbors first, ((v0 + v1) + (v2 + v3)) + ...; every lane of the
    butterfly holds the same bits (IEEE addition commutes)."""
    while v.shape[dim] > 1:
        v = v.unflatten(dim, (-1, 2))
        v = v.select(dim + 1, 0) + v.select(dim + 1, 1)
    return v.squeeze(dim)


def _pair_partials(r_pad, ids_pad, F_pad, params, poly, a, b):
    """One warp's two partials of tile pair (a, b ≥ a): (row side (32, k,
    3) of tile a, column side of tile b), in the kernel's order."""
    row_t, col_t = _pair_terms(r_pad, ids_pad, F_pad, params, poly, a, b)
    if a == b:                                          # j > i only
        keep = torch.ones(T, T, dtype=torch.bool).triu(1)[..., None, None]
        row_t = torch.where(keep, row_t, torch.zeros_like(row_t))
        col_t = torch.where(keep, col_t, torch.zeros_like(col_t))
    n_s = T // SUB
    # rows r = 8R + ρ + 4h, columns c = 8C + γ
    rt = row_t.reshape(n_s, 2, 4, n_s, SUB, *row_t.shape[2:])  # R h ρ C γ
    ct = col_t.reshape(n_s, 2, 4, n_s, SUB, *col_t.shape[2:])
    # row side: over C in order per γ (from 0), then the butterfly over γ
    acc = torch.zeros_like(rt[:, :, :, 0])
    for C in range(n_s):
        acc = acc + rt[:, :, :, C]
    row = _tree(acc, 3).reshape(T, *row_t.shape[2:])
    # column side: each sub-block's two rows a lane, the butterfly over ρ,
    # then over R in order (from 0)
    sub = _tree(ct[:, 0] + ct[:, 1], 1)                 # (R, C, γ, k, 3)
    col = torch.zeros_like(sub[0])
    for R in range(n_s):
        col = col + sub[R]
    col = col.reshape(T, *col_t.shape[2:])
    return row, col


def mirror(r_pad, ids_pad, F_pad, nbr, params, poly, t0, nt):
    """K4 tiles' result, replayed in its summation order (module doc)."""
    lst = ewald_cuda.tile_list(nbr, t0, nt)
    starts = lst.row_start.tolist()
    first = starts[t0]
    k = F_pad.shape[0]
    part = torch.full((lst.cap, T, k, 3), float("nan"), dtype=r_pad.dtype)
    for a, b, sab, sba in lst.pairs[:int(lst.n_pairs)].tolist():
        row, col = _pair_partials(r_pad, ids_pad, F_pad, params, poly, a, b)
        if a == b:
            part[starts[a] - first + sab] = row + col
            continue
        if t0 <= a < t0 + nt:
            part[starts[a] - first + sab] = row
        if t0 <= b < t0 + nt:
            part[starts[b] - first + sba] = col
    out = []
    for x in range(t0, t0 + nt):
        v = torch.zeros((T, k, 3), dtype=r_pad.dtype)
        for g in range(starts[x], starts[x + 1]):
            v = v + part[g - first]
        out.append(v)
    return torch.cat(out).permute(1, 0, 2)                 # (k, nt·32, 3)


def _face_cloud():
    """96 blobs in a (6, 6, 6) box, a = 0.3, rc 2.5: tile 0 a column of 32
    blobs straddling the z face (16 just above 0, 16 just below L), so
    the tile is adjacent to itself across the face and its diagonal pair
    keeps pairs that meet only there; two more tiles elsewhere, one of
    them across the x face from the first; one pad tile at D = 4."""
    rng = np.random.default_rng(5)
    r = np.empty((96, 3))
    r[:32, :2] = rng.uniform(0.4, 1.0, (32, 2))
    r[:32, 2] = np.concatenate([rng.uniform(0.02, 0.4, 16),
                                rng.uniform(5.6, 5.98, 16)])
    r[32:64] = rng.uniform([5.3, 0.3, 2.0], [5.9, 1.2, 3.5], (32, 3))
    r[64:] = rng.uniform([2.5, 4.6, 2.5], [3.5, 5.4, 3.5], (32, 3))
    F = rng.standard_normal((2, 96, 3))
    return r, F, ewald_t.make_params((6.0, 6.0, 6.0), A, tol=TOL, rc=RC)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_pair_list_covers_every_live_entry_once(cloud, d):
    """The shared pair list over the balanced split's lists, for each
    row-tile slice at D ranks (tiles padded to a multiple of D, whole pad
    tiles at D = 4): every live (I, J) entry of a slice tile's list lies in
    exactly one listed pair, as (I, J) or (J, I) with the second ≥ the
    first, the two slots pointing back at each other; no pair without a
    tile in the slice; the pairs' in-slice sides write each live slot of
    the slice's lists once (the partials: as many as those slots)."""
    _, pt, r, F, _, _ = cloud
    rf = cells_t._fold(torch.from_numpy(r), pt)
    _, _, _, _, _, nbr, overflow = cells_t.sorted_tiles(
        rf, torch.from_numpy(F), pt, -(-N // T), d)
    assert not bool(overflow)
    t = nbr.shape[0]
    assert t % d == 0 and (d < 4 or t * T - N >= T)     # a whole pad tile
    nt = t // d
    lists = nbr.tolist()
    live = [sum(J >= 0 for J in row) for row in lists]
    for x in range(d):
        t0 = x * nt
        lst = ewald_cuda.tile_list(nbr, t0, nt)
        assert lst.pairs.dtype == lst.row_start.dtype == torch.int32
        assert lst.row_start.tolist() == np.concatenate(
            [[0], np.cumsum(live)]).tolist()
        assert lst.cap == sum(live[t0:t0 + nt]) >= int(lst.n_pairs)
        got = [tuple(p) for p in lst.pairs[:int(lst.n_pairs)].tolist()]
        assert len(set((a, b) for a, b, _, _ in got)) == len(got)
        writes = []
        for a, b, sab, sba in got:
            assert b >= a and (t0 <= a < t0 + nt or t0 <= b < t0 + nt)
            assert lists[a][sab] == b and lists[b][sba] == a
            if t0 <= a < t0 + nt:
                writes.append((a, sab))
            if t0 <= b < t0 + nt and a != b:
                writes.append((b, sba))
        want = {(min(I, J), max(I, J)) for I in range(t0, t0 + nt)
                for J in lists[I] if J >= 0}
        assert {(a, b) for a, b, _, _ in got} == want
        assert sorted(writes) == [(I, s) for I in range(t0, t0 + nt)
                                  for s in range(live[I])]


def test_lists_are_symmetric_with_pads_and_a_face(cloud):
    """The balanced split's neighbor lists are symmetric (the symmetric
    sweep's premise: ``tiles.bbox_adjacency``'s centre difference is
    exactly antisymmetric and ``torch.round`` odd), each tile lists itself,
    on the cloud at D = 1, 2, 4 (pad tiles at its first blob) and on a
    tile adjacent to itself across the box's face; there the symmetric
    mirror keeps the face's pairs: it agrees with the twin and with the
    all-pairs sweep with the cut in float64."""
    _, pt, r, F, _, _ = cloud
    rf = cells_t._fold(torch.from_numpy(r), pt)
    rf_face, F_face, p_face = _face_cloud()
    cases = [(rf, F, pt, d) for d in (1, 2, 4)] + [
        (cells_t._fold(torch.from_numpy(rf_face), p_face), F_face, p_face,
         d) for d in (1, 4)]
    for rfc, Fc, par, d in cases:
        order, r_pad, ids_pad, F_pad, _, nbr, overflow = cells_t.sorted_tiles(
            rfc, torch.from_numpy(Fc), par, -(-rfc.shape[0] // T), d)
        assert not bool(overflow)
        adj = tiles.bbox_adjacency(r_pad, nbr.shape[0], par.rc, box=par.box)
        assert torch.equal(adj, adj.T) and bool(adj.diagonal().all())
        lists = [{J for J in row if J >= 0} for row in nbr.tolist()]
        for I, row in enumerate(lists):
            assert I in row and all(I in lists[J] for J in row)
    # the face tile: blob 0's tile holds both sides of the face, and pairs
    # of it within rc meet only through the face
    order, r_pad, ids_pad, F_pad, _, nbr, _ = cells_t.sorted_tiles(
        cells_t._fold(torch.from_numpy(rf_face), p_face),
        torch.from_numpy(F_face), p_face, 3)
    tile0 = int((order == 0).nonzero()) // T
    z = r_pad[tile0 * T:(tile0 + 1) * T, 2]
    assert z.min() < 0.5 and z.max() > 5.5
    U = mirror(r_pad, ids_pad, F_pad, nbr, p_face, None, 0, nbr.shape[0])
    twin = cells_t._cell_sweep(r_pad, ids_pad, F_pad, nbr, p_face)
    assert _rel(U, twin) < 1e-12
    Uo = torch.zeros((2, 96, 3), dtype=U.dtype)
    Uo[:, order] = U[:, :96]
    ref = ewald_t.real_space_apply(torch.from_numpy(F_face),
                                   torch.from_numpy(rf_face), p_face)
    assert _rel(Uo, ref) < 1e-12
    # the diagonal pair keeps pairs within rc that meet only across the face
    x0 = r_pad[tile0 * T:(tile0 + 1) * T]
    plain = (x0[:, None] - x0[None]).norm(dim=-1)
    image = cells_t._min_image(x0[:, None], x0[None], p_face.box).norm(dim=-1)
    assert int(((plain > RC) & (image <= RC)).sum()) >= 10


def test_min_image_is_odd():
    """``ewald_cells._min_image`` (the kernel's ``min_image``) is odd in
    (a, b) bit for bit, in float32 and float64, over random folded
    coordinates and the ties: differences of exactly ±L/2, equal
    coordinates, the box's two faces."""
    rng = np.random.default_rng(2)
    box = (8.0, 9.0, 7.0)
    L = np.asarray(box)
    a = rng.uniform(0, 1, (4096, 3)) * L
    b = rng.uniform(0, 1, (4096, 3)) * L
    q = rng.integers(0, 29, (64, 3)) / 8.0             # exact, ≤ min(L)/2
    half = np.stack([q, q + L / 2])
    edge = np.array([[0.0, 0.0, 0.0], L, L / 2, L / 4, 3 * L / 4])
    A_ = np.concatenate([a, half[0], half[1], edge, edge])
    B_ = np.concatenate([b, half[1], half[0], edge[::-1], edge])
    for dt in (torch.float32, torch.float64):
        x, y = torch.from_numpy(A_).to(dt), torch.from_numpy(B_).to(dt)
        d1 = cells_t._min_image(x, y, box)
        d2 = cells_t._min_image(y, x, box)
        assert torch.equal(d1, -d2)
        assert bool((d1.abs() <= torch.tensor(L, dtype=dt) / 2).all())
        ties = (x - y).abs() == torch.tensor(L, dtype=dt) / 2
        assert int(ties.sum()) >= 64


@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mirror_matches_twin_and_jax(cloud, jax_refs, dtype, poly):
    """The mirror of the kernel's per-pair, per-sub-block sums against the
    plain twin on a slice and the whole, and against the JAX package's
    tile sweep, at 1 and 2 RHS."""
    params = cloud[1]
    tol = DTYPES[dtype][2]
    order, r_pad, ids_pad, F_pad, pp, nbr, overflow = _tiles_of(cloud, dtype,
                                                                poly)
    assert not bool(overflow)
    t = nbr.shape[0]
    whole = mirror(r_pad, ids_pad, F_pad, nbr, params, pp, 0, t)
    for k in (1, 2):
        twin = cells_t._cell_sweep(r_pad, ids_pad, F_pad[:k], nbr, params,
                                   poly=pp)
        assert _rel(whole[:k], twin) < tol
    t0, nt = 2, 4
    sl = mirror(r_pad, ids_pad, F_pad, nbr, params, pp, t0, nt)
    twin = cells_t._cell_sweep(r_pad, ids_pad, F_pad, nbr, params, poly=pp,
                               t0=t0, nt=nt)
    assert _rel(sl, twin) < tol
    # a slice is the same rows of the whole, bit for bit (the same pairs)
    assert torch.equal(sl, whole[:, t0 * T:(t0 + nt) * T])
    U = torch.zeros((2, N, 3), dtype=whole.dtype)
    U[:, order] = whole[:, :N]
    ref = jax_refs(dtype, poly)
    assert _rel(U, ref) < tol and _rel(U[:1], ref[:1]) < tol


def test_tile_pair_sum_refusals(cloud):
    """Three RHS, float64, a non-contiguous force, params without rc and a
    fit table past the kernel's shared memory raise, on the CPU as on the
    card; the poly form without species-pair fits raises."""
    _, params, _, _, radii, tabs = cloud
    order, r_pad, ids_pad, F_pad, pp, nbr, _ = _tiles_of(cloud, "float32",
                                                         True)
    with pytest.raises(ValueError, match="1 or 2 RHS"):
        ewald_cuda.tile_pair_sum(r_pad, ids_pad, torch.cat([F_pad, F_pad]),
                                 nbr, params, poly=pp)
    with pytest.raises(TypeError, match="float32"):
        ewald_cuda.tile_pair_sum(r_pad.double(), ids_pad, F_pad.double(),
                                 nbr, params, poly=pp)
    with pytest.raises(ValueError, match="contiguous"):
        ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad.transpose(1, 2)
                                 .contiguous().transpose(1, 2), nbr, params,
                                 poly=pp)
    with pytest.raises(ValueError, match="rc="):
        ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad, nbr,
                                 ewald_t.make_params(BOX, A, tol=TOL))
    with pytest.raises(ValueError, match="poly_tables"):
        ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad, nbr, params,
                                 poly=(pp[0], None, None))
    # a degree past capacity: the table is sized, never truncated
    n_fits, deg, n_sp, nbytes = ewald_cuda._tile_table_size(params, tabs)
    assert nbytes <= ewald_cuda.TILE_TABLE_BYTES
    big = ewald_cuda.TILE_TABLE_BYTES // (32 * n_fits)
    wide = tabs._replace(coefA=np.zeros(tabs.coefA.shape[:2] + (big,)),
                         coefB=np.zeros(tabs.coefB.shape[:2] + (big,)))
    with pytest.raises(ValueError, match=f"degree {big - 1}"):
        ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad, nbr, params,
                                 poly=(pp[0], pp[1], wide))
    assert nbytes == n_fits * (deg + 1) * 32 + n_fits * 32 + n_sp * n_sp * 4


def test_tile_tables_layout(cloud):
    """The kernel's tables: [fit, j, segment] = (A_j, B_j) in float32, the
    fits' segment constants as K4's, the species-pair map; the monodisperse
    table is K4's, and K4's 14 constants are what they were."""
    _, params, _, _, _, tabs = cloud
    coef, fits, pmap = ewald_cuda.tile_tables(params)
    assert pmap is None and coef.shape[0] == fits.shape[0] == 1
    np.testing.assert_array_equal(coef[0],
                                  ewald_cuda.coefficient_table(params))
    k4 = ewald_cuda.sweep_constants(params)
    np.testing.assert_array_equal(fits[0], k4[6:])
    b = np.asarray(params.cheb_bounds, np.float64)
    widths = np.diff(b[:4])
    want = np.concatenate([[b[1], b[2]], b[:3], np.minimum(
        2.0 / np.maximum(widths, 1e-300), np.finfo(np.float32).max)])
    np.testing.assert_array_equal(k4[6:], want.astype(np.float32))
    np.testing.assert_array_equal(
        k4[:6], np.asarray(list(BOX) + [1.0 / v for v in BOX], np.float32))
    coef, fits, pmap = ewald_cuda.tile_tables(params, tabs)
    P = tabs.bounds.shape[0]
    assert coef.shape == (P, tabs.coefA.shape[2], 4, 2) and fits.shape == (
        P, 8)
    np.testing.assert_array_equal(pmap, tabs.pair_map)
    for p in range(P):
        np.testing.assert_array_equal(coef[p, :, :3, 0],
                                      tabs.coefA[p].T.astype(np.float32))
        np.testing.assert_array_equal(coef[p, :, :3, 1],
                                      tabs.coefB[p].T.astype(np.float32))
        assert not coef[p, :, 3].any()
        np.testing.assert_array_equal(
            fits[p], np.asarray(ewald_cuda._segment_constants(tabs.bounds[p]),
                                np.float32))


@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
def test_cpu_takes_the_twin_with_no_launch(cloud, poly):
    """On the CPU the wrapper is the twin bit for bit and counts no launch;
    the float32 operator reaches it (use_kernel=False is the twin itself),
    three RHS go two at a time, and the apply's spans split the list build
    (``ewald_tiles``) from the sweep."""
    _, params, r, F, radii, tabs = cloud
    order, r_pad, ids_pad, F_pad, pp, nbr, _ = _tiles_of(cloud, "float32",
                                                         poly)
    before = ewald_cuda.launch_counts()
    U = ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad, nbr, params, poly=pp,
                                 t0=1, nt=3)
    assert torch.equal(U, cells_t._cell_sweep(r_pad, ids_pad, F_pad, nbr,
                                              params, poly=pp, t0=1, nt=3))
    kw = dict(radii=torch.from_numpy(radii).float(),
              poly_tables=tabs) if poly else {}
    r32, F32 = torch.from_numpy(r).float(), torch.from_numpy(F).float()
    with profiling.StepTimer(device="cpu") as timer:
        Uk = cells_t.real_space_apply_cells(F32, r32, params, **kw)
    split = timer.split()
    assert split["ewald_tiles"]["count"] == 1
    assert set(split) <= set(profiling.PARTS)
    Up = cells_t.real_space_apply_cells(F32, r32, params, use_kernel=False,
                                        **kw)
    assert torch.equal(Uk, Up)
    F3 = torch.cat([F32, F32[:1] * 0.5])
    U3 = cells_t.real_space_apply_cells(F3, r32, params, **kw)
    assert _rel(U3, cells_t.real_space_apply_cells(F3, r32, params,
                                                   use_kernel=False, **kw)) \
        < 1e-6
    assert torch.equal(U3[:2], Uk)
    assert ewald_cuda.launch_counts() == before
    assert before["ewald_real_tiles"] == 0
