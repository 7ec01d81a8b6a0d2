"""The balanced split's tile kernel "K4 tiles" (``ops/ewald_cuda.py::
tile_pair_sum``, ``csrc/ewald_real_sweep.cu::ewald_tile_kernel``) on the
CPU: its work items, a Python mirror of its summation order, its
refusals and the CPU route to its plain twin ``ewald_cells._cell_sweep``.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 59).  Here the mirror replays, in the working
dtype, what each block and warp adds and in which order: the items of
``tile_items`` (a row tile's live list slots in runs of ``slots``), warp w
taking the slots s0 + w, s0 + w + 4, ..., each lane walking its row's 32
columns two at a time (c and c + 16) into a slot sum that it adds to its
row's, the warps' sums added in warp order and a row tile's items in item
order; masked pairs add an exact 0; the minimum image is the twin's and
the kernel's ``_min_image`` (the period off the coordinate past L/2
before the difference).  It is
held against the plain twin and the JAX package's ``real_space_apply_cells``
on the same numpy inputs: to 1e-12 of max|U| in float64 (the closed forms,
the same pair set, another summation order) and to 5e-6 of max|U| in
float32 (the species-pair or monodisperse fits; ``tests/test_ewald_cells.py``'s
float32 bound), monodisperse and with two radii, at 1 and 2 RHS, on a
slice of the row tiles and on the whole.  The cloud is small (320 blobs in
a (8, 9, 7) box, a = 0.3, tol 1e-5, rc 2.5), and the JAX sweeps are
compiled at XLA's cheapest CPU optimization, once a module.
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
WARPS, PAIRS = 4, 2     # the kernel's kTileWarps and kTilePairs
SLOTS = 3               # a few live slots an item, so rows hold many items
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
    """The kernel's terms of row tile I against column tile J: (32 rows,
    32 columns, k, 3), its minimum image, r² summed as the plain sweep sums
    it, A and B as ``_cell_sweep`` picks them, B·(d·F)/r²·d, masked pairs
    an exact 0."""
    rows, cols = slice(I * T, (I + 1) * T), slice(J * T, (J + 1) * T)
    d = cells_t._min_image(r_pad[rows][:, None], r_pad[cols][None],
                           params.box)
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    idr, idc = ids_pad[rows][:, None], ids_pad[cols][None]
    ok = (idc >= 0) & (idr != idc)
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
    dF = torch.einsum("rcx,ckx->rck", d, Fj)
    return A_[..., None, None] * Fj[None] + (Bh[..., None] * dF)[..., None] \
        * d[:, :, None, :]


def mirror(r_pad, ids_pad, F_pad, nbr, params, poly, t0, nt, slots=SLOTS):
    """K4 tiles' result, replayed in its summation order (module doc)."""
    items, n_q, n_items, _ = ewald_cuda.tile_items(nbr, t0, nt, slots)
    k, M = F_pad.shape[0], nbr.shape[1]
    zero = torch.zeros((T, k, 3), dtype=r_pad.dtype)
    part = {}
    for I_rel, q in items[:int(n_items)].tolist():
        I = t0 + I_rel
        warp_sums = []
        for w in range(WARPS):
            acc = zero.clone()
            for s in range(q * slots + w, min(q * slots + slots, M), WARPS):
                J = int(nbr[I, s])
                if J < 0:
                    break
                terms = _pair_terms(r_pad, ids_pad, F_pad, params, poly, I, J)
                steps = T // PAIRS
                slot_sum = zero.clone()
                for c in range(steps):
                    for p in range(PAIRS):
                        slot_sum = slot_sum + terms[:, c + p * steps]
                acc = acc + slot_sum
            warp_sums.append(acc)
        v = warp_sums[0]
        for a in warp_sums[1:]:
            v = v + a
        part[I_rel, q] = v
    out = []
    for I_rel in range(nt):
        v = zero.clone()
        for q in range(int(n_q[I_rel])):
            v = v + part[I_rel, q]
        out.append(v)
    return torch.cat(out).permute(1, 0, 2)                 # (k, nt·32, 3)


@pytest.mark.parametrize("slots", [1, 3, 16])
def test_items_cover_every_live_slot_once(cloud, slots):
    """Every live (row tile, slot) of a slice lies in exactly one item, in
    slot order; no item crosses a row tile; items are listed row tile by
    row tile, q ascending; the count is within the scratch bound nt·Q.
    Also on hand-made lists: a full one, one with one live slot, an empty
    one."""
    nbr = _tiles_of(cloud, "float64", False)[5]
    hand = torch.tensor([[0, 1, 2, 3, 4], [1, -1, -1, -1, -1],
                         [-1, -1, -1, -1, -1], [0, 2, 3, -1, -1]])
    for lists, t0, nt in ((nbr, 0, nbr.shape[0]), (nbr, 3, 5), (hand, 0, 4),
                          (hand, 1, 2)):
        items, n_q, n_items, q_cap = ewald_cuda.tile_items(lists, t0, nt,
                                                           slots)
        M = lists.shape[1]
        assert q_cap == -(-M // slots) and items.shape == (nt * q_cap, 2)
        assert items.dtype == n_q.dtype == n_items.dtype == torch.int32
        used = items[:int(n_items)].tolist()
        assert 0 <= int(n_items) <= nt * q_cap
        assert used == sorted(used)          # row tile by row tile, q up
        seen = []
        for I_rel, q in used:
            assert 0 <= I_rel < nt and q < int(n_q[I_rel])
            span = range(q * slots, min((q + 1) * slots, M))
            live = [s for s in span if lists[t0 + I_rel, s] >= 0]
            assert live, "an item holds at least one live slot"
            seen += [(I_rel, s) for s in live]
        want = [(I_rel, s) for I_rel in range(nt) for s in range(M)
                if lists[t0 + I_rel, s] >= 0]
        assert seen == want                  # each once, in slot order
        for I_rel in range(nt):
            n_live = int((lists[t0 + I_rel] >= 0).sum())
            assert int(n_q[I_rel]) == -(-n_live // slots)


@pytest.mark.parametrize("poly", [False, True], ids=["mono", "poly"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mirror_matches_twin_and_jax(cloud, jax_refs, dtype, poly):
    """The mirror of the kernel's per-item, per-warp sums against the plain
    twin on a slice and the whole, and against the JAX package's tile
    sweep, at 1 and 2 RHS."""
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
    # a slice is the same rows of the whole, bit for bit (the same items)
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
