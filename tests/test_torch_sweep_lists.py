"""The work lists of the sweep kernels K1–K4, on the CPU.

K3 (the far field's near sweep) walks the unordered adjacent tile pairs of
``tiles.tile_pairs`` and writes each side of a pair into a per-slot
partial; a plain PyTorch walk of that list, written here, must give the
plain ordered sweep ``farfield._near_sweep`` in float64; its row-tile
slice (the distributed far field's) walks the slice's work list
(``tiles.slice_pairs``: the pairs with a tile in the slice, in list
order) writing the slice's sides alone, and must give the rows of the
slice, each pair listed once and the boundary pairs counted.  K1 (the dense
symmetric pair sweep) and K4 (the Ewald real-space sweep) walk the 128 ×
128 tile pairs of ``tiles.upper_tile_items``, which must cover every
unordered pair i < j once; a mirror of K1's per-thread loop must too.
Past 65,536 blobs their blocks walk pairs of tile groups
(``tiles.group_items``) into one row and one column partial a tile of the
block's groups: the walks must cover every tile pair once, a float64
mirror of the partials and the second pass (``tiles.sum_order``) must give
the plain pair sum, and the partials must grow as n up to 1M blobs.  K2
(the ordered slab) must visit every ordered pair of a slab with global
offsets once, and no self pair; so must a mirror of K4's slab form, whose
grid and scratch are pinned at the ring's shapes.  The kernels
themselves run on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rigid_body_light_tpu_torch as rt  # noqa: E402
from rigid_body_light_tpu_torch.ops import (ewald_cuda, farfield, rpy,  # noqa: E402
                                            rpy_cuda, tiles)

TILE = farfield.TILE
H_FLOOR = 0.75
# plain walk vs plain ordered sweep, both float64, relative to max|U|:
# the same pair terms summed in another order
WALK_TOL = 1e-12


def _suspension(shell, n_bodies, spacing, seed):
    """n_bodies copies of a shell on a square lattice at heights 1.6-3.4
    (units of the shell's blob radius a), each shifted a little; returns
    (positions, a)."""
    params, ref = rt.load_structure(shell)
    a = params["sep"] / 2
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_bodies)))
    centers = np.array([[spacing * (i % side), spacing * (i // side),
                         2.5] for i in range(n_bodies)])
    centers += rng.uniform(-0.9, 0.9, centers.shape)
    return (centers[:, None, :] + ref[None]).reshape(-1, 3), a


CLOUDS = {
    # 24 × shell_N_42 = 1,008 blobs: 8 tiles, the last one partial
    "shell_N_42": dict(shell="shell_N_42", n_bodies=24, spacing=2.6,
                       grid=(4, 4, 2)),
    # 37 × shell_N_12 = 444 blobs: 4 tiles, 68 pad rows at the last real
    # blob's position
    "shell_N_12": dict(shell="shell_N_12", n_bodies=37, spacing=1.5,
                       grid=(3, 3, 2)),
}


@pytest.fixture(scope="module", params=list(CLOUDS))
def ctxs(request):
    c = CLOUDS[request.param]
    r, a = _suspension(c["shell"], c["n_bodies"], c["spacing"], seed=7)
    r = torch.from_numpy(r)
    return {wall: farfield.prepare(r, a=a, wall=wall, grid=c["grid"], p=4)
            for wall in (False, True)}


def test_tile_pairs_cover_each_adjacent_tile_pair_once(ctxs):
    ctx = ctxs[True]
    nbr = ctx.nbr.numpy()
    t, w = nbr.shape
    count = int(ctx.n_pairs.item())
    assert ctx.pairs.shape == (t * w, 4) and ctx.pairs.dtype == torch.int32
    pairs = ctx.pairs[:count].numpy()
    # every listed neighbor relation, as unordered pairs
    expected = {(min(a, int(b)), max(a, int(b)))
                for a in range(t) for b in nbr[a] if b >= 0}
    got = [(int(a), int(b)) for a, b in pairs[:, :2]]
    assert len(got) == len(set(got)) == len(expected)
    assert set(got) == expected
    assert t < count < t * w           # more than the diagonal, a real list
    for a, b, sab, sba in pairs:
        assert b >= a
        assert nbr[a, sab] == b and nbr[b, sba] == a
    # list order: a-major, then a's slot order
    assert [tuple(p) for p in pairs[:, [0, 2]]] == sorted(
        tuple(p) for p in pairs[:, [0, 2]])
    # the rows past the used length stay in range (the kernel never reads
    # them, but an overflowed list may leave pairs unlisted)
    rest = ctx.pairs[count:].numpy()
    assert (rest >= 0).all() and (rest[:, :2] < t).all()
    assert (rest[:, 2:] < w).all()


def _pair_blocks(xr, xc, wall):
    """(R, C, 3, 3) RPY + wall pair blocks M_ij of rows against columns
    (units of a), the plain sweep's coefficients."""
    d = xr[:, None, :] - xc[None, :, :]
    alpha, beta = rpy._free_coeffs(torch.sum(d * d, dim=-1))
    eye = torch.eye(3, dtype=xr.dtype)
    M = (alpha[..., None, None] * eye
         + beta[..., None, None] * d[..., :, None] * d[..., None, :])
    if wall:
        zi = torch.clamp(xr[:, 2], min=H_FLOOR)
        zj = torch.clamp(xc[:, 2], min=H_FLOOR)
        rz = zi[:, None] + zj[None, :]
        d_img = torch.cat([d[..., :2], rz[..., None]], dim=-1)
        f1, f2, f3, f4, f5, invR = rpy._wall_coeffs(
            d_img, zj[None, :].expand(rz.shape))
        e = d_img * invR[..., None]
        z = eye[2]
        M = M + (f1[..., None, None] * eye
                 + f2[..., None, None] * e[..., :, None] * e[..., None, :]
                 + f3[..., None, None] * e[..., :, None] * z
                 + f4[..., None, None] * z[:, None] * e[..., None, :]
                 + f5[..., None, None] * z[:, None] * z)
    return M


def _walk_tile_pairs(ctx, F_s, wall):
    """What K3 computes, in plain PyTorch: each listed tile pair once, its
    kept pairs' blocks applied forward into the row tile's slot and
    transposed into the column tile's slot, then each tile's used slots
    summed in list order."""
    x, ci, live = ctx.x_s, ctx.ci_s, ctx.id_s >= 0
    t, w = ctx.nbr.shape
    k = F_s.shape[0]
    part = torch.full((w, k, t * TILE, 3), float("nan"), dtype=x.dtype)
    lane = torch.arange(TILE)
    for a, b, sab, sba in ctx.pairs[:int(ctx.n_pairs.item())].tolist():
        rows = slice(a * TILE, (a + 1) * TILE)
        cols = slice(b * TILE, (b + 1) * TILE)
        keep = (torch.all((ci[rows][:, None] - ci[cols][None]).abs() <= 1,
                          dim=-1)
                & live[rows][:, None] & live[cols][None, :])
        if a == b:
            keep &= lane[:, None] < lane[None, :]
        M = torch.where(keep[..., None, None],
                        _pair_blocks(x[rows], x[cols], wall), 0.0)
        row_side = torch.einsum("rcxy,kcy->krx", M, F_s[:, cols])
        col_side = torch.einsum("rcxy,krx->kcy", M, F_s[:, rows])  # Mᵀ·F
        if a == b:
            part[sab, :, rows] = row_side + col_side
        else:
            part[sab, :, rows] = row_side
            part[sba, :, cols] = col_side
    out = torch.zeros((k, t * TILE, 3), dtype=x.dtype)
    for a in range(t):
        rows = slice(a * TILE, (a + 1) * TILE)
        for s in range(w):
            if ctx.nbr[a, s] < 0:
                break
            out[:, rows] += part[s, :, rows]
    return out


def _walk_slice(ctx, F_s, wall, t0, nt):
    """What K3's row-tile slice computes, in plain PyTorch: each pair of the
    slice's work list once, a side written only where its tile lies in
    [t0, t0 + nt), into partials indexed from the slice's first row, then
    each slice tile's used slots summed in list order."""
    x, ci, live = ctx.x_s, ctx.ci_s, ctx.id_s >= 0
    t, w = ctx.nbr.shape
    k = F_s.shape[0]
    pairs, n_pairs, _ = tiles.slice_pairs(ctx.pairs, ctx.n_pairs, t0, nt)
    part = torch.full((w, k, nt * TILE, 3), float("nan"), dtype=x.dtype)
    lane = torch.arange(TILE)

    def local(tile):
        return slice((tile - t0) * TILE, (tile - t0 + 1) * TILE)

    for a, b, sab, sba in pairs[:int(n_pairs.item())].tolist():
        rows = slice(a * TILE, (a + 1) * TILE)
        cols = slice(b * TILE, (b + 1) * TILE)
        keep = (torch.all((ci[rows][:, None] - ci[cols][None]).abs() <= 1,
                          dim=-1)
                & live[rows][:, None] & live[cols][None, :])
        if a == b:
            keep &= lane[:, None] < lane[None, :]
        M = torch.where(keep[..., None, None],
                        _pair_blocks(x[rows], x[cols], wall), 0.0)
        row_side = torch.einsum("rcxy,kcy->krx", M, F_s[:, cols])
        col_side = torch.einsum("rcxy,krx->kcy", M, F_s[:, rows])
        if a == b:
            part[sab, :, local(a)] = row_side + col_side
            continue
        if t0 <= a < t0 + nt:
            part[sab, :, local(a)] = row_side
        if t0 <= b < t0 + nt:
            part[sba, :, local(b)] = col_side
    out = torch.zeros((k, nt * TILE, 3), dtype=x.dtype)
    for a in range(t0, t0 + nt):
        for s in range(w):
            if ctx.nbr[a, s] < 0:
                break
            out[:, local(a)] += part[s, :, local(a)]
    return out


@pytest.mark.parametrize("n_slices", [2, 4])
def test_slice_work_lists_cover_the_slices(ctxs, n_slices):
    """Each slice's list holds every pair with a tile in it once, in the
    full list's order; the slices' lists together hold each pair once, or
    twice where its tiles lie in two slices (the boundary count)."""
    ctx = ctxs[True]
    t = ctx.nbr.shape[0]
    nt = t // n_slices
    full = [tuple(p) for p in ctx.pairs[:int(ctx.n_pairs.item())].tolist()]
    seen = {}
    for d in range(n_slices):
        t0 = d * nt
        pairs, count, boundary = tiles.slice_pairs(
            ctx.pairs, ctx.n_pairs, t0, nt)
        got = [tuple(p) for p in pairs[:int(count.item())].tolist()]
        want = [p for p in full
                if t0 <= p[0] < t0 + nt or t0 <= p[1] < t0 + nt]
        assert got == want
        assert int(boundary.item()) == sum(
            (t0 <= p[0] < t0 + nt) != (t0 <= p[1] < t0 + nt) for p in got)
        for p in got:
            seen[p] = seen.get(p, 0) + 1
    assert set(seen) == set(full)
    twice = [p for p in full if p[0] // nt != p[1] // nt]
    assert all(seen[p] == (2 if p in twice else 1) for p in full)
    assert twice, "the slices should share some pairs"


@pytest.mark.parametrize("wall", [False, True])
def test_slice_walk_matches_plain_slices(ctxs, wall):
    """K3's slice walk at 4 slices gives the plain sweep's rows of each
    slice, and the slices together the whole sweep."""
    ctx = ctxs[wall]
    live = ctx.id_s >= 0
    t = ctx.nbr.shape[0]
    n_slices = 4
    nt = t // n_slices
    F = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, ctx.x_s.shape[0], 3)))
    full = farfield._near_sweep(ctx.x_s, ctx.ci_s, ctx.id_s, F, ctx.nbr,
                                wall, H_FLOOR)
    parts = []
    for d in range(n_slices):
        t0 = d * nt
        plain = farfield._near_sweep(ctx.x_s, ctx.ci_s, ctx.id_s, F, ctx.nbr,
                                     wall, H_FLOOR, t0=t0, nt=nt)
        walk = _walk_slice(ctx, F, wall, t0, nt)
        rows = live[t0 * TILE:(t0 + nt) * TILE]
        assert torch.isfinite(walk[:, rows]).all()
        rel = ((walk - plain)[:, rows].abs().max()
               / plain[:, rows].abs().max()).item()
        assert rel < WALK_TOL
        parts.append(plain)
    U = torch.cat(parts, dim=1)
    rel = ((U - full)[:, live].abs().max() / full[:, live].abs().max()).item()
    assert rel < WALK_TOL


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("wall", [False, True])
def test_tile_pair_walk_matches_plain_sweep(ctxs, wall, k):
    ctx = ctxs[wall]
    live = ctx.id_s >= 0
    F = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (k, ctx.x_s.shape[0], 3)))
    ref = farfield._near_sweep(ctx.x_s, ctx.ci_s, ctx.id_s, F, ctx.nbr, wall,
                               H_FLOOR)
    U = _walk_tile_pairs(ctx, F, wall)
    assert torch.isfinite(U[:, live]).all()
    rel = ((U - ref)[:, live].abs().max() / ref[:, live].abs().max()).item()
    assert rel < WALK_TOL


def test_pad_rows_sit_on_a_real_blob():
    """The ragged cloud's pad rows repeat the last real blob, so a pad row
    against its twin is at zero separation: only the live mask keeps that
    pair out of the walk (and of K3)."""
    c = CLOUDS["shell_N_12"]
    r, a = _suspension(c["shell"], c["n_bodies"], c["spacing"], seed=7)
    ctx = farfield.prepare(torch.from_numpy(r), a=a, wall=True,
                           grid=c["grid"], p=4)
    live = ctx.id_s >= 0
    n = r.shape[0]
    assert int((~live).sum()) == ctx.x_s.shape[0] - n > 0
    assert torch.equal(ctx.x_s[~live], ctx.x_s[n - 1].expand(
        ctx.x_s.shape[0] - n, 3))


@pytest.mark.parametrize("n", [1, 2, 127, 129, 515])
def test_k4_items_cover_each_unordered_pair_once(n):
    items = ewald_cuda.sweep_items(n)
    T = -(-n // TILE)
    assert items.shape == (T * (T + 1) // 2, 2)
    # the diagonal items lead, then the rest row-major
    assert (items[:T, 0] == np.arange(T)).all()
    assert (items[:T, 1] == np.arange(T)).all()
    rest = [tuple(p) for p in items[T:]]
    assert rest == sorted(rest) and all(i < j for i, j in rest)
    count = np.zeros((n, n), np.int64)
    idx = np.arange(n)
    for I, J in items:
        rows = idx[I * TILE:(I + 1) * TILE]
        cols = idx[J * TILE:(J + 1) * TILE]
        keep = rows[:, None] < cols[None, :]
        count[np.ix_(rows, cols)] += keep
    assert (count == np.triu(np.ones((n, n), np.int64), 1)).all()


@pytest.mark.parametrize("n", [1, 2, 127, 129, 515])
def test_k1_items_and_lanes_cover_each_unordered_pair_once(n):
    """K1's items are K4's, and a mirror of its per-thread loop (thread t
    owns row t of tile I, two columns a step, c and c + 32 of each 64-column
    half rotated by the lane, warps skipping the halves left of their rows
    on a diagonal item) keeps each pair i < j exactly once."""
    tile = rpy_cuda.TILE
    items = tiles.upper_tile_items(n, tile)
    assert np.array_equal(items, ewald_cuda.sweep_items(n))
    t = np.arange(tile)
    lane, warp = t % 32, t // 32
    count = np.zeros((n, n), np.int64)
    for I, J in items:
        diag = I == J
        n_cols = min(tile, n - J * tile)
        i = I * tile + t
        for q0 in (0, 64):
            for s in range(32):
                for p in range(2):
                    c = q0 + 32 * p + (lane + s) % 32
                    valid = (i < n) & (c < n_cols) & (~diag | (c > t))
                    valid &= ~(diag & (q0 + 64 <= 32 * warp))
                    np.add.at(count, (i[valid], J * tile + c[valid]), 1)
    assert (count == np.triu(np.ones((n, n), np.int64), 1)).all()


@pytest.mark.parametrize("n_rows, row_offset, n_cols, col_offset", [
    (1, 0, 1, 0), (2, 0, 2, 0), (70, 100, 515, 0), (129, 250, 300, 200),
    (300, 0, 257, 40)])
def test_k2_blocks_cover_each_ordered_pair_of_a_slab_once(
        n_rows, row_offset, n_cols, col_offset):
    """A mirror of K2's decomposition: blocks of 64 rows × 256 columns
    (``ordered_grid``), lane l owning rows l and l + 32, warp w sweeping
    columns [64w, 64w + 64) of its chunk.  Every (row, column) of the slab
    is visited once, and kept iff the global ids differ."""
    n_rb, n_ch = rpy_cuda.ordered_grid(n_rows, n_cols)
    rows_pb, chunk = rpy_cuda.ORD_ROWS, rpy_cuda.ORD_CHUNK
    per_warp = chunk // 4
    count = np.zeros((n_rows, n_cols), np.int64)
    kept = np.zeros((n_rows, n_cols), np.int64)
    for bx in range(n_rb):
        for by in range(n_ch):
            n_c = min(chunk, n_cols - by * chunk)
            for w in range(4):
                cols = np.arange(w * per_warp, min(n_c, (w + 1) * per_warp))
                for r in range(rows_pb // 32):
                    i = bx * rows_pb + 32 * r + np.arange(32)
                    i = i[i < n_rows]
                    j = by * chunk + cols
                    np.add.at(count, np.ix_(i, j), 1)
                    live = (row_offset + i)[:, None] != (col_offset + j)[None]
                    np.add.at(kept, np.ix_(i, j), live.astype(np.int64))
    assert (count == 1).all()
    gi = row_offset + np.arange(n_rows)
    gj = col_offset + np.arange(n_cols)
    assert (kept == (gi[:, None] != gj[None, :])).all()


@pytest.mark.parametrize("n_rows, row_offset, n_cols, col_offset", [
    (1, 0, 1, 0), (5, 0, 29, 0), (128, 0, 128, 0), (269, 113, 113, 0),
    (93, 713, 113, 700), (300, 0, 257, 40), (33, 0, 31, 0),
    (129, 0, 33, 0), (127, 1, 65, 0), (256, 64, 96, 0), (40, 0, 200, 10),
    (2, 5, 300, 0)])
def test_k4_slab_blocks_cover_each_ordered_pair_once(
        n_rows, row_offset, n_cols, col_offset):
    """A mirror of K4's slab form: blocks of SLAB_ROWS rows × SLAB_CHUNK
    columns (ewald_cuda.slab_partial_shape counts the chunks), lane l
    owning rows l, l + 32, l + 64, l + 96 of its block, warp w sweeping
    columns w, w + 4, … of its chunk.  Every (row, column) of the slab is
    visited once, and kept iff the global ids differ."""
    rows_pb, chunk = ewald_cuda.SLAB_ROWS, ewald_cuda.SLAB_CHUNK
    n_ch = ewald_cuda.slab_partial_shape(n_rows, n_cols, 1)[0]
    count = np.zeros((n_rows, n_cols), np.int64)
    kept = np.zeros((n_rows, n_cols), np.int64)
    for bx in range(-(-n_rows // rows_pb)):
        for by in range(n_ch):
            n_c = min(chunk, n_cols - by * chunk)
            for w in range(4):
                j = by * chunk + np.arange(w, n_c, 4)
                for r in range(rows_pb // 32):
                    i = bx * rows_pb + 32 * r + np.arange(32)
                    i = i[i < n_rows]
                    np.add.at(count, np.ix_(i, j), 1)
                    live = (row_offset + i)[:, None] != (col_offset + j)[None]
                    np.add.at(kept, np.ix_(i, j), live.astype(np.int64))
    assert (count == 1).all()
    gi = row_offset + np.arange(n_rows)
    gj = col_offset + np.arange(n_cols)
    assert (kept == (gi[:, None] != gj[None, :])).all()


@pytest.mark.parametrize("n_rows, n_cols, blocks", [
    (2568, 2568, 21 * 81),       # the D = 4 ring's block
    (5136, 5136, 41 * 161),      # the D = 2 ring's
    (2568, 10272, 21 * 321),     # the gather's
    (10272, 10272, 81 * 321),    # one rank's n × n
    (10, 3, 1), (1, 1, 1)])
def test_k4_slab_grid_and_scratch(n_rows, n_cols, blocks):
    """The slab form's grid of 128 × 32 blocks at the ring's, the gather's
    and one rank's shapes of the periodic slice's 10,272 blobs (the D = 4
    ring's 1,701 blocks, 12.9 an SM of an H100's 132), and its scratch, one
    partial a chunk, at 1 and 2 RHS."""
    assert (ewald_cuda.SLAB_ROWS, ewald_cuda.SLAB_CHUNK) == (128, 32)
    n_ch = -(-n_cols // ewald_cuda.SLAB_CHUNK)
    assert -(-n_rows // ewald_cuda.SLAB_ROWS) * n_ch == blocks
    for k in (1, 2):
        assert ewald_cuda.slab_partial_shape(n_rows, n_cols, k) == (
            n_ch, k, n_rows, 3)
    assert ewald_cuda.slab_partial_shape(n_rows, 0, 1) == (1, 1, n_rows, 3)


# (n, max_groups): one item a unit (G = T) up to 2·max_groups tiles, then
# G = max_groups groups of ⌊T/G⌋ or ⌈T/G⌉ tiles (tiles.sweep_groups): 515
# blobs in 5 tiles as 2 + 3, 1,000 in 8 as 2 + 3 + 3, 1,200 in 10 as 2 + 3
# + 2 + 3, 2,049 in 17 as 7·2 + 3 (as 65,664 blobs in 513 tiles: 255·2 +
# 3) and as 4 + 4 + 4 + 5
GROUPINGS = [(1, 128), (129, 128), (515, 128), (515, 2), (1000, 3),
             (1200, 4), (2049, 8), (2049, 4), (2049, 17)]
# walks only (no partials): the kernels' first grouped size
WALKS = GROUPINGS + [(65_664, tiles.MAX_GROUPS)]


def _starts(T, G):
    return [tiles.group_start(p, T, G) for p in range(G + 1)]


@pytest.mark.parametrize("n, max_groups", WALKS)
def test_group_walks_cover_each_unordered_tile_pair_once(n, max_groups):
    """K1's and K4's blocks (one unit of group pairs each, walked row by
    row) visit every tile pair (I, J ≥ I) exactly once, the items of a row
    of a unit one after another, and a column slot first at its unit's
    first row (where the kernels write it before they add to it)."""
    T, S, G, U = tiles.sweep_groups(n, TILE, max_groups)
    starts = _starts(T, G)
    sizes = np.diff(starts)
    assert G == (T if T <= 2 * max_groups else max_groups)
    assert starts[0] == 0 and starts[-1] == T
    assert sizes.min() >= 1 and sizes.max() == S
    assert sizes.max() - sizes.min() <= 1
    walk = tiles.group_items(n, TILE, max_groups)
    pairs = [tuple(p) for p in walk[:, 1:].tolist()]
    assert sorted(pairs) == [(I, J) for I in range(T) for J in range(I, T)]
    units = tiles.upper_tile_items(G * TILE, TILE)
    assert set(walk[:, 0].tolist()) == set(range(U))
    assert (np.diff(walk[:, 0]) >= 0).all()          # launch order
    seen_col = set()
    for u, I, J in walk.tolist():
        P, Q = units[u]
        assert starts[P] <= I < starts[P + 1]
        assert starts[Q] <= J < starts[Q + 1]
        if (u, J) not in seen_col:
            assert I == starts[P]
            seen_col.add((u, J))
    # row by row: I never falls within a unit
    assert ((np.diff(walk[:, 0]) > 0) | (np.diff(walk[:, 1]) >= 0)).all()


@pytest.mark.parametrize("n, max_groups", GROUPINGS)
@pytest.mark.parametrize("wall", [True, False])
def test_group_partials_and_second_pass_give_the_pair_sum(n, max_groups,
                                                          wall):
    """A float64 mirror of K1's blocks and second pass: each item adds its
    M_IJ·F_J into its unit's row slot of tile I and M_IJᵀ·F_I into its
    column slot of tile J (diagonal items: j > i only); the second pass
    adds a tile's slots in ``tiles.sum_order``.  The result is the plain
    pair sum, and every slot a tile reads was written."""
    rng = np.random.default_rng(n + max_groups)
    r = torch.from_numpy(rng.uniform([-6, -6, 0.8], [6, 6, 6], (n, 3)))
    F = torch.from_numpy(rng.standard_normal((n, 3)))
    M = rpy.mobility_matrix(r, 1.0, 1.0, wall, h_floor=H_FLOOR).reshape(
        n, 3, n, 3) * (8.0 * np.pi)
    T, S, G, U = tiles.sweep_groups(n, TILE, max_groups)
    starts = _starts(T, G)
    units = tiles.upper_tile_items(G * TILE, TILE)
    row_slot, col_slot = {}, {}
    for u, I, J in tiles.group_items(n, TILE, max_groups).tolist():
        i = torch.arange(I * TILE, min(I * TILE + TILE, n))
        j = torch.arange(J * TILE, min(J * TILE + TILE, n))
        keep = (i[:, None] < j[None, :]).double()
        Mb = M[i][:, :, j] * keep[:, None, :, None]          # (i, 3, j, 3)
        P, Q = units[u]
        rk, ck = (u, I - starts[P]), (u, J - starts[Q])
        assert rk[1] < S and ck[1] < S
        row_slot[rk] = row_slot.get(rk, 0) + torch.einsum(
            "iajb,jb->ia", Mb, F[j])
        col_slot[ck] = col_slot.get(ck, 0) + torch.einsum(
            "iajb,ia->jb", Mb, F[i])
    out = torch.zeros((n, 3), dtype=torch.float64)
    for X, (rows, cols) in enumerate(tiles.sum_order(n, TILE, max_groups)):
        x = slice(X * TILE, min(X * TILE + TILE, n))
        for key in rows:
            out[x] += row_slot[key]
        for key in cols:
            out[x] += col_slot[key]
    ids = torch.arange(n)
    ref = rpy.pair_sum(r, ids, r, ids, F, wall=wall, h_floor=H_FLOOR)
    assert (out - ref).abs().max() <= WALK_TOL * ref.abs().max()


def test_sweep_scratch_grows_as_n():
    """K1's and K4's partials, sized on the host without allocating: at
    most 2·(MAX_GROUPS + 1)·3k·(n + 128) floats for every n up to 1M; the
    old T(T+1)·128·3k while a unit is one item (up to 2·MAX_GROUPS tiles),
    less past it; 2.63 GB at 409,600 blobs and 2 RHS, the JAX package's
    measured size (one partial an item: 31.5 GB)."""
    ns = np.unique(np.concatenate([
        np.geomspace(1, 1_000_000, 600).astype(int),
        [127, 128, 129, 10_272, 16_384, 16_385, 65_536, 65_537, 65_664,
         102_480, 409_600, 1_000_000]]))
    c = 2 * (tiles.MAX_GROUPS + 1)
    for n in ns.tolist():
        T = -(-n // TILE)
        for k in (1, 2):
            floats = 2 * int(np.prod(tiles.partial_shape(n, k, TILE)))
            assert floats <= c * 3 * k * (n + TILE), (n, k, floats)
            old = T * (T + 1) * TILE * 3 * k
            if T <= 2 * tiles.MAX_GROUPS:
                assert floats == old
            else:
                assert floats < old
    assert 2 * 4 * int(np.prod(tiles.partial_shape(409_600, 2))) < 2.7e9
