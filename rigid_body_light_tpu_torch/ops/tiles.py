"""Equal-population spatial tiles — the port of
``rigid_body_light_tpu/ops/tiles.py`` — the work items, blocks and
partials of the symmetric all-pairs sweeps (K1, K4; the Python mirror of
``csrc/tile_items.cuh``) and the unordered tile-pair lists of the
symmetric neighbor-tile sweeps (K3, K4 tiles: :func:`tile_pairs`,
:func:`slice_pairs`).

The far field's near sweep (:mod:`rigid_body_light_tpu_torch.ops.farfield`)
partitions pairs by cell adjacency; sorting blobs along a serpentine walk
over the cell lattice keeps every run of ``farfield.TILE`` blobs inside a
few consecutive, face-adjacent cells, so the per-tile neighbor lists stay
narrow.

The balanced-split Ewald sweep (:mod:`.ewald_cells`) sorts blobs by a 3-D
serpentine column order (:func:`serpentine_order`) so that every run of
:data:`TILE` = 32 consecutive blobs is spatially compact, then sweeps
each tile against a padded list of the tiles whose bounding boxes come
within the cutoff (:func:`bbox_adjacency`, :func:`pack_neighbor_lists`).
Tiles hold equal populations, not equal volumes: a rigid body's hundreds
of blobs in one place make spatially small tiles, not an overfull cell.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# blobs a tile of the balanced-split Ewald sweep holds, as in the JAX
# package; K1's and K4's work items are 128-blob tiles (their ``tile``
# arguments), K3's ``farfield_cuda.TILE``
TILE = 32


def column_width(n: int, volume_est: float) -> float:
    """Column side h ≈ (V·TILE/N)^{1/3}: cubes of ~TILE blobs at uniform
    density."""
    return max((volume_est * TILE / max(n, 1)) ** (1.0 / 3.0), 1e-6)


def serpentine_order(x, h):
    """Sorting permutation (N,) for tight equal-population tiles.

    x: (N, 3) positions (folded into the box for periodic domains); h: the
    column side.  Columns of side h in x and y, serpentine across columns,
    z sorted within each column in alternating directions.  Both sorts are
    stable, so the permutation is the JAX package's, integer for integer.
    """
    h = torch.as_tensor(h, dtype=x.dtype, device=x.device)
    lo = x.min(dim=0).values
    cx = ((x[:, 0] - lo[0]) / h).to(torch.int32)
    cy = ((x[:, 1] - lo[1]) / h).to(torch.int32)
    ymax = cy.max() + 1
    cy_s = torch.where(cx % 2 == 0, cy, ymax - 1 - cy)
    zdir = torch.where((cx + cy) % 2 == 0, 1.0, -1.0).to(x.dtype)
    o1 = torch.argsort(x[:, 2] * zdir, stable=True)
    col = cx.long() * (1 << 16) + cy_s
    return o1[torch.argsort(col[o1], stable=True)]


def cell_snake_order(ci, grid):
    """Sorting permutation (N,) following a serpentine walk over the cell
    lattice (x-major, y snaked per x-slab, z snaked per column).

    ci: (N, 3) integer cell indices in [0, grid); grid: (gx, gy, gz).
    The sort is stable, so ties keep their input order, as in the JAX
    package.
    """
    gx, gy, gz = grid
    cx, cy, cz = ci[:, 0], ci[:, 1], ci[:, 2]
    cy_s = torch.where(cx % 2 == 0, cy, gy - 1 - cy)
    colpos = cx * gy + cy_s
    cz_s = torch.where(colpos % 2 == 0, cz, gz - 1 - cz)
    return torch.argsort(colpos * gz + cz_s, stable=True)


def bbox_adjacency(r_pad, t, radius, box=None):
    """(t, t) bool: can any pair between two tiles be within ``radius``?

    Per-tile axis-aligned boxes; the distance is the centre delta less the
    summed half-extents, the delta wrapped by the minimum image when
    ``box`` is given (valid while extents stay below L/2).
    """
    rt = r_pad.reshape(t, TILE, 3)
    lo = rt.min(dim=1).values
    hi = rt.max(dim=1).values
    c = 0.5 * (lo + hi)
    e = 0.5 * (hi - lo)
    d = c[:, None, :] - c[None, :, :]
    if box is not None:
        L = torch.as_tensor(box, dtype=r_pad.dtype, device=r_pad.device)
        d = d - L * torch.round(d / L)
    gap = torch.clamp(d.abs() - (e[:, None, :] + e[None, :, :]), min=0.0)
    return torch.sum(gap * gap, dim=-1) <= torch.as_tensor(
        radius, dtype=r_pad.dtype) ** 2


def pack_neighbor_lists(adj, max_nbr):
    """Pack each row's adjacent tile ids into (t, max_nbr), −1 unused.

    Returns (nbr, overflow): ``overflow`` is a bool tensor, true when some
    row has more than ``max_nbr`` adjacent tiles; the caller poisons its
    output with it (a silently truncated list would be wrong physics).
    """
    t = adj.shape[0]
    cols = torch.arange(t, device=adj.device)
    key = torch.where(adj, cols, t + cols)
    packed = torch.sort(key, dim=1).values[:, :max_nbr]
    overflow = torch.any(adj.sum(dim=1) > max_nbr)
    return torch.where(packed < t, packed, -1), overflow


def _keep_first(rows, keep):
    """rows with the rows where ``keep`` holds first, each part in its
    order (a stable partition by a prefix sum: no sort, no host sync)."""
    n = keep.shape[0]
    if n == 0:
        return rows.contiguous()
    c = torch.cumsum(keep, 0)
    idx = torch.arange(n, device=keep.device)
    dest = torch.where(keep, c - 1, c[-1] + idx - c)
    return torch.empty_like(rows).index_copy_(0, dest, rows)


def tile_pairs(nbr):
    """The work list of the symmetric neighbor-tile sweeps (K3, K4 tiles):
    each unordered adjacent tile pair (a, b), b ≥ a, of the neighbor lists
    ``nbr`` (t, max_nbr; live ascending, then −1) once, in list order
    (a-major, then a's slots), as (t·max_nbr, 4) int32 rows (a, b, slot of
    b in a's list, slot of a in b's list) whose first ``n_pairs`` are used;
    n_pairs a (1,) int32 tensor.  Built on the device with no host sync.
    The lists are symmetric (:func:`bbox_adjacency`, K3's cell-range
    gaps), so the two slots point back at each other; after an overflow
    (the apply is NaN-poisoned) the rows stay in range but may miss
    pairs."""
    t, w = nbr.shape
    dev = nbr.device
    b = nbr.long()
    used = b >= 0
    b = b.clamp(min=0)
    a = torch.arange(t, device=dev)[:, None].expand(t, w)
    s = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(t, w)
    # slot_of[x, y]: the slot of y in x's list (column t takes empty slots)
    slot_of = torch.zeros((t, t + 1), dtype=torch.int32, device=dev)
    slot_of.scatter_(1, torch.where(used, b, t), s)
    upper = (used & (b >= a)).reshape(-1)
    rows = torch.stack([a.to(torch.int32), b.to(torch.int32), s,
                        slot_of[b, a]], dim=-1).reshape(-1, 4)
    return (_keep_first(rows, upper),
            upper.sum().to(torch.int32).reshape(1))


def slice_pairs(pairs, n_pairs, t0: int, nt: int):
    """The work list of a row-tile slice [t0, t0 + nt): the rows of the
    full list (``pairs``, ``n_pairs`` of :func:`tile_pairs`) with at least
    one tile in the slice, in list order, as (cap, 4) int32 rows whose
    first count are used, the count a (1,) int32 tensor, and the (1,)
    int32 count of those pairs with one tile outside the slice (the
    neighboring slice evaluates them too).  On the device, no host sync."""
    cap = pairs.shape[0]
    a, b = pairs[:, 0], pairs[:, 1]
    used = torch.arange(cap, device=pairs.device) < n_pairs
    a_in = (a >= t0) & (a < t0 + nt)
    b_in = (b >= t0) & (b < t0 + nt)
    keep = used & (a_in | b_in)
    return (_keep_first(pairs, keep),
            keep.sum().to(torch.int32).reshape(1),
            (used & (a_in ^ b_in)).sum().to(torch.int32).reshape(1))


def default_max_nbr(n: int, volume: float, radius: float) -> int:
    """Neighbor-list width: 2.2× the bounding-box ball estimate + 8, at
    most the tile count.  Tiles are cubes of side s = (V·TILE/N)^{1/3},
    adjacent within the cutoff plus about s; the margin covers the max /
    mean ratio of uniform clouds with room for clustering, and an overflow
    still poisons rather than truncates."""
    t = max(1, -(-n // TILE))
    s = (volume * TILE / max(n, 1)) ** (1.0 / 3.0)
    est = 4.19 * (radius + s) ** 3 / (volume / t)
    return int(min(t, math.ceil(2.2 * est) + 8))


def upper_tile_items(n, tile=128):
    """The work items of the symmetric all-pairs sweeps (K1 in
    ``csrc/rpy_pair_sweep.cu``, K4 in ``csrc/ewald_real_sweep.cu``) for n
    blobs in launch order, as (I, J) pairs of tiles of ``tile`` blobs: the
    T = ⌈n/tile⌉ diagonal pairs (I, I), then every (I, J > I) row-major —
    the order the kernels decode their block index by
    (``csrc/tile_items.cuh``) and their second pass sums in.
    (T(T+1)/2, 2) int64 numpy array."""
    T = -(-n // tile)
    diag = np.repeat(np.arange(T), 2).reshape(T, 2)
    return np.concatenate([diag, np.stack(np.triu_indices(T, 1), axis=1)])


# groups of tiles a grouped symmetric sweep launches over, past 2·MAX_GROUPS
# tiles (tile_items.cuh's kMaxGroups; the wrappers' build() checks it
# against the kernels')
MAX_GROUPS = 256


def sweep_groups(n, tile=128, max_groups=MAX_GROUPS):
    """How K1 and K4 cut n blobs: (T tiles, S slots a unit's partial holds,
    G groups, U units).  Up to 2·max_groups tiles every tile is a group (G
    = T, one item a unit); past it G = max_groups groups of consecutive
    tiles whose sizes differ by at most one (:func:`group_start`), S =
    ⌈T/G⌉ the largest.  A block walks one unit, a group pair (P, Q ≥ P), in
    the order of :func:`upper_tile_items` over the G groups."""
    T = -(-n // tile)
    G = T if T <= 2 * max_groups else max_groups
    S = -(-T // G) if G else 1
    return T, S, G, G * (G + 1) // 2


def group_start(p, T, G):
    """First tile of group p of T tiles in G groups (p = G: T)."""
    return p * T // G


def partial_shape(n, k, tile=128, max_groups=MAX_GROUPS):
    """Shape of each of K1's and K4's two partials (row and column) for n
    blobs and k RHS: S slots a unit, (U, S, 3k, tile) floats — O(n), below
    2·(max_groups + 1)·(n + tile)·3k floats for both."""
    _, S, _, U = sweep_groups(n, tile, max_groups)
    return (U, S, 3 * k, tile)


def group_items(n, tile=128, max_groups=MAX_GROUPS):
    """Every block's walk in launch order, as (unit, I, J) rows: unit u =
    (P, Q) takes I over group P and J over group Q, J ≥ I when P = Q, row by
    row.  (items, 3) int64 numpy array."""
    T, _, G, _ = sweep_groups(n, tile, max_groups)
    out = []
    for u, (P, Q) in enumerate(upper_tile_items(G * tile, tile)):
        for I in range(group_start(P, T, G), group_start(P + 1, T, G)):
            for J in range(I if P == Q else group_start(Q, T, G),
                           group_start(Q + 1, T, G)):
                out.append((u, I, J))
    return np.asarray(out, np.int64).reshape(-1, 3)


def sum_order(n, tile=128, max_groups=MAX_GROUPS):
    """The second pass's order for tile X of group P, slot x = X −
    group_start(P): [(unit, x) of the row partial, Q = P..G−1] and [(unit,
    x) of the column partial, P' = 0..P] — one list pair a tile."""
    T, _, G, _ = sweep_groups(n, tile, max_groups)
    units = {tuple(p): u for u, p in
             enumerate(upper_tile_items(G * tile, tile).tolist())}
    order = []
    for X in range(T):
        P = ((X + 1) * G - 1) // T        # tile_items.cuh's group_of
        x = X - group_start(P, T, G)
        order.append(([(units[(P, Q)], x) for Q in range(P, G)],
                      [(units[(P2, P)], x) for P2 in range(P + 1)]))
    return order
