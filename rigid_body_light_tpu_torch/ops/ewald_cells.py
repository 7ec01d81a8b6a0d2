"""Sorted-tile neighbor sweep for the balanced-split Ewald real part — the
port of ``rigid_body_light_tpu/ops/ewald_cells.py`` (one device, or this
rank's slice of the tiles over a process group).

With ``ewald.make_params(..., rc=...)`` the real-space scalars truncate at
a cutoff rc < min(L)/2, so the all-pairs sweep is wasted work.  This
module sweeps only blob pairs that can be within rc, at O(N·ρ·rc³) cost:

fold into the box → serpentine equal-population tiles of
:data:`tiles.TILE` blobs → bounding-box adjacency at radius rc (minimum
image) → per-row-tile padded neighbor lists → the exact pair fields
against the neighbor tiles' blobs, with the scalars and masks of the
all-pairs sweep (:func:`.ewald.real_space_apply`), pairs beyond rc
excluded.

Each chunk of row tiles lists the candidate pairs of its live (row tile,
neighbor tile) entries only — a padded list slot costs nothing — keeps
those within rc (not the pad columns, not the self pair), evaluates A and
B on the kept pairs only and sums each row's terms in column order by a
segmented reduction, so a row's sum does not depend on how rows are
chunked.
float32 sweeps the tiles through the hand-written kernel "K4 tiles"
(:func:`.ewald_cuda.tile_pair_sum`: on the card the kernel, on the CPU
:func:`_cell_sweep`, its plain twin); ``use_kernel=False`` keeps the plain
sweep on the card (the configuration's ``use_pallas=False``), and float64
always takes it (the closed forms, not the fits).
A neighbor-list overflow cannot be repaired inside the apply, so it is
loud: the velocities are NaN-poisoned by a select on a device flag (no
host sync), the stepper's validity guards catch it, and the width is
raised with ``SimulationConfig.ewald_nbr_tiles``.
"""

from __future__ import annotations

import numpy as np
import torch

from rigid_body_light_tpu_torch.ops import ewald, ewald_cuda, tiles
from rigid_body_light_tpu_torch.utils import collectives, profiling

TILE = tiles.TILE
# candidate pairs (live tile pairs × TILE²) one chunk of row tiles holds:
# about 0.2 GB a float32 field, a few GB of temporaries on the card
CHUNK_PAIRS = 2 ** 24


def default_max_nbr(n: int, params: ewald.EwaldParams) -> int:
    return tiles.default_max_nbr(n, float(np.prod(params.box)), params.rc)


def _fold(r, params: ewald.EwaldParams):
    L = torch.as_tensor(params.box, dtype=r.dtype, device=r.device)
    return r - L * torch.floor(r / L)


def real_space_apply_cells(F, r, params: ewald.EwaldParams, max_nbr=None,
                           radii=None, poly_tables=None, chunk_tiles=None,
                           group=None, use_kernel=True):
    """U_real = Σ_{j≠i, r_ij ≤ rc} [A·I + B·r̂r̂]·F_j over sorted tiles.

    F: (N, 3) or (k, N, 3).  Returns U shaped like F, NaN-poisoned on a
    neighbor-list overflow (see the module docstring).  radii: (N,)
    per-blob radii, the exact polydisperse scalars of the all-pairs sweep
    (float32: the species-pair fits of ``poly_tables``, built from the
    radii when not given; float64: the shifted closed forms).
    chunk_tiles: row tiles a chunk of the plain sweep holds (default: as
    many as hold :data:`CHUNK_PAIRS` candidate pairs); it groups rows only
    and changes no result.  use_kernel: float32 through K4 tiles
    (:func:`.ewald_cuda.tile_pair_sum`, 2 RHS a launch), else the plain
    :func:`_cell_sweep` on any device.

    group: None (one device), or a process group (the JAX package's
    ``real_space_apply_cells_local``): F, r and radii are this rank's
    blobs, every rank holding as many, in rank order, and U this rank's
    rows.  The folded positions, the forces and the radii are gathered
    once, every rank builds the same sorted tiles (:func:`sorted_tiles`,
    their count padded to a multiple of the ranks), sweeps its equal slice
    of the row tiles and the slices are gathered back.  float32 radii need
    ``poly_tables`` built from the global radii.
    """
    if params.rc is None:
        raise ValueError("tile sweep needs params built with rc= "
                         "(balanced splitting)")
    dtype, dev = r.dtype, r.device
    multi = F.dim() == 3
    Fs = (F if multi else F[None]).to(dtype)
    D, rank = collectives.size(group), collectives.rank(group)
    k, n_l = Fs.shape[0], r.shape[0]
    n = n_l * D
    if max_nbr is None:
        max_nbr = default_max_nbr(n, params)
    if radii is not None and dtype == torch.float32 and poly_tables is None:
        if group is not None:
            raise ValueError("the distributed float32 polydisperse tile "
                             "sweep needs poly_tables=make_poly_tables("
                             "params, radii) built from the global radii")
        poly_tables = ewald.make_poly_tables(params, radii)
    rad_all = None
    if radii is not None:
        rad_all = collectives.all_gather(
            torch.as_tensor(radii, dtype=dtype, device=dev), group)
    with profiling.span("ewald_tiles"):
        order, r_pad, ids_pad, F_pad, pp, nbr, overflow = sorted_tiles(
            collectives.all_gather(_fold(r, params), group),
            collectives.all_gather(Fs, group, dim=1), params, max_nbr, D,
            radii=rad_all, poly_tables=poly_tables)
    nt = nbr.shape[0] // D
    if use_kernel and dtype == torch.float32:
        parts = [ewald_cuda.tile_pair_sum(
            r_pad, ids_pad, F_pad[c:c + 2], nbr, params, poly=pp,
            t0=rank * nt, nt=nt, chunk_tiles=chunk_tiles)
            for c in range(0, k, 2)]
        U_s = parts[0] if len(parts) == 1 else torch.cat(parts)
    else:
        U_s = _cell_sweep(r_pad, ids_pad, F_pad, nbr, params, poly=pp,
                          chunk_tiles=chunk_tiles, t0=rank * nt, nt=nt)
    U_sorted = collectives.all_gather(U_s, group, dim=1)[:, :n]
    U = torch.zeros((k, n, 3), dtype=dtype, device=dev)
    U[:, order] = U_sorted
    U = U[:, rank * n_l:(rank + 1) * n_l]
    U = torch.where(overflow, torch.full_like(U, float("nan")), U)
    return U if multi else U[0]


def sorted_tiles(rf, Fs, params: ewald.EwaldParams, max_nbr, n_ranks=1,
                 radii=None, poly_tables=None):
    """The sweep's sorted, padded structure of all the blobs: (order, r_pad,
    ids_pad, F_pad, poly, nbr, overflow).  rf (N, 3) folded positions, Fs
    (k, N, 3), radii (N,) or None.  The tile count is padded to a multiple
    of ``n_ranks`` by whole pad tiles; pad rows sit at the first sorted
    blob's folded position with id −1 (the pair mask drops them as
    columns, and their rows are cut off), and since the whole pad tiles
    neighbor each other and the tiles near that blob, the list width is
    widened by their count (an overflow there would poison the apply), as
    the JAX package's ``real_space_apply_cells_local`` does."""
    dtype, dev = rf.dtype, rf.device
    k, n = Fs.shape[0], rf.shape[0]
    order = tiles.serpentine_order(
        rf, tiles.column_width(n, float(np.prod(params.box))))
    t = -(-n // TILE)
    t_pad = -(-t // n_ranks) * n_ranks
    pad = t_pad * TILE - n
    max_nbr = min(t_pad, max_nbr + (t_pad - t))
    rf_s = rf[order]
    r_pad = torch.cat([rf_s, rf_s[:1].expand(pad, 3)])
    ids_pad = torch.cat([order, torch.full((pad,), -1, dtype=order.dtype,
                                           device=dev)])
    F_pad = torch.cat([Fs[:, order], torch.zeros((k, pad, 3), dtype=dtype,
                                                 device=dev)], dim=1)
    pp = _poly_pad(radii, poly_tables, order, pad, dtype)
    adj = tiles.bbox_adjacency(r_pad, t_pad, params.rc, box=params.box)
    nbr, overflow = tiles.pack_neighbor_lists(adj, max_nbr)
    return order, r_pad, ids_pad, F_pad, pp, nbr, overflow


def _poly_pad(radii, poly_tables, order, pad, dtype):
    """Sorted, padded polydisperse sidecar for :func:`_cell_sweep`: None
    (monodisperse) or ``(rad_pad, sidx_pad, poly_tables)`` in the sweep's
    order; pads carry radius 1 and species 0 and are masked either way."""
    if radii is None:
        return None
    dev = order.device
    rad_s = torch.as_tensor(radii, dtype=dtype, device=dev)[order]
    rad_pad = torch.cat([rad_s, torch.ones((pad,), dtype=dtype, device=dev)])
    sidx_pad = None
    if poly_tables is not None:
        sidx = ewald.poly_device_tables(poly_tables, dtype, dev)[0]
        sidx_pad = torch.cat([sidx[order],
                              torch.zeros((pad,), dtype=sidx.dtype,
                                          device=dev)])
    return rad_pad, sidx_pad, poly_tables


def _min_image(a, b, box):
    """a − b under the 3-D minimum image, a and b folded into the box: the
    image of :func:`.ewald._wrap3` (round((a − b)/L)), with the period
    taken off the coordinate past L/2 before the difference (exact there),
    so that a pair across the box's face is rounded once, at its own
    scale, and not at L's as a − b is — K4 tiles' ``min_image``.  float32
    loses several times more against float64 the other way where rigid
    bodies straddle the face."""
    L = torch.as_tensor(box, dtype=a.dtype, device=a.device)
    n = torch.round((a - b) / L)
    return torch.where(n > 0, (a - L) - b,
                       torch.where(n < 0, a - (b - L), a - b))


def _cell_sweep(r_pad, ids_pad, F_pad, nbr, params: ewald.EwaldParams,
                poly=None, chunk_tiles=None, t0=0, nt=None):
    """Cutoff pair sweep of the sorted row tiles [t0, t0 + nt) (default:
    every one) against their neighbor tiles.

    r_pad / ids_pad (t·TILE, …) folded, sorted, padded positions and blob
    ids (−1 for pads), F_pad (k, t·TILE, 3), nbr (t, M) neighbor-tile
    lists (−1 unused).  Returns (k, nt·TILE, 3) pair terms of the slice's
    rows in sorted order.  poly: ``(rad_pad, sidx_pad, poly_tables)`` from
    :func:`_poly_pad`.

    Only the live (row tile, neighbor tile) entries of ``nbr`` are swept,
    TILE × TILE candidate pairs each, in chunks of whole row tiles.  A pair
    is kept when its column is not a pad, it is not the self pair and
    r ≤ rc (:func:`_min_image`) — the all-pairs sweep's pair set; A and B
    are evaluated on kept
    pairs only, and each row's terms are summed in its list's column order
    by ``segment_reduce`` (no atomics: the sum repeats bitwise and does not
    depend on the chunking, nor on the slice).
    """
    dtype, dev = r_pad.dtype, r_pad.device
    t = nbr.shape[0]
    if nt is None:
        nt = t - t0
    k = F_pad.shape[0]
    cheb = dtype == torch.float32
    rt = r_pad.reshape(t, TILE, 3)
    it = ids_pad.reshape(t, TILE)
    F_rows = F_pad.transpose(0, 1).reshape(-1, 3 * k)   # (t·TILE, 3k)
    live = nbr[t0:t0 + nt] >= 0
    pair_I, slot = live.nonzero(as_tuple=True)    # row tile in the slice
    pair_J = nbr[t0 + pair_I, slot]
    pair_I = pair_I + t0
    offs = np.concatenate([[0], np.cumsum(live.sum(dim=1).cpu().numpy())])
    if chunk_tiles:
        bounds = list(range(0, nt, chunk_tiles)) + [nt]
    else:
        bounds = _chunk_bounds(offs, CHUNK_PAIRS // (TILE * TILE))
    outs = []
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        I = pair_I[offs[c0]:offs[c1]]
        J = pair_J[offs[c0]:offs[c1]]
        d = _min_image(rt[I][:, :, None], rt[J][:, None], params.box)
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[
            ..., 2]                                      # (P, TILE, TILE)
        cols_id = it[J][:, None, :]
        pair_ok = (cols_id >= 0) & (it[I][:, :, None] != cols_id)
        rr = torch.sqrt(torch.where(pair_ok, torch.clamp(r2, min=1e-24),
                                    torch.ones_like(r2)))
        p, i, j = (pair_ok & (rr <= params.rc)).nonzero(as_tuple=True)
        rows = (I[p] - t0 - c0) * TILE + i               # row in the chunk
        m = (c1 - c0) * TILE
        if p.numel() == 0:
            outs.append(torch.zeros((m, 3 * k), dtype=dtype, device=dev))
            continue
        # each row's terms together, in its list's (slot, lane) order
        order = torch.argsort(rows, stable=True)
        p, i, j, rows = p[order], i[order], j[order], rows[order]
        rr_k = rr[p, i, j]
        d_k = d[p, i, j]
        row_k = I[p] * TILE + i
        col_k = J[p] * TILE + j
        if poly is not None and poly[1] is not None:
            A, B = ewald.pair_scalars(rr_k, params, True, si=poly[1][row_k],
                                      sj=poly[1][col_k], pt=poly[2])
        elif poly is not None:
            A, B = ewald.pair_scalars(rr_k, params, False, ai=poly[0][row_k],
                                      aj=poly[0][col_k])
        else:
            A, B = ewald.pair_scalars(rr_k, params, cheb)
        e = d_k / rr_k[:, None]                          # (P, 3)
        Fj = F_rows[col_k].reshape(-1, k, 3)             # (P, k, 3)
        eF = (e[:, None, 0] * Fj[..., 0] + e[:, None, 1] * Fj[..., 1]
              + e[:, None, 2] * Fj[..., 2])              # (P, k)
        terms = (A[:, None, None] * Fj
                 + (B[:, None] * eF)[..., None] * e[:, None, :])
        outs.append(torch.segment_reduce(
            terms.reshape(-1, 3 * k), "sum", axis=0, unsafe=True,
            lengths=torch.bincount(rows, minlength=m)))
    return torch.cat(outs).reshape(nt * TILE, k, 3).transpose(0, 1)


def _chunk_bounds(offs, budget):
    """Row-tile bounds [b₀ = 0, b₁, …, t] of chunks holding at most
    ``budget`` live tile pairs each (at least one row tile), from the
    cumulative live-pair offsets ``offs`` (t + 1,)."""
    bounds = [0]
    t = len(offs) - 1
    while bounds[-1] < t:
        b = int(np.searchsorted(offs, offs[bounds[-1]] + budget,
                                side="right")) - 1
        bounds.append(min(t, max(b, bounds[-1] + 1)))
    return bounds


def neighbor_width(r, params: ewald.EwaldParams) -> int:
    """The most neighbor tiles any row tile has at positions ``r``: the
    smallest ``max_nbr`` (``SimulationConfig.ewald_nbr_tiles``) with which
    the sweep does not overflow there.  Rigid bodies on a lattice can need
    far more than :func:`default_max_nbr`'s uniform-density estimate: a
    tile whose column clips two bodies spans the gap between them."""
    n = r.shape[0]
    rf = _fold(r, params)
    order = tiles.serpentine_order(
        rf, tiles.column_width(n, float(np.prod(params.box))))
    t = -(-n // TILE)
    rf_s = rf[order]
    r_pad = torch.cat([rf_s, rf_s[:1].expand(t * TILE - n, 3)])
    adj = tiles.bbox_adjacency(r_pad, t, params.rc, box=params.box)
    return int(adj.sum(dim=1).max())
