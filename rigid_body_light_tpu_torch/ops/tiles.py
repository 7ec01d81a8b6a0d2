"""Cell-snake tile order — the port of ``cell_snake_order`` from
``rigid_body_light_tpu/ops/tiles.py`` — and the work items of the
symmetric all-pairs sweeps.

The far field's near sweep (:mod:`rigid_body_light_tpu_torch.ops.farfield`)
partitions pairs by cell adjacency; sorting blobs along a serpentine walk
over the cell lattice keeps every run of ``farfield.TILE`` blobs inside a
few consecutive, face-adjacent cells, so the per-tile neighbor lists stay
narrow.
"""

from __future__ import annotations

import numpy as np
import torch


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
