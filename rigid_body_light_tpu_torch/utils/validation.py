"""State validation — the port of ``rigid_body_light_tpu/utils/validation.py``.

The reference handles invalid states by killing the host process from
library code (blob overlap → ``exit(EXIT_FAILURE)``, ``c_rigid_obj.cpp:53-58``;
singular KᵀK → ``:313-316``) or throwing mid-assembly (below-wall,
``:95-97``).  Here validation is split:

  - :func:`diagnose` — scalar diagnostics on the positions' device (min
    blob separation, below-wall count, worst quaternion norm error),
    without materializing the O(N²) distance matrix;
  - :func:`assert_valid` — host-side; raises RuntimeError with the
    reference-compatible messages;
  - :func:`check_box_geometry` — a periodic box too small for the body.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rigid_body_light_tpu_torch.ops import rpy


class StateDiagnostics(NamedTuple):
    min_separation: torch.Tensor   # smallest blob-blob distance (units of a)
    n_below_wall: torch.Tensor     # blobs with z < 0
    max_quat_err: torch.Tensor     # max | |q| − 1 |


def diagnose(positions, Q, a=1.0, row_tile=512, box=None) -> StateDiagnostics:
    """Compute state diagnostics in O(row_tile·N) memory.

    The min separation is taken over row tiles of ``row_tile`` blobs
    against all blobs, each blob's own pair masked out; the last tile is
    as short as the blobs left (no padded rows).  box: optional (Lx, Ly)
    or (Lx, Ly, Lz) in the positions' units — separations are measured
    through the minimum image the mobility uses
    (:func:`.rpy.wrapped_difference`), so blobs coincident modulo the box
    are caught.  A pair exactly at ±L/2 on an axis has the same distance
    through either image, so the float32 wrap rule at a seam (ROADMAP.md
    queue 3 item 4), which may pick the other image than the JAX package,
    cannot change ``min_separation``.
    """
    r = positions.reshape(-1, 3)
    n = r.shape[0]
    dtype = r.dtype
    big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=r.device)
    tile = min(row_tile, n)
    cols = torch.arange(n, device=r.device)
    mins = []
    for start in range(0, n, tile):
        ri = r[start:start + tile]
        d = rpy.wrapped_difference(ri[:, None, :], r[None, :, :], box)
        dist2 = torch.sum(d * d, dim=-1)
        self_mask = (start + torch.arange(ri.shape[0], device=r.device)
                     )[:, None] == cols[None, :]
        mins.append(torch.min(torch.where(self_mask, big, dist2)))
    min_d2 = torch.min(torch.stack(mins))
    min_sep = torch.sqrt(min_d2) * (1.0 / a)
    n_below = torch.sum((r[:, 2] < 0.0).to(torch.int32))
    qerr = torch.max(torch.abs(torch.linalg.norm(Q, dim=-1) - 1.0))
    return StateDiagnostics(min_separation=min_sep, n_below_wall=n_below,
                            max_quat_err=qerr)


def assert_valid(diag: StateDiagnostics, wall: bool = False,
                 min_separation: float = 1e-6) -> None:
    """Host-side check of diagnostics; raises the reference's error contract."""
    if float(diag.min_separation) < min_separation:
        raise RuntimeError(
            f"TWO BLOBS ARE OVERLAPPING OR TOO CLOSELY POSITIONED "
            f"(min separation {float(diag.min_separation):.3e} a)"
        )
    if wall and int(diag.n_below_wall) > 0:
        raise RuntimeError(
            "A blob has its center below the wall (z<0). Cannot compute "
            "mobility- check your configuration."
        )
    if float(diag.max_quat_err) > 1e-3:
        raise RuntimeError(
            f"Quaternions have drifted from unit norm (max err "
            f"{float(diag.max_quat_err):.3e})"
        )


def check_box_geometry(box, ref_cfg, a) -> None:
    """Raise if a periodic box is too small for the body geometry.

    Correctness bound of the minimum-image wrap: intra-body blob pair
    displacements must never wrap, i.e. body diameter (max blob-center
    distance + 2a) < min(L)/2.  Otherwise the wrapped mobility is
    inconsistent with the (unwrapped) rigid constraint geometry K and the
    saddle solve silently returns garbage.  Eager numpy, run once when a
    trajectory is set up.  ref_cfg: (n, 3) numpy array of reference blob
    positions.
    """
    if box is None:
        return
    r = np.asarray(ref_cfg).reshape(-1, 3)
    diam = 2.0 * float(a)
    if len(r) > 1:
        diam += float(
            np.sqrt(((r[:, None, :] - r[None, :, :]) ** 2).sum(-1)).max())
    if diam >= min(box) / 2.0:
        raise ValueError(
            f"periodic box {tuple(box)} is too small for this body geometry: "
            f"body diameter {diam:.3f} must be < min(Lx, Ly)/2 = "
            f"{min(box) / 2.0:.3f}, or intra-body pair displacements wrap "
            "and the mobility becomes inconsistent with the rigid "
            "constraints")
