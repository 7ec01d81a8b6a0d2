"""Host-side configuration checks — the port of
``rigid_body_light_tpu/utils/validation.py::check_box_geometry``.  The
state diagnostics (``diagnose`` / ``assert_valid``) are not ported yet
(ROADMAP.md queue 1, item 14)."""

from __future__ import annotations

import numpy as np


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
            f"body diameter {diam:.3f} must be < min(L)/2 = "
            f"{min(box) / 2.0:.3f}, or intra-body pair displacements wrap "
            "and the mobility becomes inconsistent with the rigid "
            "constraints")
