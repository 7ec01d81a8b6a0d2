"""Plain RPY mobility rows above a no-slip wall (and in the open domain).

The blob-blob Rotne–Prager–Yamakawa tensor with its overlap branch, the
Swan–Brady finite-size wall correction at heights floored to ``h_floor``
(units of a) and the blob damping b = min(z/a, 1) of the reference
implementation (U = B·M·B·F), written from the published formulas
(Swan & Brady, Phys. Fluids 19, 113306 (2007); Rigid_Body_Light's
``mobilityUFSingleWallCorrection``) in the loop-free form of a row block
against every column.  Nothing here reads the program: positions are
worked out again from the bodies' (X, Q) and the structure file.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.arith import Arith


def load_shell(path: str):
    """Structure file → (blob radius a = sep/2, (n, 3) float64 offsets
    centered on their mean).  Format: two comment lines, the second
    ``# <sep>,<N>,<Rg>,<Rh>``, then N ``x y z`` rows."""
    with open(path) as f:
        f.readline()
        head = f.readline().strip().lstrip("#").split(",")
        sep, n = float(head[0]), int(head[1])
        ref = np.loadtxt(f)
    if ref.shape != (n, 3):
        raise ValueError(f"{path}: {n} blobs declared, {ref.shape} read")
    return sep / 2.0, ref - ref.mean(axis=0)


def rotation(Q: torch.Tensor) -> torch.Tensor:
    """(B, 4) scalar-first quaternions → (B, 3, 3), normalized first."""
    Q = Q / torch.linalg.norm(Q, dim=-1, keepdim=True)
    w, x, y, z = Q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def blob_positions(X, Q, ref, ar: Arith) -> torch.Tensor:
    """(B·n, 3) blob positions R(Q)·ref + X in ``ar``."""
    R = ar.op(rotation(ar.op(Q)))
    ref = ar.op(torch.as_tensor(ref, device=X.device))
    pos = torch.einsum("bij,kj->bki", R, ref) + ar.op(X)[:, None, :]
    return pos.reshape(-1, 3)


def _free_blocks(d, rr, a):
    """Free-space RPY as c1·I + c2·d dᵀ (units of 1/(8πηa)), d in units
    of a; the self pair (rr = 0) is the caller's."""
    safe = torch.where(rr > 0, rr, torch.ones_like(rr))
    far = safe >= 2.0
    c1 = torch.where(far, (1.0 + 2.0 / (3.0 * safe * safe)) / safe,
                     (4.0 / 3.0) * (1.0 - 0.28125 * safe))
    c2 = torch.where(far, (1.0 - 2.0 / (safe * safe)) / safe**3,
                     (4.0 / 3.0) * 0.09375 / safe)
    return c1, c2


def _wall_apply(d, hi, hj, Fj, ar: Arith):
    """Σ over the block of the Swan–Brady correction C(d, hᵢ, hⱼ)·Fⱼ for
    the non-self pairs (units of 1/(8πηa)).  d (R, N, 3) in units of a,
    hi (R, 1), hj (1, N) floored heights."""
    s = hi + hj
    h_hat = hj / s
    R = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + s * s)
    iR = 1.0 / R
    ex, ey, ez = d[..., 0] * iR, d[..., 1] * iR, s * iR
    iR3, iR5 = iR**3, iR**5
    ez2 = ez * ez
    hh = h_hat * (1.0 - h_hat)
    f1 = -(3.0 * (1.0 + 2.0 * hh * ez2) * iR
           + 2.0 * (1.0 - 3.0 * ez2) * iR3
           - 2.0 * (1.0 - 5.0 * ez2) * iR5) / 3.0
    f2 = -(3.0 * (1.0 - 6.0 * hh * ez2) * iR
           - 6.0 * (1.0 - 5.0 * ez2) * iR3
           + 10.0 * (1.0 - 7.0 * ez2) * iR5) / 3.0
    f3 = ez * (3.0 * h_hat * (1.0 - 6.0 * (1.0 - h_hat) * ez2) * iR
               - 6.0 * (1.0 - 5.0 * ez2) * iR3
               + 10.0 * (2.0 - 7.0 * ez2) * iR5) * 2.0 / 3.0
    f4 = ez * (3.0 * h_hat * iR - 10.0 * iR5) * 2.0 / 3.0
    f5 = -(3.0 * h_hat**2 * ez2 * iR + 3.0 * ez2 * iR3
           + (2.0 - 15.0 * ez2) * iR5) * 4.0 / 3.0
    f1, f2, f3, f4, f5 = (ar.op(f) for f in (f1, f2, f3, f4, f5))
    ex, ey, ez = ar.op(ex), ar.op(ey), ar.op(ez)
    Fx, Fy, Fz = Fj[..., 0], Fj[..., 1], Fj[..., 2]
    eF = ex * Fx + ey * Fy + ez * Fz
    ux = f1 * Fx + f2 * ex * eF + f3 * ex * Fz
    uy = f1 * Fy + f2 * ey * eF + f3 * ey * Fz
    uz = f1 * Fz + f2 * ez * eF + f3 * ez * Fz + f4 * eF + f5 * Fz
    return torch.stack([ux, uy, uz], dim=-1)


def _wall_self(h):
    """Self-pair wall correction diagonal (x, y, z) at floored height h."""
    iz = 1.0 / h
    iz3, iz5 = iz**3, iz**5
    par = -(9.0 * iz - 2.0 * iz3 + iz5) / 12.0
    perp = -(9.0 * iz - 4.0 * iz3 + iz5) / 6.0
    return torch.stack([par, par, perp], dim=-1)


def mobility_rows(rows, r, F, a, eta, wall, h_floor, ar: Arith,
                  row_block=128):
    """U at blobs ``rows`` (index tensor) of the blob mobility applied to
    F (N, 3) at positions r (N, 3): damped B·M·B·F iff ``wall``.  ``F``
    may be (k, N, 3); returns (k, len(rows), 3) then."""
    multi = F.dim() == 3
    Fs = F if multi else F[None]
    r = ar.op(r)
    Fs = ar.op(Fs)
    z = r[:, 2] / a
    if wall:
        if bool((z < 0).any()):
            raise RuntimeError("a blob lies below the wall")
        damp = torch.clamp(z, max=1.0)
        Fs = ar.op(Fs * damp[None, :, None])
        h = torch.clamp(z, min=h_floor)
    N = r.shape[0]
    cols = torch.arange(N, device=r.device)
    out = []
    for s in range(0, rows.numel(), row_block):
        idx = rows[s:s + row_block]
        d = ar.op((r[idx][:, None, :] - r[None, :, :]) / a)
        rr = torch.sqrt(torch.sum(d * d, dim=-1))
        selfp = idx[:, None] == cols[None, :]
        c1, c2 = _free_blocks(d, rr, a)
        c1 = ar.op(torch.where(selfp, torch.full_like(c1, 4.0 / 3.0), c1))
        c2 = ar.op(torch.where(selfp, torch.zeros_like(c2), c2))
        blk = []
        for Fk in Fs:
            u = (c1[..., None] * Fk[None]
                 + c2[..., None] * d * torch.sum(d * Fk[None], -1,
                                                  keepdim=True))
            if wall:
                cw = _wall_apply(d, h[idx][:, None], h[None, :], Fk[None],
                                 ar)
                u = u + torch.where(selfp[..., None], torch.zeros_like(cw),
                                    cw)
            u = u.sum(dim=1)
            if wall:
                u = u + ar.op(_wall_self(h[idx])) * Fk[idx]
                u = u * damp[idx][:, None]
            blk.append(u)
        out.append(torch.stack(blk))
    U = torch.cat(out, dim=1) / (8.0 * math.pi * eta * a)
    return U if multi else U[0]
