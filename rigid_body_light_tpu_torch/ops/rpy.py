"""Rotne–Prager–Yamakawa blob mobility, free space + Swan–Brady single wall —
the plain PyTorch port of ``rigid_body_light_tpu/ops/rpy.py``
(monodisperse, open domain).

It is the CPU path of the port and the plain version that the CUDA pair
sweeps (:mod:`rigid_body_light_tpu_torch.ops.rpy_cuda`) are checked against.
The pair mobility is M_ij = α(r)·I + β(r)·d⊗d, the wall correction
C_ij = f1·I + f2·e⊗e + f3·e⊗ẑ + f4·ẑ⊗e + f5·ẑ⊗ẑ; the matvec streams row
tiles so memory stays O(row_tile·N) and M is never formed.  Distances are
in units of the blob radius ``a``; outputs are scaled by 1/(8πηa).
"""

from __future__ import annotations

import math

import torch

_SELF_COEF = 4.0 / 3.0
# blob-height floor (units of a) for the wall correction — see the JAX
# rpy.WALL_H_FLOOR: below ~0.6a the raw Swan–Brady terms make the damped
# mobility indefinite
WALL_H_FLOOR = 0.75
# r² floor: overlapping distinct blobs give finite values instead of NaN
_R2_FLOOR = 1e-24


def _free_coeffs(r2):
    """Free-space RPY pair coefficients (α, β), M = α·I + β·d⊗d, with the
    far (r ≥ 2) and overlapping (r < 2) branches selected by a mask."""
    r2s = torch.clamp(r2, min=_R2_FLOOR)
    r = torch.sqrt(r2s)
    invr = 1.0 / r
    invr2 = 1.0 / r2s
    far = r >= 2.0
    alpha_far = (1.0 + (2.0 / 3.0) * invr2) * invr
    beta_far = (1.0 - 2.0 * invr2) * invr2 * invr
    alpha_near = _SELF_COEF * (1.0 - 0.28125 * r)
    beta_near = _SELF_COEF * 0.09375 * invr
    return (torch.where(far, alpha_far, alpha_near),
            torch.where(far, beta_far, beta_near))


def _wall_coeffs(d_img, hj):
    """Swan–Brady wall-correction coefficients (f1..f5, 1/|d_img|).

    d_img: (..., 3) displacement from the image of blob j to blob i, in
    units of a: (x_i−x_j, y_i−y_j, z_i+z_j).  hj: (...) source height.
    """
    rz = d_img[..., 2]
    h_hat = hj / torch.clamp(rz, min=1e-12)
    r2 = torch.sum(d_img * d_img, dim=-1)
    invR = torch.rsqrt(torch.clamp(r2, min=_R2_FLOOR))
    ez = rz * invR
    ez2 = ez * ez
    invR3 = invR * invR * invR
    invR5 = invR3 * invR * invR
    hh = h_hat * (1.0 - h_hat)
    f1 = -(3.0 * (1.0 + 2.0 * hh * ez2) * invR
           + 2.0 * (1.0 - 3.0 * ez2) * invR3
           - 2.0 * (1.0 - 5.0 * ez2) * invR5) / 3.0
    f2 = -(3.0 * (1.0 - 6.0 * hh * ez2) * invR
           - 6.0 * (1.0 - 5.0 * ez2) * invR3
           + 10.0 * (1.0 - 7.0 * ez2) * invR5) / 3.0
    f3 = ez * (3.0 * h_hat * (1.0 - 6.0 * (1.0 - h_hat) * ez2) * invR
               - 6.0 * (1.0 - 5.0 * ez2) * invR3
               + 10.0 * (2.0 - 7.0 * ez2) * invR5) * (2.0 / 3.0)
    f4 = ez * (3.0 * h_hat * invR - 10.0 * invR5) * (2.0 / 3.0)
    f5 = -(3.0 * h_hat * h_hat * ez2 * invR
           + 3.0 * ez2 * invR3
           + (2.0 - 15.0 * ez2) * invR5) * (4.0 / 3.0)
    return f1, f2, f3, f4, f5, invR


def wall_self_diag(z, a, h_floor=WALL_H_FLOOR):
    """Per-blob wall self-correction diagonal (N, 3), added to the 4/3 free
    self term; heights floored at ``h_floor``·a."""
    zn = z / a
    if h_floor > 0:
        zn = torch.clamp(zn, min=h_floor)
    invZ = 1.0 / zn
    invZ3 = invZ * invZ * invZ
    invZ5 = invZ3 * invZ * invZ
    cxx = -(9.0 * invZ - 2.0 * invZ3 + invZ5) / 12.0
    czz = -(9.0 * invZ - 4.0 * invZ3 + invZ5) / 6.0
    return torch.stack([cxx, cxx, czz], dim=-1)


def _self_diag(r, a, wall, h_floor):
    """(N, 3) self-mobility diagonal in units of 1/(8πηa)."""
    diag = torch.full(r.shape, _SELF_COEF, dtype=r.dtype, device=r.device)
    if wall:
        diag = diag + wall_self_diag(r[:, 2], a, h_floor=h_floor)
    return diag


def self_mobility_blocks(r, a=1.0, eta=1.0, wall=False, h_floor=WALL_H_FLOOR):
    """Per-blob 3×3 self mobility (N, 3, 3), scaled by 1/(8πηa)."""
    r = r.reshape(-1, 3)
    diag = _self_diag(r, a, wall, h_floor) / (8.0 * math.pi * eta * a)
    return torch.diag_embed(diag)


def damping_factors(r, a=1.0):
    """Wall-overlap damping d_i = clip(z_i/a, 0, 1), shape (N,)."""
    r = r.reshape(-1, 3)
    return torch.clamp(r[:, 2] / a, 0.0, 1.0)


def _pair_tile(ri, rj, row_ids, col_ids, Fk, inv_a, wall, h_floor):
    """Σ_j M_ij·F_j of all column blobs onto a tile of row blobs.

    ri (T, 3), rj (N, 3), Fk (k, N, 3) → (k, T, 3); pair terms only, self
    pairs (equal global ids) masked out by selects.
    """
    d = (ri[:, None, :] - rj[None, :, :]) * inv_a                 # (T, N, 3)
    keep = row_ids[:, None] != col_ids[None, :]
    r2 = torch.sum(d * d, dim=-1)
    r2 = torch.where(keep, r2, torch.full_like(r2, 4.0))
    alpha, beta = _free_coeffs(r2)
    zero = torch.zeros_like(alpha)
    alpha = torch.where(keep, alpha, zero)
    beta = torch.where(keep, beta, zero)
    dF = torch.einsum("tnx,knx->ktn", d, Fk)
    out = (torch.einsum("tn,knx->ktx", alpha, Fk)
           + torch.einsum("ktn,tn,tnx->ktx", dF, beta, d))
    if wall:
        zj = rj[None, :, 2] * inv_a
        zi = ri[:, None, 2] * inv_a
        if h_floor > 0:
            zj = torch.clamp(zj, min=h_floor)
            zi = torch.clamp(zi, min=h_floor)
        d_img = torch.cat([d[..., :2], (zi + zj).expand(d.shape[:2])[..., None]],
                          dim=-1)
        f1, f2, f3, f4, f5, invR = _wall_coeffs(d_img, zj.expand(d.shape[:2]))
        e = d_img * invR[..., None]
        f1, f2, f3, f4, f5 = (torch.where(keep, f, zero)
                              for f in (f1, f2, f3, f4, f5))
        eF = torch.einsum("tnx,knx->ktn", e, Fk)
        Fz = Fk[:, :, 2]
        out = out + torch.einsum("tn,knx->ktx", f1, Fk)
        out = out + torch.einsum("ktn,tn,tnx->ktx", eF, f2, e)
        out = out + torch.einsum("tn,kn,tnx->ktx", f3, Fz, e)
        z_part = (torch.einsum("tn,ktn->kt", f4, eF)
                  + torch.einsum("tn,kn->kt", f5, Fz))
        out = out + torch.stack(
            [torch.zeros_like(z_part), torch.zeros_like(z_part), z_part], dim=-1)
    return out


def pair_sum(r_rows, row_ids, r_cols, col_ids, F_cols, a=1.0, wall=False,
             row_tile=512, h_floor=WALL_H_FLOOR):
    """Σ_j M_ij·F_j over all column blobs, for a set of row blobs.

    Pair terms only — no self term, no 1/(8πηa), no damping.  r_rows (R, 3),
    r_cols (N, 3), F_cols (N, 3) or (k, N, 3); row_ids (R,) / col_ids (N,)
    global indices for self-pair masking (the ordered-slab contract of the
    kernels: a pair is skipped iff its two global ids are equal).
    """
    multi = F_cols.dim() == 3
    Fk = F_cols if multi else F_cols[None]
    inv_a = 1.0 / a
    outs = [
        _pair_tile(r_rows[s:s + row_tile], r_cols, row_ids[s:s + row_tile],
                   col_ids, Fk, inv_a, wall, h_floor)
        for s in range(0, r_rows.shape[0], row_tile)
    ]
    U = torch.cat(outs, dim=1)
    return U if multi else U[0]


def mobility_apply(F, r, a=1.0, eta=1.0, wall=False, damp=None, row_tile=512,
                   h_floor=WALL_H_FLOOR):
    """Matrix-free U = M(r)·F, or B·M·B·F when damped; (N, 3) → (N, 3).

    damp: None → damping iff ``wall`` (reference semantics).
    """
    r = r.reshape(-1, 3)
    return mobility_apply_multi(F.reshape(1, -1, 3), r, a, eta, wall, damp,
                                row_tile, h_floor)[0]


def mobility_apply_multi(Fs, r, a=1.0, eta=1.0, wall=False, damp=None,
                         row_tile=512, h_floor=WALL_H_FLOOR):
    """Multi-RHS U_k = M(r)·F_k, (k, N, 3) → (k, N, 3); the pair fields are
    shared across the RHS."""
    r = r.reshape(-1, 3)
    Fs = Fs.reshape(Fs.shape[0], -1, 3).to(r.dtype)
    use_damp = wall if damp is None else damp
    Fd = Fs
    if use_damp:
        b = damping_factors(r, a)
        Fd = Fs * b[None, :, None]
    ids = torch.arange(r.shape[0], device=r.device)
    U = pair_sum(r, ids, r, ids, Fd, a=a, wall=wall, row_tile=row_tile,
                 h_floor=h_floor)
    U = U + _self_diag(r, a, wall, h_floor)[None] * Fd
    U = U * (1.0 / (8.0 * math.pi * eta * a))
    if use_damp:
        U = U * b[None, :, None]
    return U


def mobility_matrix(r, a=1.0, eta=1.0, wall=False, h_floor=WALL_H_FLOOR):
    """Dense (3N, 3N) RPY mobility (undamped), every ordered pair evaluated
    directly (valid because C_ji = C_ijᵀ).  Small-N path: the PC and noise
    factor builds."""
    r = r.reshape(-1, 3)
    n = r.shape[0]
    dtype, dev = r.dtype, r.device
    inv_a = 1.0 / a
    d = (r[:, None, :] - r[None, :, :]) * inv_a                   # (N, N, 3)
    keep = ~torch.eye(n, dtype=torch.bool, device=dev)
    r2 = torch.sum(d * d, dim=-1)
    r2 = torch.where(keep, r2, torch.full_like(r2, 4.0))
    alpha, beta = _free_coeffs(r2)
    zero = torch.zeros_like(alpha)
    alpha = torch.where(keep, alpha, zero)
    beta = torch.where(keep, beta, zero)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    M = (alpha[:, :, None, None] * eye3
         + beta[:, :, None, None] * d[:, :, :, None] * d[:, :, None, :])
    if wall:
        zj = r[None, :, 2] * inv_a
        zi = r[:, None, 2] * inv_a
        if h_floor > 0:
            zj = torch.clamp(zj, min=h_floor)
            zi = torch.clamp(zi, min=h_floor)
        d_img = torch.cat([d[..., :2], (zi + zj)[..., None]], dim=-1)
        f1, f2, f3, f4, f5, invR = _wall_coeffs(d_img, zj.expand(n, n))
        e = d_img * invR[..., None]
        zhat = eye3[2]
        C = (f1[:, :, None, None] * eye3
             + f2[:, :, None, None] * e[:, :, :, None] * e[:, :, None, :]
             + f3[:, :, None, None] * e[:, :, :, None] * zhat[None, None, None, :]
             + f4[:, :, None, None] * zhat[None, None, :, None] * e[:, :, None, :]
             + f5[:, :, None, None] * zhat[None, None, :, None]
             * zhat[None, None, None, :])
        M = M + torch.where(keep[:, :, None, None], C, torch.zeros_like(C))
    self_blocks = torch.diag_embed(_self_diag(r, a, wall, h_floor))  # (N,3,3)
    M = M + keep.logical_not()[:, :, None, None] * self_blocks[:, None, :, :]
    M = M * (1.0 / (8.0 * math.pi * eta * a))
    return M.permute(0, 2, 1, 3).reshape(3 * n, 3 * n)


def cross_mobility_blocks(ri, rj, a=1.0, eta=1.0, wall=False,
                          h_floor=WALL_H_FLOOR, radii_i=None, radii_j=None):
    """Pair mobility blocks between two position sets, (..., P, Q, 3, 3).

    The physics and scale of :func:`mobility_matrix` (free-space RPY +
    Swan–Brady wall correction, 1/(8πηa)) for cross pairs of ``ri``
    (..., P, 3) and ``rj`` (..., Q, 3): no self branch (a coincident pair
    gets the r → 0 overlap limit) and no damping.  The RAS preconditioner's
    halo coupling blocks (:func:`.saddle.build_pc_ras`).  Per-blob radii
    raise: the polydisperse form comes with ROADMAP.md queue 1, item 12.
    """
    if radii_i is not None or radii_j is not None:
        raise NotImplementedError(
            "per-blob radii are not in the port's cross_mobility_blocks yet "
            "(ROADMAP.md queue 1, item 12 (polydisperse))")
    dtype, dev = ri.dtype, ri.device
    inv_a = 1.0 / a
    d = (ri[..., :, None, :] - rj[..., None, :, :]) * inv_a     # (..., P, Q, 3)
    alpha, beta = _free_coeffs(torch.sum(d * d, dim=-1))
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    M = (alpha[..., None, None] * eye3
         + beta[..., None, None] * d[..., :, None] * d[..., None, :])
    if wall:
        zi = ri[..., :, None, 2] * inv_a
        zj = rj[..., None, :, 2] * inv_a
        if h_floor > 0:
            zi = torch.clamp(zi, min=h_floor)
            zj = torch.clamp(zj, min=h_floor)
        zj = zj.expand(d.shape[:-1])
        d_img = torch.cat([d[..., :2], (zi + zj)[..., None]], dim=-1)
        f1, f2, f3, f4, f5, invR = _wall_coeffs(d_img, zj)
        e = d_img * invR[..., None]
        zhat = eye3[2]
        M = (M + f1[..., None, None] * eye3
             + f2[..., None, None] * e[..., :, None] * e[..., None, :]
             + f3[..., None, None] * e[..., :, None] * zhat
             + f4[..., None, None] * zhat[:, None] * e[..., None, :]
             + f5[..., None, None] * zhat[:, None] * zhat[None, :])
    return M * (1.0 / (8.0 * math.pi * eta * a))
