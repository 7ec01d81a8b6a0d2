"""Rotne–Prager–Yamakawa blob mobility, free space + Swan–Brady single wall —
the plain PyTorch port of ``rigid_body_light_tpu/ops/rpy.py`` (open domain
or the pseudo-2D (Lx, Ly) box, with its minimum-image wrap and the exact
doubly-periodic image sum; one blob radius, or per-blob radii: the
polydisperse RPY of Zuk et al. with the wall pair terms at the pair's
√(aᵢaⱼ)).

It is the CPU path of the port and the plain version that the CUDA pair
sweeps (:mod:`rigid_body_light_tpu_torch.ops.rpy_cuda`) are checked against.
The pair mobility is M_ij = α(r)·I + β(r)·d⊗d, the wall correction
C_ij = f1·I + f2·e⊗e + f3·e⊗ẑ + f4·ẑ⊗e + f5·ẑ⊗ẑ; the matvec streams row
tiles so memory stays O(row_tile·N) and M is never formed.  Distances are
in units of the blob radius ``a``; outputs are scaled by 1/(8πηa).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.utils.checkpoint

_SELF_COEF = 4.0 / 3.0
# blob-height floor (units of a) for the wall correction — see the JAX
# rpy.WALL_H_FLOOR: below ~0.6a the raw Swan–Brady terms make the damped
# mobility indefinite
WALL_H_FLOOR = 0.75
# r² floor: overlapping distinct blobs give finite values instead of NaN
_R2_FLOOR = 1e-24


def _displacement(ri, rj, box_n):
    """r_i − r_j, (T, 3) × (N, 3) → (T, N, 3), positions in units of a;
    with a box (None, (Lx, Ly) or (Lx, Ly, Lz) in units of a), x and y
    (and z for a 3-D box) wrapped to the minimum image.

    The image is that of the exact difference: n = round((r_i − r_j)/L)
    half to even (a pair at exactly ±L/2 stays, as ``jnp.round`` leaves
    it), the quotient in float64 with L in the positions' precision, and
    d − n·L rounded once.  In float64 this is the JAX package's wrap; in
    float32 it is the kernels' (``csrc/rpy_fields.cuh::wrap``), so the
    plain float32 sweep and the kernels take the same image of a pair
    that lies within rounding of a seam (the operator jumps there, and
    the RFD drift's 1/δ multiplies the jump).
    """
    return wrapped_difference(ri[:, None, :], rj[None, :, :], box_n)


def wrapped_difference(xi, xj, box_n):
    """xi − xj for broadcastable (..., 3) positions in units of a, wrapped
    by :func:`_displacement`'s rule (the near sweep's pairs, the K3 box
    form's twin)."""
    d = xi - xj
    if box_n is None:
        return d
    if any(b <= 0 for b in box_n):
        raise ValueError(f"periodic box lengths must be positive, got {box_n}")
    comps = list(d.unbind(-1))
    for ax, L in enumerate(box_n):
        L = torch.tensor(L, dtype=d.dtype).item()
        exact = xi[..., ax].double() - xj[..., ax].double()
        n = torch.round(exact / L)
        comps[ax] = (comps[ax].double() - L * n).to(d.dtype)
    return torch.stack(comps, dim=-1)


def _box_n(box, a):
    return None if box is None else tuple(float(b) / a for b in box)


def _check_images(box_n, image_shells):
    if image_shells and (box_n is None or len(box_n) != 2):
        raise ValueError(
            "image_shells needs a 2-D (Lx, Ly) box — the exact image sum is "
            "the doubly-periodic (pseudo-2D) geometry")


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


def _free_coeffs_poly(r2, ai, aj):
    """Polydisperse free-space RPY coefficients (α, β), M = α·I + β·d⊗d
    (Zuk, Wajnryb, Mizerski & Szymczak, J. Fluid Mech. 741 (2014) R5),
    distances and radii in units of ``a``, ai / aj broadcast against r2:

      r ≥ ai + aj          α = (1 + (ai² + aj²)/3r²)/r, β = (1 − (ai² + aj²)/r²)/r³
      |ai − aj| ≤ r < ai + aj   the overlap form, prefactor (4/3)/(ai·aj)
      r < |ai − aj|        the smaller blob inside the larger: α = (4/3)/max(ai, aj), β = 0

    Equal radii ai = aj = 1 give :func:`_free_coeffs`; every branch is
    symmetric under i ↔ j."""
    r2s = torch.clamp(r2, min=_R2_FLOOR)
    r = torch.sqrt(r2s)
    invr = 1.0 / r
    invr2 = 1.0 / r2s
    a2s = ai * ai + aj * aj
    asum = ai + aj
    adiff = ai - aj
    far = r >= asum
    deep = r < torch.abs(adiff)
    alpha_far = (1.0 + (a2s / 3.0) * invr2) * invr
    beta_far = (1.0 - a2s * invr2) * invr2 * invr
    pref = (4.0 / 3.0) / torch.clamp(ai * aj, min=_R2_FLOOR)
    invr3 = invr * invr2
    g_i = (16.0 * r2s * r * asum - (adiff * adiff + 3.0 * r2s) ** 2) * (
        invr3 / 32.0)
    g_e = 3.0 * (adiff * adiff - r2s) ** 2 * (invr3 / 32.0)
    alpha_near = pref * g_i
    beta_near = pref * g_e * invr2
    alpha_deep = _SELF_COEF / torch.clamp(torch.maximum(ai, aj),
                                          min=_R2_FLOOR)
    alpha = torch.where(far, alpha_far,
                        torch.where(deep, alpha_deep, alpha_near))
    beta = torch.where(far, beta_far,
                       torch.where(deep, torch.zeros_like(beta_near),
                                   beta_near))
    return alpha, beta


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


def wall_self_diag(z, a, h_floor=WALL_H_FLOOR, radii=None):
    """Per-blob wall self-correction diagonal (N, 3), added to the 4/3 free
    self term; heights floored at ``h_floor``·a.  radii: optional (N,)
    physical radii: the equal-radius expression at z/aᵢ scaled by a/aᵢ,
    the height floored in units of the blob's own radius."""
    zn = z / a
    if radii is not None:
        ahat = radii.to(z.dtype) / a
        zn = zn / ahat
    if h_floor > 0:
        zn = torch.clamp(zn, min=h_floor)
    invZ = 1.0 / zn
    invZ3 = invZ * invZ * invZ
    invZ5 = invZ3 * invZ * invZ
    cxx = -(9.0 * invZ - 2.0 * invZ3 + invZ5) / 12.0
    czz = -(9.0 * invZ - 4.0 * invZ3 + invZ5) / 6.0
    out = torch.stack([cxx, cxx, czz], dim=-1)
    return out if radii is None else out * (1.0 / ahat)[:, None]


def _self_diag(r, a, wall, h_floor, radii=None):
    """(N, 3) self-mobility diagonal in units of 1/(8πηa); with per-blob
    ``radii`` the free term is (4/3)·a/aᵢ."""
    diag = torch.full(r.shape, _SELF_COEF, dtype=r.dtype, device=r.device)
    if radii is not None:
        diag = diag / (radii.to(r.dtype)[:, None] / a)
    if wall:
        diag = diag + wall_self_diag(r[:, 2], a, h_floor=h_floor, radii=radii)
    return diag


def self_mobility_blocks(r, a=1.0, eta=1.0, wall=False, h_floor=WALL_H_FLOOR,
                         radii=None):
    """Per-blob 3×3 self mobility (N, 3, 3), scaled by 1/(8πηa); radii:
    optional (N,) physical radii."""
    r = r.reshape(-1, 3)
    diag = _self_diag(r, a, wall, h_floor, radii) / (8.0 * math.pi * eta * a)
    return torch.diag_embed(diag)


def damping_factors(r, a=1.0, radii=None):
    """Wall-overlap damping d_i = clip(z_i/aᵢ, 0, 1), shape (N,); aᵢ = a
    unless per-blob ``radii`` are given."""
    r = r.reshape(-1, 3)
    az = a if radii is None else radii.to(r.dtype)
    return torch.clamp(r[:, 2] / az, 0.0, 1.0)


def image_offsets(box_n, shells, dtype=torch.float64, device=None):
    """Nonzero in-plane lattice offsets n·(Lx, Ly, 0), |n|∞ ≤ shells, (O, 3)
    in units of a, in the JAX package's order (ix major); the zero offset
    is the minimum-image sweep itself."""
    n = np.arange(-shells, shells + 1)
    nx, ny = np.meshgrid(n, n, indexing="ij")
    sel = (nx != 0) | (ny != 0)
    off = np.stack([nx[sel] * float(box_n[0]), ny[sel] * float(box_n[1]),
                    np.zeros(int(sel.sum()))], axis=-1)
    return torch.as_tensor(off, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def tail_coeffs(shells):
    """Two-ring Richardson tail coefficients (α, β) of the image sum, on the
    host in float64 exactly as the JAX package computes them: the truncated
    tail Σ_{s>S} ring_s of a ring sum A/s² + B/s³ is α·ring_S + β·ring_{S−1},
    [α, β] = [T₂, T₃]·M⁻¹, M = [[S⁻², S⁻³], [(S−1)⁻², (S−1)⁻³]], T_m =
    Σ_{s>S} s⁻ᵐ; S = 1 takes the one-term model, α = π²/6 − 1."""
    if shells <= 0:
        return 0.0, 0.0
    if shells == 1:
        return np.pi ** 2 / 6.0 - 1.0, 0.0
    S = float(shells)
    srange = np.arange(shells + 1, 2_000_000, dtype=np.float64)
    T = np.array([np.sum(srange ** -2.0), np.sum(srange ** -3.0)])
    M = np.array([[S ** -2, S ** -3], [(S - 1) ** -2, (S - 1) ** -3]])
    alpha, beta = T @ np.linalg.inv(M)
    return float(alpha), float(beta)


def image_tail_weights(shells, dtype=torch.float64, device=None):
    """Per-offset weights in :func:`image_offsets` order: 1 + α on ring S,
    1 + β on ring S − 1, 1 elsewhere (ring = ‖n‖∞)."""
    n = np.arange(-shells, shells + 1)
    nx, ny = np.meshgrid(n, n, indexing="ij")
    sel = (nx != 0) | (ny != 0)
    ring = np.maximum(np.abs(nx[sel]), np.abs(ny[sel]))
    alpha, beta = tail_coeffs(shells)
    w = np.ones(ring.shape, np.float64)
    w[ring == shells] += alpha
    if shells > 1:
        w[ring == shells - 1] += beta
    return torch.as_tensor(w, dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _image_lattice(box_n, shells, tail, dtype, device):
    """(offsets, weights) of the image sum, made once per lattice and
    device: a copy from the host would stall the card's queue at every
    product."""
    off = image_offsets(box_n, shells, dtype, device)
    w = (image_tail_weights(shells, dtype, device) if tail
         else torch.ones(off.shape[0], dtype=dtype, device=device))
    return off, w


def self_image_sum(r_over_a, F, wall, box_n, shells, h_floor=WALL_H_FLOOR,
                   tail=True, ahat=None):
    """Σ_o w_o·M(o; z_i, z_i)·F_i: every blob against its own in-plane
    periodic images, the diagonal of the exact image sum that a sweep over
    i ≠ j pairs leaves out.  Pair terms only.  r_over_a (N, 3), box_n
    (Lx, Ly) in units of a, F (N, 3) or (k, N, 3) → F's shape; ahat:
    optional (N,) radii in units of a (the pair aᵢ, aᵢ: the poly fields,
    the wall terms at z/aᵢ, scaled by 1/aᵢ).  All offsets at once, (O, N)
    fields: O(N·(2S+1)²) elementwise work."""
    multi = F.dim() == 3
    Fk = F if multi else F[None]
    dtype, dev = Fk.dtype, Fk.device
    off, w = _image_lattice(box_n, shells, tail, dtype, dev)    # (O, 3), (O,)
    poly = ahat is not None
    dF = torch.einsum("ox,knx->kon", off[:, :2], Fk[..., :2])   # (k, O, N)
    if poly:
        ahat = ahat.to(dtype)
        alpha, beta = _free_coeffs_poly(
            torch.sum(off * off, dim=-1)[:, None], ahat[None], ahat[None])
        out = (torch.einsum("on,knx->knx", w[:, None] * alpha, Fk)
               + torch.einsum("on,kon,ox->knx", w[:, None] * beta, dF, off))
    else:
        alpha, beta = _free_coeffs(torch.sum(off * off, dim=-1))  # (O,)
        out = (torch.einsum("o,knx->knx", w * alpha, Fk)
               + torch.einsum("o,kon,ox->knx", w * beta, dF, off))
    if wall:
        zs = r_over_a[:, 2]
        if poly:
            inv_ae = 1.0 / ahat
            zs = zs * inv_ae
        if h_floor > 0:
            zs = torch.clamp(zs, min=h_floor)
        O, N = off.shape[0], zs.shape[0]
        oxy = off[:, None, :2].expand(O, N, 2)
        if poly:
            oxy = oxy * inv_ae[None, :, None]
        d_img = torch.cat([oxy, (2.0 * zs).expand(O, N)[..., None]], dim=-1)
        f1, f2, f3, f4, f5, invR = _wall_coeffs(d_img, zs.expand(O, N))
        if poly:
            f1, f2, f3, f4, f5 = (f * inv_ae for f in (f1, f2, f3, f4, f5))
        e = d_img * invR[..., None]                             # (O, N, 3)
        eF = torch.einsum("onx,knx->kon", e, Fk)
        Fz = Fk[..., 2]
        wf = [w[:, None] * f for f in (f1, f2, f3, f4, f5)]
        out = out + torch.einsum("on,knx->knx", wf[0], Fk)
        out = out + torch.einsum("on,kon,onx->knx", wf[1], eF, e)
        out = out + torch.einsum("on,kn,onx->knx", wf[2], Fz, e)
        z_part = (torch.einsum("on,kon->kn", wf[3], eF)
                  + torch.einsum("on,kn->kn", wf[4], Fz))
        out = out + torch.stack(
            [torch.zeros_like(z_part), torch.zeros_like(z_part), z_part], dim=-1)
    return out if multi else out[0]


def _pair_field_sum(d, keep, Fk, wall, zi, zj, inv_ae=None, ahat_rows=None,
                    ahat_cols=None):
    """Σ_j M(d_ij)·F_j for one displacement set d (T, N, 3) → (k, T, 3).

    keep: (T, N) bool or None; a pair it drops adds an exact 0 (the zero
    lattice offset masks self pairs; a blob does interact with its own
    periodic images).  zi / zj: the floored heights (wall only).  ahat_rows
    (T,) / ahat_cols (N,): per-blob radii in units of a (both or neither);
    then inv_ae = 1/√(aᵢaⱼ) (T, N) scales the wall's in-plane displacement
    and its fields, and zi / zj are the pair's scaled floored heights.
    """
    poly = ahat_rows is not None
    r2 = torch.sum(d * d, dim=-1)
    if keep is not None:
        r2 = torch.where(keep, r2, torch.full_like(r2, 4.0))
    if poly:
        alpha, beta = _free_coeffs_poly(r2, ahat_rows[:, None],
                                        ahat_cols[None, :])
    else:
        alpha, beta = _free_coeffs(r2)
    if keep is not None:
        zero = torch.zeros_like(alpha)
        alpha = torch.where(keep, alpha, zero)
        beta = torch.where(keep, beta, zero)
    dF = torch.einsum("tnx,knx->ktn", d, Fk)
    out = (torch.einsum("tn,knx->ktx", alpha, Fk)
           + torch.einsum("ktn,tn,tnx->ktx", dF, beta, d))
    if wall:
        dxy = d[..., :2] * inv_ae[..., None] if poly else d[..., :2]
        d_img = torch.cat([dxy, (zi + zj).expand(d.shape[:2])[..., None]],
                          dim=-1)
        f1, f2, f3, f4, f5, invR = _wall_coeffs(d_img, zj.expand(d.shape[:2]))
        if poly:
            f1, f2, f3, f4, f5 = (f * inv_ae for f in (f1, f2, f3, f4, f5))
        e = d_img * invR[..., None]
        if keep is not None:
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


def _floored_heights(ri, rj, wall, h_floor, inv_ae=None):
    """Row and column heights (T, 1) / (1, N) in units of a, floored; with
    the polydisperse pair factor inv_ae (T, N) the heights are scaled by it
    first and floored per pair, (T, N) each."""
    if not wall:
        return None, None
    zi = ri[:, None, 2]
    zj = rj[None, :, 2]
    if inv_ae is not None:
        zi = zi * inv_ae
        zj = zj * inv_ae
    if h_floor > 0:
        zi = torch.clamp(zi, min=h_floor)
        zj = torch.clamp(zj, min=h_floor)
    return zi, zj


def _inv_ae(ahat_rows, ahat_cols, wall):
    """1/√(aᵢaⱼ) (T, N) for the wall terms of a polydisperse pair, or
    None (monodisperse, or no wall)."""
    if ahat_rows is None or not wall:
        return None
    return 1.0 / torch.sqrt(ahat_rows[:, None] * ahat_cols[None, :])


def _pair_tile(ri, rj, row_ids, col_ids, Fk, wall, h_floor, box_n=None,
               images=None, ahat_rows=None, ahat_cols=None):
    """Σ_j M_ij·F_j of all column blobs onto a tile of row blobs.

    ri (T, 3), rj (N, 3) in units of a, Fk (k, N, 3) → (k, T, 3); pair
    terms only, self pairs (equal global ids) masked out by selects at the
    zero offset.  box_n: the periodic box in units of a (minimum image);
    images: None or the (offsets (O, 3), weights (O,)) of the exact image
    sum, each offset added to the wrapped displacement, in order.
    ahat_rows (T,) / ahat_cols (N,): per-blob radii in units of a — the
    polydisperse fields, the wall terms at the pair's √(aᵢaⱼ) (exact for
    equal radii; the finite-size image terms of unequal radii are that
    a_eff approximation, as in the JAX package).
    """
    d = _displacement(ri, rj, box_n)                              # (T, N, 3)
    keep = row_ids[:, None] != col_ids[None, :]
    inv_ae = _inv_ae(ahat_rows, ahat_cols, wall)
    zi, zj = _floored_heights(ri, rj, wall, h_floor, inv_ae)
    poly = dict(inv_ae=inv_ae, ahat_rows=ahat_rows, ahat_cols=ahat_cols)
    out = _pair_field_sum(d, keep, Fk, wall, zi, zj, **poly)
    if images is not None:
        for o, wt in zip(*images):
            out = out + wt * _pair_field_sum(d + o, None, Fk, wall, zi, zj,
                                             **poly)
    return out


def pair_sum(r_rows, row_ids, r_cols, col_ids, F_cols, a=1.0, wall=False,
             row_tile=512, h_floor=WALL_H_FLOOR, box=None, image_shells=0,
             image_tail=True, radii_rows=None, radii_cols=None):
    """Σ_j M_ij·F_j over all column blobs, for a set of row blobs.

    Pair terms only — no self term, no 1/(8πηa), no damping.  r_rows (R, 3),
    r_cols (N, 3), F_cols (N, 3) or (k, N, 3); row_ids (R,) / col_ids (N,)
    global indices for self-pair masking (the ordered-slab contract of the
    kernels: a pair is skipped iff its two global ids are equal).

    box: None, or the periodic (Lx, Ly) box (minimum image in the plane;
    (Lx, Ly, Lz) wraps z too).  image_shells: S ≥ 1 adds the exact
    doubly-periodic sum over the (2S+1)² − 1 nonzero in-plane lattice
    images of the wrapped displacement, self images included; image_tail
    folds in the two-ring Richardson tail weights.  radii_rows (R,) /
    radii_cols (N,): optional per-blob physical radii (both or neither),
    the polydisperse pair mobility.
    """
    multi = F_cols.dim() == 3
    Fk = F_cols if multi else F_cols[None]
    box_n = _box_n(box, a)
    _check_images(box_n, image_shells)
    images = (_image_lattice(box_n, int(image_shells), image_tail, Fk.dtype,
                             Fk.device) if image_shells else None)
    # positions in units of a, as the kernels' wrapper hands them over
    r_rows, r_cols = r_rows / a, r_cols / a
    poly = radii_rows is not None
    if poly:
        ar = radii_rows.to(r_rows.dtype) / a
        ac = radii_cols.to(r_rows.dtype) / a
    # under autograd each row tile is recomputed in the backward pass, so
    # the gradient's memory stays O(row_tile·N) like the product's
    ckpt = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r_rows, r_cols, Fk)
        + ((ar, ac) if poly else ()))
    outs = []
    for s in range(0, r_rows.shape[0], row_tile):
        args = (r_rows[s:s + row_tile], r_cols, row_ids[s:s + row_tile],
                col_ids, Fk, wall, h_floor, box_n, images,
                ar[s:s + row_tile] if poly else None, ac if poly else None)
        outs.append(torch.utils.checkpoint.checkpoint(
            _pair_tile, *args, use_reentrant=False, preserve_rng_state=False)
            if ckpt else _pair_tile(*args))
    U = torch.cat(outs, dim=1)
    return U if multi else U[0]


def mobility_apply(F, r, a=1.0, eta=1.0, wall=False, damp=None, row_tile=512,
                   h_floor=WALL_H_FLOOR, box=None, image_shells=0,
                   image_tail=True, radii=None):
    """Matrix-free U = M(r)·F, or B·M·B·F when damped; (N, 3) → (N, 3).

    damp: None → damping iff ``wall`` (reference semantics).  box /
    image_shells / image_tail: the pseudo-2D box, see :func:`pair_sum`.
    radii: optional (N,) per-blob physical radii (polydisperse RPY).
    """
    r = r.reshape(-1, 3)
    return mobility_apply_multi(F.reshape(1, -1, 3), r, a, eta, wall, damp,
                                row_tile, h_floor, box, image_shells,
                                image_tail, radii)[0]


def mobility_apply_multi(Fs, r, a=1.0, eta=1.0, wall=False, damp=None,
                         row_tile=512, h_floor=WALL_H_FLOOR, box=None,
                         image_shells=0, image_tail=True, radii=None):
    """Multi-RHS U_k = M(r)·F_k, (k, N, 3) → (k, N, 3); the pair fields are
    shared across the RHS."""
    r = r.reshape(-1, 3)
    Fs = Fs.reshape(Fs.shape[0], -1, 3).to(r.dtype)
    use_damp = wall if damp is None else damp
    Fd = Fs
    if use_damp:
        b = damping_factors(r, a, radii)
        Fd = Fs * b[None, :, None]
    ids = torch.arange(r.shape[0], device=r.device)
    U = pair_sum(r, ids, r, ids, Fd, a=a, wall=wall, row_tile=row_tile,
                 h_floor=h_floor, box=box, image_shells=image_shells,
                 image_tail=image_tail, radii_rows=radii, radii_cols=radii)
    U = U + _self_diag(r, a, wall, h_floor, radii)[None] * Fd
    U = U * (1.0 / (8.0 * math.pi * eta * a))
    if use_damp:
        U = U * b[None, :, None]
    return U


def _dense_pair_blocks(d, keep, wall, zi, zj, inv_ae=None, ahat=None):
    """(N, N, 3, 3) pair mobility blocks for one displacement set d; a pair
    that ``keep`` (or None) drops is an exact 0.  inv_ae / ahat: the
    polydisperse pair factor and radii in units of a (see
    :func:`_pair_field_sum`)."""
    dtype, dev = d.dtype, d.device
    poly = ahat is not None
    r2 = torch.sum(d * d, dim=-1)
    if keep is not None:
        r2 = torch.where(keep, r2, torch.full_like(r2, 4.0))
    if poly:
        alpha, beta = _free_coeffs_poly(r2, ahat[:, None], ahat[None, :])
    else:
        alpha, beta = _free_coeffs(r2)
    if keep is not None:
        zero = torch.zeros_like(alpha)
        alpha = torch.where(keep, alpha, zero)
        beta = torch.where(keep, beta, zero)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    M = (alpha[:, :, None, None] * eye3
         + beta[:, :, None, None] * d[:, :, :, None] * d[:, :, None, :])
    if wall:
        n = d.shape[0]
        dxy = d[..., :2] * inv_ae[..., None] if poly else d[..., :2]
        d_img = torch.cat([dxy, (zi + zj).expand(n, n)[..., None]], dim=-1)
        f1, f2, f3, f4, f5, invR = _wall_coeffs(d_img, zj.expand(n, n))
        if poly:
            f1, f2, f3, f4, f5 = (f * inv_ae for f in (f1, f2, f3, f4, f5))
        e = d_img * invR[..., None]
        zhat = eye3[2]
        C = (f1[:, :, None, None] * eye3
             + f2[:, :, None, None] * e[:, :, :, None] * e[:, :, None, :]
             + f3[:, :, None, None] * e[:, :, :, None] * zhat[None, None, None, :]
             + f4[:, :, None, None] * zhat[None, None, :, None] * e[:, :, None, :]
             + f5[:, :, None, None] * zhat[None, None, :, None]
             * zhat[None, None, None, :])
        if keep is not None:
            C = torch.where(keep[:, :, None, None], C, torch.zeros_like(C))
        M = M + C
    return M


def mobility_matrix(r, a=1.0, eta=1.0, wall=False, h_floor=WALL_H_FLOOR,
                    box=None, image_shells=0, image_tail=True, radii=None):
    """Dense (3N, 3N) RPY mobility (undamped), every ordered pair evaluated
    directly (valid because C_ji = C_ijᵀ).  Small-N path: the PC and noise
    factor builds.  box / image_shells / image_tail: see :func:`pair_sum`;
    radii: optional (N,) per-blob physical radii."""
    r = r.reshape(-1, 3)
    n = r.shape[0]
    dtype, dev = r.dtype, r.device
    box_n = _box_n(box, a)
    _check_images(box_n, image_shells)
    r_n = r / a
    ahat = None if radii is None else radii.to(dtype) / a
    d = _displacement(r_n, r_n, box_n)                            # (N, N, 3)
    keep = ~torch.eye(n, dtype=torch.bool, device=dev)
    inv_ae = _inv_ae(ahat, ahat, wall)
    zi, zj = _floored_heights(r_n, r_n, wall, h_floor, inv_ae)
    M = _dense_pair_blocks(d, keep, wall, zi, zj, inv_ae, ahat)
    if image_shells:
        for o, wt in zip(*_image_lattice(box_n, int(image_shells), image_tail,
                                         dtype, dev)):
            M = M + wt * _dense_pair_blocks(d + o, None, wall, zi, zj, inv_ae,
                                            ahat)
    self_blocks = torch.diag_embed(_self_diag(r, a, wall, h_floor, radii))
    M = M + keep.logical_not()[:, :, None, None] * self_blocks[:, None, :, :]
    M = M * (1.0 / (8.0 * math.pi * eta * a))
    return M.permute(0, 2, 1, 3).reshape(3 * n, 3 * n)


def apply_M_dense(F, r, a=1.0, eta=1.0, wall=False, h_floor=WALL_H_FLOOR,
                  box=None, radii=None):
    """Dense-path U = B·M·B·F (damping iff wall) through
    :func:`mobility_matrix`, (N, 3) → (N, 3): for small N and validation
    (the (3N, 3N) matrix is formed)."""
    r = r.reshape(-1, 3)
    F = torch.as_tensor(F, dtype=r.dtype, device=r.device).reshape(-1)
    M = mobility_matrix(r, a, eta, wall, h_floor=h_floor, box=box,
                        radii=radii)
    if wall:
        b = torch.repeat_interleave(damping_factors(r, a, radii=radii), 3)
        return (b * (M @ (b * F))).reshape(-1, 3)
    return (M @ F).reshape(-1, 3)


def cross_mobility_blocks(ri, rj, a=1.0, eta=1.0, wall=False,
                          h_floor=WALL_H_FLOOR, radii_i=None, radii_j=None):
    """Pair mobility blocks between two position sets, (..., P, Q, 3, 3).

    The physics and scale of :func:`mobility_matrix` (free-space RPY +
    Swan–Brady wall correction, 1/(8πηa)) for cross pairs of ``ri``
    (..., P, 3) and ``rj`` (..., Q, 3): no self branch (a coincident pair
    gets the r → 0 overlap limit), no box and no damping.  radii_i (..., P)
    / radii_j (..., Q): optional physical radii (both or neither), the
    polydisperse fields with the wall terms at √(aᵢaⱼ).  The RAS
    preconditioners' halo coupling blocks (:func:`.saddle.build_pc_ras`,
    ``multi.build_pc_ras_multi``; the JAX package's halos do not see a box
    either).
    """
    dtype, dev = ri.dtype, ri.device
    inv_a = 1.0 / a
    poly = radii_i is not None
    if poly != (radii_j is not None):
        raise ValueError("cross_mobility_blocks takes radii_i and radii_j "
                         "together")
    d = (ri[..., :, None, :] - rj[..., None, :, :]) * inv_a     # (..., P, Q, 3)
    r2 = torch.sum(d * d, dim=-1)
    if poly:
        ahat_i = radii_i.to(dtype) * inv_a
        ahat_j = radii_j.to(dtype) * inv_a
        alpha, beta = _free_coeffs_poly(r2, ahat_i[..., :, None],
                                        ahat_j[..., None, :])
    else:
        alpha, beta = _free_coeffs(r2)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    M = (alpha[..., None, None] * eye3
         + beta[..., None, None] * d[..., :, None] * d[..., None, :])
    if wall:
        zi = ri[..., :, None, 2] * inv_a
        zj = rj[..., None, :, 2] * inv_a
        if poly:
            inv_ae = 1.0 / torch.sqrt(ahat_i[..., :, None]
                                      * ahat_j[..., None, :])
            zi = zi * inv_ae
            zj = zj * inv_ae
        if h_floor > 0:
            zi = torch.clamp(zi, min=h_floor)
            zj = torch.clamp(zj, min=h_floor)
        zj = zj.expand(d.shape[:-1])
        dxy = d[..., :2] * inv_ae[..., None] if poly else d[..., :2]
        d_img = torch.cat([dxy, (zi + zj)[..., None]], dim=-1)
        f1, f2, f3, f4, f5, invR = _wall_coeffs(d_img, zj)
        if poly:
            f1, f2, f3, f4, f5 = (f * inv_ae for f in (f1, f2, f3, f4, f5))
        e = d_img * invR[..., None]
        zhat = eye3[2]
        M = (M + f1[..., None, None] * eye3
             + f2[..., None, None] * e[..., :, None] * e[..., None, :]
             + f3[..., None, None] * e[..., :, None] * zhat
             + f4[..., None, None] * zhat[:, None] * e[..., None, :]
             + f5[..., None, None] * zhat[:, None] * zhat[None, :])
    return M * (1.0 / (8.0 * math.pi * eta * a))
