"""Saddle-point operator and block preconditioner — the port of the
main-path subset of ``rigid_body_light_tpu/ops/saddle.py``.

    [ M   −K ] [λ]   [slip]
    [ Kᵀ   0 ] [U] = [−F  ]

The preconditioner approximates M⁻¹ by a per-blob diagonal (``diag``), a
per-body block inverse (``block``), the rotation-equivariant free-space
body-frame inverse (``block_free``), or that inverse coupled to each
body's halo of nearby blobs of other bodies by a restricted additive
Schwarz split (``ras``, :func:`build_pc_ras`), forms Ñ⁻¹ = Kᵀ M̃⁻¹ K
(per body; coupled across bodies for ``ras``), then

    U = Ñ (−F − Kᵀ M̃⁻¹ slip),   λ = m_scale · M̃⁻¹ (slip + K U).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from rigid_body_light_tpu_torch.config import SimulationConfig
from rigid_body_light_tpu_torch.ops import ewald
from rigid_body_light_tpu_torch.ops import ewald_cuda
from rigid_body_light_tpu_torch.ops import ewald_pme
from rigid_body_light_tpu_torch.ops import farfield
from rigid_body_light_tpu_torch.ops import kinematics as kin
from rigid_body_light_tpu_torch.ops import quaternion as quat
from rigid_body_light_tpu_torch.ops import rpy
from rigid_body_light_tpu_torch.ops import rpy_cuda
from rigid_body_light_tpu_torch.state import BodyState
from rigid_body_light_tpu_torch.utils import collectives, profiling


class GeometryOps(NamedTuple):
    """Configuration-dependent kinematic quantities.

    offsets: (B, n, 3) world-frame blob offsets from body tracking points.
    positions: (B, n, 3) world-frame blob positions.
    ktkinv: (B, 6, 6) closed-form (KᵀK)⁻¹ blocks.
    rot: (B, 3, 3) body rotation matrices R(Q).
    """

    offsets: torch.Tensor
    positions: torch.Tensor
    ktkinv: torch.Tensor
    rot: torch.Tensor

    @property
    def flat_positions(self):
        return self.positions.reshape(-1, 3)


def geometry_ops(geom: kin.RefGeometry, state: BodyState) -> GeometryOps:
    rot = quat.to_rotation_matrix(state.Q)
    offsets = torch.einsum("bij,kj->bki", rot, geom.ref_cfg)
    return GeometryOps(offsets=offsets, positions=offsets + state.X[:, None, :],
                       ktkinv=kin.ktk_inv(geom, state.Q), rot=rot)


def body_K_blocks(offsets) -> torch.Tensor:
    """Dense per-blob K blocks (B, n, 3, 6): [ I | −[r]ₓ ]."""
    B, n, _ = offsets.shape
    rx, ry, rz = offsets.unbind(-1)
    zero = torch.zeros_like(rx)
    neg_skew = torch.stack(
        [
            torch.stack([zero, rz, -ry], dim=-1),
            torch.stack([-rz, zero, rx], dim=-1),
            torch.stack([ry, -rx, zero], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=offsets.dtype, device=offsets.device).expand(
        B, n, 3, 3)
    return torch.cat([eye, neg_skew], dim=-1)


def mobility_apply_fn(cfg: SimulationConfig, radii=None):
    """The blob-space mobility product (F (N,3), r (N,3)) → (N,3), damped
    iff ``cfg.wall``.  A 3-D ``cfg.box`` routes to the triply-periodic
    Ewald operator (:func:`_ewald_apply_fn`).  With ``farfield_grid`` set
    it is the proxy-grid far field (:func:`_farfield_apply_fn`).  Otherwise
    float32 with ``use_pallas`` goes through the CUDA pair-sweep wrappers
    (kernel K1 on the card), and anything else takes the plain sweep; a 2-D
    ``cfg.box`` gives both the pseudo-2D box and ``cfg.image_shells``.
    radii: optional (N,) per-blob physical radii closed over the returned
    fn (polydisperse RPY: the pair sweeps, the far field and the Ewald
    operator)."""
    if cfg.box is not None and len(cfg.box) == 3:
        return _ewald_apply_fn(cfg, radii, multi=False)
    if cfg.farfield_grid is not None:
        return _farfield_apply_fn(cfg, radii)
    kw = dict(_pair_box(cfg), radii=radii)
    if cfg.use_pallas and cfg.dtype == torch.float32:
        def apply_kernel(F, r):
            return rpy_cuda.mobility_apply(F, r, a=cfg.a, eta=cfg.eta,
                                           wall=cfg.wall,
                                           h_floor=cfg.wall_h_floor, **kw)
        return apply_kernel

    def apply_plain(F, r):
        return rpy.mobility_apply(F, r, a=cfg.a, eta=cfg.eta, wall=cfg.wall,
                                  row_tile=cfg.matvec_row_tile,
                                  h_floor=cfg.wall_h_floor, **kw)
    return apply_plain


def mobility_apply_multi_fn(cfg: SimulationConfig, radii=None):
    """Multi-RHS product (Fs (k,N,3), r (N,3)) → (k,N,3) sharing the pair
    fields across RHS (kernel K2 on the card for the fused two-draw
    noise; the far field's ndim-polymorphic apply with ``farfield_grid``;
    the Ewald operator with a 3-D box).  radii: as
    :func:`mobility_apply_fn`."""
    if cfg.box is not None and len(cfg.box) == 3:
        return _ewald_apply_fn(cfg, radii, multi=True)
    if cfg.farfield_grid is not None:
        return _farfield_apply_fn(cfg, radii)
    kw = dict(_pair_box(cfg), radii=radii)
    if cfg.use_pallas and cfg.dtype == torch.float32:
        def apply_kernel(Fs, r):
            return rpy_cuda.mobility_apply_multi(Fs, r, a=cfg.a, eta=cfg.eta,
                                                 wall=cfg.wall,
                                                 h_floor=cfg.wall_h_floor,
                                                 **kw)
        return apply_kernel

    def apply_plain(Fs, r):
        return rpy.mobility_apply_multi(Fs, r, a=cfg.a, eta=cfg.eta,
                                        wall=cfg.wall,
                                        row_tile=cfg.matvec_row_tile,
                                        h_floor=cfg.wall_h_floor, **kw)
    return apply_plain


def _pair_box(cfg: SimulationConfig) -> dict:
    """The pair sweeps' box arguments: the pseudo-2D (Lx, Ly) box and its
    image shells (a 3-D box never reaches the pair sweeps)."""
    if cfg.box is None:
        return {}
    return dict(box=cfg.box, image_shells=cfg.image_shells)


@functools.lru_cache(maxsize=8)
def _ewald_params(box, a, eta, xi, tol, rc=None):
    """``ewald.make_params`` (the host Chebyshev fit, tens of milliseconds
    and more) once per configuration: a step asks for the operator anew,
    and the arrays of the result are never written to."""
    return ewald.make_params(box, a, eta, xi=xi, tol=tol, rc=rc)


def _radii_key(radii):
    """The bytes of per-blob radii as float64 on the host: the cache key
    of the tables built from them (None without radii)."""
    if radii is None:
        return None
    rad = (radii.detach().cpu().numpy() if torch.is_tensor(radii)
           else np.asarray(radii))
    return np.ascontiguousarray(rad, np.float64).tobytes()


@functools.lru_cache(maxsize=8)
def _ewald_grid(params_key, p, radii_key):
    """``ewald_pme.make_grid`` once per (operator, p, radii); its device
    tables are kept per grid (``ewald.per_operator``).  params_key: the
    arguments of :func:`_ewald_params`."""
    radii = None if radii_key is None else np.frombuffer(radii_key)
    return ewald_pme.make_grid(_ewald_params(*params_key), p=p, radii=radii)


@functools.lru_cache(maxsize=8)
def _poly_tables(params_key, radii_key):
    """``ewald.make_poly_tables`` (one host fit per species pair) once per
    (operator, radii)."""
    return ewald.make_poly_tables(_ewald_params(*params_key),
                                  np.frombuffer(radii_key))


def _ewald_params_key(cfg: SimulationConfig):
    """The arguments of :func:`_ewald_params` for ``cfg``."""
    return (cfg.box, cfg.a, cfg.eta,
            cfg.ewald_xi if cfg.ewald_xi > 0 else None, cfg.ewald_tol,
            cfg.ewald_rc if cfg.ewald_rc > 0 else None)


def _ewald_apply_fn(cfg: SimulationConfig, radii, multi: bool):
    """Triply-periodic positively-split Ewald operator (:mod:`.ewald`) for a
    3-D ``cfg.box``, as the JAX package's ``saddle._ewald_apply_fn`` builds
    it: ``ewald_rc`` the balanced split (the tile sweep of
    :mod:`.ewald_cells`, ``ewald_nbr_tiles`` its neighbor-list width),
    ``ewald_grid_p`` its gridded wave part (:mod:`.ewald_pme`, built with
    the radii).  Monodisperse float32 with ``use_pallas`` and no ``rc``
    sweeps the real part through kernel K4 (:mod:`.ewald_cuda`); float32
    with ``use_pallas`` and ``rc`` sweeps the tiles through kernel K4 tiles
    (:func:`.ewald_cuda.tile_pair_sum`, monodisperse and with radii) inside
    the operator of :mod:`.ewald`; anything else takes the plain PyTorch
    operator on the tensors' device (closed-form scalars in float64;
    float32 radii through species-pair fits built once).  radii: (N,)
    per-blob radii."""
    params_key = _ewald_params_key(cfg)
    rc = params_key[-1]
    params = _ewald_params(*params_key)
    if (cfg.use_pallas and cfg.dtype == torch.float32 and radii is None
            and rc is None):
        kernel = (ewald_cuda.mobility_apply_multi if multi
                  else ewald_cuda.mobility_apply)

        def apply_kernel(F, r):
            return kernel(F, r, params)
        return apply_kernel
    key = _radii_key(radii)
    grid = (_ewald_grid(params_key, cfg.ewald_grid_p, key)
            if cfg.ewald_grid_p else None)
    pt = (_poly_tables(params_key, key)
          if radii is not None and cfg.dtype == torch.float32 else None)
    plain = ewald.mobility_apply_multi if multi else ewald.mobility_apply
    max_nbr = cfg.ewald_nbr_tiles if cfg.ewald_nbr_tiles > 0 else None

    def apply_plain(F, r):
        return plain(F, r, params, row_tile=cfg.matvec_row_tile, radii=radii,
                     poly_tables=pt, max_nbr=max_nbr, grid=grid,
                     use_kernel=cfg.use_pallas)
    return apply_plain


def _farfield_apply_fn(cfg: SimulationConfig, radii=None, group=None):
    """Proxy-grid near + far mobility (:mod:`.farfield`), O(N) at fixed
    density.  It takes (N, 3) or (k, N, 3) forces, so it serves both
    apply-fn entry points; float32 with ``use_pallas`` sweeps the near part
    through kernel K3.  ``farfield_band_p`` adds the band tier (its blocks
    built with the lattices).  A 2-D ``cfg.box`` makes it the pseudo-2D
    film's far field (cyclic x/y, the combined lattice summed over
    ``image_shells`` in-plane images; K3's box form).  radii: per-blob radii (the
    radius-split lattices and K3's POLY form), seen by the apply, the
    position setup and the lattice build alike.

    The returned callable carries ``prepare`` / ``prepare_geometry``
    attributes: loop hosts build the position setup once with
    :func:`hoist_positions`, and a step shares one kernel-lattice build
    across its position sets with :func:`pin_geometry`.

    group: None, or the process group of the distributed stepper: the
    callable then takes and returns this rank's blobs
    (:func:`.farfield.mobility_apply`'s ``group``), the film's too."""
    grid = None if cfg.farfield_grid == "auto" else cfg.farfield_grid
    max_nbr = cfg.farfield_nbr_tiles if cfg.farfield_nbr_tiles > 0 else None
    kw = dict(a=cfg.a, eta=cfg.eta, wall=cfg.wall, grid=grid,
              p=cfg.farfield_p, max_nbr=max_nbr, h_floor=cfg.wall_h_floor,
              radii=radii, band_p=cfg.farfield_band_p, group=group)
    if cfg.box is not None:
        kw.update(box=cfg.box, image_shells=cfg.image_shells)

    def apply(F, r, ctx=None):
        return farfield.mobility_apply(F, r, ctx=ctx,
                                       use_pallas=cfg.use_pallas, **kw)

    apply.prepare = lambda r, geo=None: farfield.prepare(r, geo=geo, **kw)
    apply.prepare_geometry = lambda r: farfield.prepare_geometry(r, **kw)
    return apply


def hoist_positions(mob, r):
    """Bind a mobility apply-fn's position-dependent setup for fixed ``r``.

    For operators with a ``prepare`` attribute (the far field), builds the
    :class:`~.farfield.FarCtx` once and returns a same-signature callable
    that reuses it: call this where a Krylov or Lanczos loop starts.  The
    returned callable assumes every call passes the ``r`` it was bound to
    (its positions argument is ignored).  Operators without ``prepare``
    (the pair sweeps, the Ewald operator) are returned unchanged.
    """
    prep = getattr(mob, "prepare", None)
    if prep is None:
        return mob
    with profiling.span("far_setup"):
        ctx = prep(r)

    def bound(F, _r_ignored, ctx2=None):
        return mob(F, _r_ignored, ctx if ctx2 is None else ctx2)

    bound.prepare = prep
    bound.prepare_geometry = mob.prepare_geometry
    return bound


def pin_geometry(mob, r):
    """Share one kernel-lattice build across a step's position sets.

    Builds the geometry tier (grid origin, cell sizes, kernel lattices)
    from ``r`` and returns a same-signature apply-fn whose ``prepare``
    reuses it, so the step's sub-solves (the noise at the base
    configuration, RFD's displaced applies, the half-kick solve) rebuild
    only the cheap position structures.  Valid while every position set
    stays within a fraction of a cell of ``r``; a farther one poisons the
    apply (:func:`.farfield.prepare`).  No-op for operators without
    geometry.
    """
    gp = getattr(mob, "prepare_geometry", None)
    if gp is None:
        return mob
    with profiling.span("lattice_build"):
        geo = gp(r)
    base_prep = mob.prepare

    def pinned(F, r2, ctx=None):
        return mob(F, r2, base_prep(r2, geo) if ctx is None else ctx)

    pinned.prepare = lambda r2, g=None: base_prep(r2, geo if g is None
                                                  else g)
    pinned.prepare_geometry = lambda r2: geo
    return pinned


def apply_saddle(lam, U, ops: GeometryOps, cfg: SimulationConfig,
                 mob_apply=None):
    """One saddle matvec: (λ (N,3), U (B,6)) → (Mλ − KU (N,3), Kᵀλ (B,6))."""
    if mob_apply is None:
        mob_apply = mobility_apply_fn(cfg)
    B, n, _ = ops.offsets.shape
    lam_b = lam.reshape(B, n, 3)
    with profiling.span("mobility"):
        slip = mob_apply(lam.reshape(-1, 3), ops.flat_positions)
    slip = slip.reshape(B, n, 3) - kin.K_dot(U, ops.offsets)
    F = kin.KT_dot(lam_b, ops.offsets)
    return slip.reshape(-1, 3), F


class PCData(NamedTuple):
    """Preconditioner factors for one configuration (see the JAX PCData).

    inv_m_diag: (N, 3, 3) per-blob inverse self mobilities (diag) or None.
    inv_m_block: (B, 3n, 3n) per-body inverse mobility blocks (block) or None.
    n_mat: (B, 6, 6) Ñ⁻¹ = Kᵀ M̃⁻¹ K blocks, solved per application.
    minv_ref / n_ref: body-frame constants of ``block_free`` (and the static
      tier of ``ras``): the free-space per-body mobility inverse (3n, 3n)
      and N̂ = (K̂ᵀ M̂⁻¹ K̂)⁻¹ (6, 6).
    halo_idx / halo_w / halo_sinv / n_full: the RAS halo coupling, built
      per solve by :func:`build_pc_ras` (None otherwise): (B, H) global
      blob ids of each body's halo, W = A⁻¹C (B, 3n, 3H), the Schur inverse
      (D − CᵀA⁻¹C)⁻¹ (B, 3H, 3H) and the consistent coupled Ñ =
      (Kᵀ M̃⁻¹ K)⁻¹ (6B, 6B).
    """

    inv_m_diag: Optional[torch.Tensor]
    inv_m_block: Optional[torch.Tensor]
    n_mat: Optional[torch.Tensor]
    minv_ref: Optional[torch.Tensor] = None
    n_ref: Optional[torch.Tensor] = None
    halo_idx: Optional[torch.Tensor] = None
    halo_w: Optional[torch.Tensor] = None
    halo_sinv: Optional[torch.Tensor] = None
    n_full: Optional[torch.Tensor] = None


def _rot6(rot):
    """Block-diagonal 6×6 rotations diag(R, R), shape (B, 6, 6)."""
    R6 = torch.zeros((rot.shape[0], 6, 6), dtype=rot.dtype, device=rot.device)
    R6[:, 0:3, 0:3] = rot
    R6[:, 3:6, 3:6] = rot
    return R6


def grand_body_mobility(ops: GeometryOps, cfg: SimulationConfig, n_ref,
                        include_rot: bool = True) -> torch.Tensor:
    """Coupled (6B, 6B) far-field grand body mobility (Stokesian-dynamics
    far field): exact single-body diagonal blocks + RPY-at-Rh_eff pair
    blocks (wall-corrected trans-trans; free-space rotlet couplings when
    ``include_rot``).  n_ref: the body-frame (6, 6) single-body mobility
    (``PCData.n_ref`` of ``block_free``).

    **Measured negative result (with the JAX package,
    ``scripts/pc_dense_study.py``):** used as the U-block Ñ of the saddle
    preconditioner while M̃⁻¹ stays body-diagonal, this makes convergence
    dramatically WORSE (dispersed 9→30 iters, settled 13→35): with a
    block-diagonal M̃ the exact Schur inverse is itself block-diagonal, so
    injecting coupling only at the Schur level breaks the PC's
    exact-inverse structure — Ñ must stay consistent with M̃ (the
    inconsistent-Ñ Neumann variant shows the same failure, 38 vs 15
    iters).  Kept as the documented dead end; it is NOT wired into
    :func:`build_pc`.
    """
    rot = ops.rot
    B = rot.shape[0]
    dtype, dev = rot.dtype, rot.device
    # effective hydrodynamic radius from the exact single-body mobility:
    # n_ref[:3,:3] ≈ I/(6πη·Rh_eff)
    mu_t = torch.trace(n_ref[0:3, 0:3]) / 3.0
    rh = float(1.0 / (6.0 * torch.pi * cfg.eta * mu_t))
    X = ops.positions[:, 0, :] - ops.offsets[:, 0, :]   # (B, 3) tracking points

    # trans-trans: body-level wall-corrected RPY at radius Rh_eff
    m_tt = rpy.mobility_matrix(
        X, a=rh, eta=cfg.eta, wall=cfg.wall, h_floor=cfg.wall_h_floor,
        box=cfg.box).reshape(B, 3, B, 3)
    grand = torch.zeros((B, 6, B, 6), dtype=dtype, device=dev)
    grand[:, 0:3, :, 0:3] = m_tt

    if include_rot and B > 1:
        d = (X[:, None, :] - X[None, :, :]) / rh
        box_n = (None if cfg.box is None
                 else (cfg.box[0] / rh, cfg.box[1] / rh))
        d = rpy.wrapped_difference(d, torch.zeros_like(d), box_n)
        r = torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=1e-24))
        rcl = torch.clamp(r, min=2.0)    # clamp at contact: 2·Rh_eff
        e = d / r[..., None]
        # normalized by rh: physical r_phys = r·rh
        g = 1.0 / (8.0 * torch.pi * cfg.eta * (rcl * rh) ** 2)    # (B, B)
        ex, ey, ez = e.unbind(-1)
        zero = torch.zeros_like(ex)
        skew = torch.stack(
            [
                torch.stack([zero, -ez, ey], dim=-1),
                torch.stack([ez, zero, -ex], dim=-1),
                torch.stack([-ey, ex, zero], dim=-1),
            ],
            dim=-2,
        )                                                # (B, B, 3, 3) = [e]ₓ
        c_ut = -g[..., None, None] * skew
        grr = 1.0 / (16.0 * torch.pi * cfg.eta * (rcl * rh) ** 3)
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        c_rr = grr[..., None, None] * (
            3.0 * e[..., :, None] * e[..., None, :] - eye3)
        grand[:, 0:3, :, 3:6] = c_ut.permute(0, 2, 1, 3)
        grand[:, 3:6, :, 0:3] = c_ut.permute(0, 2, 1, 3)
        grand[:, 3:6, :, 3:6] = c_rr.permute(0, 2, 1, 3)

    # every diagonal block is the exact single-body mobility
    R6 = _rot6(rot)
    diag = torch.einsum("bij,jk,blk->bil", R6, n_ref, R6)     # (B, 6, 6)
    idx = torch.arange(B, device=dev)
    grand[idx, :, idx, :] = diag
    return grand.reshape(6 * B, 6 * B)


# floor (relative to the free 4/3 self mobility) on the diag PC's self blocks
_PC_SELF_FLOOR = 0.05


def build_pc(ops: GeometryOps, cfg: SimulationConfig) -> PCData:
    B, n, _ = ops.offsets.shape
    mode = cfg.pc_mode or ("block" if cfg.block_diag_pc else "diag")
    if mode not in ("diag", "block", "block_free", "ras"):
        raise ValueError(f"unknown pc_mode {mode!r}; use diag, block, "
                         "block_free or ras")
    if mode in ("block_free", "ras"):
        # ras: this is its static tier; solve_saddle attaches the halo
        # coupling at each solve's geometry (build_pc_ras)
        # body-frame constants, recovered from body 0's rotation
        ref = torch.einsum("ji,kj->ki", ops.rot[0], ops.offsets[0])
        m_ref = rpy.mobility_matrix(ref, cfg.a, cfg.eta, wall=False)
        minv_ref = torch.linalg.inv(m_ref)
        kb_ref = body_K_blocks(ref[None])[0].reshape(3 * n, 6)
        ninv_ref = kb_ref.T @ minv_ref @ kb_ref
        return PCData(inv_m_diag=None, inv_m_block=None, n_mat=None,
                      minv_ref=minv_ref, n_ref=torch.linalg.inv(ninv_ref))
    Kb = body_K_blocks(ops.offsets)                        # (B, n, 3, 6)
    if mode == "block":
        # the body's own blobs, minimum image in the box (no shells), as
        # the JAX package builds them
        inv_m_block = torch.stack([
            torch.linalg.inv(rpy.mobility_matrix(
                pos_b, cfg.a, cfg.eta, cfg.wall, h_floor=cfg.wall_h_floor,
                box=cfg.box))
            for pos_b in ops.positions])                   # (B, 3n, 3n)
        Kb_flat = Kb.reshape(B, 3 * n, 6)
        ninv = torch.einsum("bia,bij,bjc->bac", Kb_flat, inv_m_block, Kb_flat)
        return PCData(inv_m_diag=None, inv_m_block=inv_m_block, n_mat=ninv)
    self_blocks = rpy.self_mobility_blocks(
        ops.flat_positions, cfg.a, cfg.eta, cfg.wall, h_floor=cfg.wall_h_floor)
    floor = _PC_SELF_FLOOR * (4.0 / 3.0) / (8.0 * torch.pi * cfg.eta * cfg.a)
    diag = torch.clamp(torch.diagonal(self_blocks, dim1=-2, dim2=-1), min=floor)
    inv_m_diag = torch.diag_embed(1.0 / diag).reshape(B, n, 3, 3)
    ninv = torch.einsum("bkia,bkij,bkjc->bac", Kb, inv_m_diag, Kb)
    return PCData(inv_m_diag=inv_m_diag.reshape(B * n, 3, 3),
                  inv_m_block=None, n_mat=ninv)


def _ns_inverse(S, iters: int):
    """Batched Newton–Schulz inverse X_{k+1} = X_k(2I − S·X_k) from the
    Pan–Reif start X₀ = Sᵀ/(‖S‖₁‖S‖∞): matmuls only, at full float32 (the
    package pins TF32 off), preconditioner-grade after ``iters`` steps."""
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    n1 = torch.amax(torch.sum(torch.abs(S), dim=-2), dim=-1)
    ninf = torch.amax(torch.sum(torch.abs(S), dim=-1), dim=-1)
    X = S.transpose(-1, -2) / (n1 * ninf)[..., None, None]
    for _ in range(iters):
        X = X @ (2.0 * eye - S @ X)
    return X


# Newton–Schulz steps of the halo Schur inverses (B, 3H, 3H) and of the
# coupled body matrix (6B, 6B): the JAX package's counts, which reproduced
# 30 / 40 steps' iteration counts on the settled checkpoint
_NS_ITERS_S = 14
_NS_ITERS_N = 18
# the consistent Ñ is built by one batched apply to all 6B K columns while
# they take at most this many bytes, else body by body
_RAS_BATCH_BYTES = 256 * 2**20


def _ras_core_apply(minv_ref, rot, v):
    """Static body-frame core A⁻¹·v = R̃ M̂⁻¹ R̃ᵀ v; v (..., B, n, 3)."""
    B, n = v.shape[-3], v.shape[-2]
    lead = v.shape[:-3]
    v_body = torch.einsum("bji,...bnj->...bni", rot, v).reshape(
        *lead, B, 3 * n)
    w = torch.einsum("pq,...bq->...bp", minv_ref, v_body).reshape(
        *lead, B, n, 3)
    return torch.einsum("bij,...bnj->...bni", rot, w)


def _ras_apply(v, minv_ref, rot, halo_idx, W, S_inv, v_full=None):
    """RAS M̃⁻¹·v: per body, the Woodbury solve of its cluster [[A, C],
    [Cᵀ, D]] (own blobs and halo), own rows kept.  v (..., N, 3) →
    (..., N, 3).  v_full: the vector the halo ids index into, default v
    (a mixture's species reads its halo from the concatenated vector)."""
    if v_full is None:
        v_full = v
    B, H = halo_idx.shape
    N = v.shape[-2]
    n = N // B
    lead = v.shape[:-2]
    v1 = v.reshape(*lead, B, n, 3)
    y_core = _ras_core_apply(minv_ref, rot, v1)            # A⁻¹ v1
    v2 = v_full[..., halo_idx.reshape(-1), :].reshape(*lead, B, 3 * H)
    v1f = v1.reshape(*lead, B, 3 * n)
    t = v2 - torch.einsum("bph,...bp->...bh", W, v1f)     # v2 − Cᵀ A⁻¹ v1
    y2 = torch.einsum("bhg,...bg->...bh", S_inv, t)        # Schur solve
    y = y_core.reshape(*lead, B, 3 * n) - torch.einsum(
        "bph,...bh->...bp", W, y2)
    return y.reshape(*lead, N, 3)


def _nearest(d, k):
    """Indices of the k smallest entries of each row of d, ascending, ties
    to the lower index (the order of ``lax.top_k`` on −d, which the JAX
    package selects halos with; ``torch.topk`` promises no tie order)."""
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def build_pc_ras(ops: GeometryOps, cfg: SimulationConfig,
                 static_pc: PCData = None, group=None) -> PCData:
    """Attach the configuration-dependent RAS halo coupling to the static
    ``block_free`` core — the settled-suspension preconditioner (the JAX
    ``build_pc_ras``).

    Per body, a cluster of its own blobs and the ≤ H = ``pc_halo_max``
    nearest other-body blobs within ``pc_halo``·a: the exact damped wall
    mobility on the cluster, split as a Woodbury solve around the static
    body core A (W = A⁻¹C and the Schur inverse (D − CᵀW)⁻¹, Newton–Schulz),
    own rows kept; Ñ is the consistent coupled (Kᵀ M̃⁻¹ K)⁻¹.  Returns the
    static tier alone for one body or ``pc_halo_max`` = 0.

    group: None (one device), or the process group of the distributed
    solve: ``ops`` is this rank's bodies.  Halo clusters cross the ranks'
    bodies, so the build gathers the blob positions and the body offsets
    once, selects each local body's halo against the global blob set and
    builds the Woodbury factors of the local bodies only; Ñ⁻¹'s rows are
    this rank's RAS rows applied to all 6B K columns, gathered into the
    replicated (6B)² matrix, whose Newton–Schulz inverse every rank
    computes (6B ≪ N).  The halo values of an apply come from one gather
    (:func:`_inv_m_apply`).
    """
    B_l, n, _ = ops.offsets.shape
    if static_pc is None or static_pc.minv_ref is None:
        static_pc = build_pc(ops, cfg.replace(pc_mode="block_free"))
    B = B_l * collectives.size(group)                      # global bodies
    H = min(cfg.pc_halo_max, (B - 1) * n)
    if H <= 0 or B == 1:
        return static_pc
    pos = collectives.all_gather(ops.flat_positions, group)   # (N, 3)
    b0 = collectives.rank(group) * B_l                     # first own body
    own = slice(b0 * n, (b0 + B_l) * n)                    # own blobs
    N = B * n
    dtype, dev = pos.dtype, pos.device

    # halo selection: the 2H other-body blobs nearest the body's tracking
    # point, then the H of them nearest any of its blobs, cut off at
    # pc_halo·a
    X = ops.positions[:, 0, :] - ops.offsets[:, 0, :]      # (B_l, 3)
    body_of = torch.arange(B, device=dev).repeat_interleave(n)
    d_c = torch.linalg.norm(pos[None, :, :] - X[:, None, :], dim=-1)
    d_c = torch.where(
        body_of[None, :] == (b0 + torch.arange(B_l, device=dev))[:, None],
        torch.full_like(d_c, float("inf")), d_c)           # (B_l, N)
    K2 = min(2 * H, (B - 1) * n)
    cand = _nearest(d_c, K2)                               # (B_l, K2)
    cand_pos = pos[cand.reshape(-1)].reshape(B_l, K2, 3)
    d_exact = torch.amin(torch.linalg.norm(
        ops.positions[:, :, None, :] - cand_pos[:, None, :, :], dim=-1),
        dim=1)                                             # (B_l, K2)
    sel = _nearest(d_exact, H)
    halo_idx = torch.gather(cand, 1, sel)                  # (B_l, H) global
    mask = torch.gather(d_exact, 1, sel) < cfg.pc_halo * cfg.a
    halo_pos = pos[halo_idx.reshape(-1)].reshape(B_l, H, 3)

    # coupling C (B_l, 3n, 3H) and halo block D (B_l, 3H, 3H): the operator's
    # damped wall pair blocks; masked slots give zero coupling, so an empty
    # halo reduces the PC to block_free exactly
    kw = dict(a=cfg.a, eta=cfg.eta, wall=cfg.wall, h_floor=cfg.wall_h_floor)
    Cb = rpy.cross_mobility_blocks(ops.positions, halo_pos, **kw)
    Db = rpy.cross_mobility_blocks(halo_pos, halo_pos, **kw)
    if cfg.wall:
        b_all = rpy.damping_factors(pos, cfg.a)
        b_body = b_all[own].reshape(B_l, n)
        b_halo = b_all[halo_idx.reshape(-1)].reshape(B_l, H)
        Cb = Cb * (b_body[:, :, None] * b_halo[:, None, :])[..., None, None]
        Db = Db * (b_halo[:, :, None] * b_halo[:, None, :])[..., None, None]
    mf = mask.to(dtype)
    Cb = Cb * mf[:, None, :, None, None]
    Db = Db * (mf[:, :, None] * mf[:, None, :])[..., None, None]
    # halo self blocks (wall self term and damping² included); ghost slots
    # get an identity diagonal so the Schur block stays invertible
    selfb = rpy.self_mobility_blocks(
        halo_pos.reshape(-1, 3), cfg.a, cfg.eta, cfg.wall,
        h_floor=cfg.wall_h_floor).reshape(B_l, H, 3, 3)
    if cfg.wall:
        selfb = selfb * (b_halo * b_halo)[:, :, None, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    hh = torch.arange(H, device=dev)
    Db[:, hh, hh] = torch.where(mask[:, :, None, None], selfb, eye3)
    C = Cb.permute(0, 1, 3, 2, 4).reshape(B_l, 3 * n, 3 * H)
    D = Db.permute(0, 1, 3, 2, 4).reshape(B_l, 3 * H, 3 * H)

    # Woodbury factors
    minv_ref, rot = static_pc.minv_ref, ops.rot
    W = _ras_core_apply(
        minv_ref, rot, C.reshape(B_l, n, 3, 3 * H).permute(3, 0, 1, 2)
    ).permute(1, 2, 3, 0).reshape(B_l, 3 * n, 3 * H)
    S_inv = _ns_inverse(D - torch.einsum("bph,bpg->bhg", C, W), _NS_ITERS_S)

    # consistent coupled Ñ = (Kᵀ M̃⁻¹ K)⁻¹ from the RAS inverse of all 6B
    # K columns: [p, q] = K_pᵀ M̃⁻¹ K_q; every rank builds the global K
    # columns from the gathered offsets and applies its own RAS rows
    Kb = body_K_blocks(ops.offsets)                        # (B_l, n, 3, 6)
    Kb_all = body_K_blocks(collectives.all_gather(ops.offsets, group))

    def rows(cols):    # (c, N, 3) columns → (c, B_l, 6) = Kᵀ M̃⁻¹ cols
        y = _ras_apply(cols[:, own], minv_ref, rot, halo_idx, W, S_inv,
                       v_full=cols)
        return torch.einsum("bnif,cbni->cbf", Kb, y.reshape(-1, B_l, n, 3))

    if 6 * B * N * 3 * pos.element_size() <= _RAS_BATCH_BYTES:
        cols = torch.zeros((B, 6, B, n, 3), dtype=dtype, device=dev)
        idx = torch.arange(B, device=dev)
        cols[idx, :, idx] = Kb_all.permute(0, 3, 1, 2)
        ninv = collectives.all_gather(rows(cols.reshape(6 * B, N, 3)),
                                      group, dim=1)        # (6B, B, 6)
    else:
        parts = []
        for j in range(B):
            cols = torch.zeros((6, N, 3), dtype=dtype, device=dev)
            cols[:, j * n:(j + 1) * n] = Kb_all[j].permute(2, 0, 1)
            parts.append(rows(cols))
        ninv = collectives.all_gather(torch.stack(parts), group,
                                      dim=2)               # (B, 6, B, 6)
    ninv = ninv.reshape(6 * B, 6 * B).T
    return static_pc._replace(halo_idx=halo_idx, halo_w=W, halo_sinv=S_inv,
                              n_full=_ns_inverse(ninv, _NS_ITERS_N))


def _inv_m_apply(pc: PCData, v, ops: GeometryOps, group=None):
    """M̃⁻¹ · v for any PC flavor; v and the result (B, n, 3), this rank's
    bodies with a ``group``, where the RAS flavor gathers the blob vector
    once to read its halo values."""
    B, n, _ = v.shape
    if pc.halo_w is not None:
        v_flat = v.reshape(B * n, 3)
        return _ras_apply(v_flat, pc.minv_ref, ops.rot, pc.halo_idx,
                          pc.halo_w, pc.halo_sinv,
                          v_full=collectives.all_gather(v_flat, group)
                          ).reshape(B, n, 3)
    if pc.minv_ref is not None:
        v_body = torch.einsum("bji,bnj->bni", ops.rot, v).reshape(B, 3 * n)
        w = torch.einsum("pq,bq->bp", pc.minv_ref, v_body).reshape(B, n, 3)
        return torch.einsum("bij,bnj->bni", ops.rot, w)
    if pc.inv_m_block is not None:
        vf = v.reshape(B, 3 * n)
        return torch.einsum("bij,bj->bi", pc.inv_m_block, vf).reshape(B, n, 3)
    blocks = pc.inv_m_diag.reshape(B, n, 3, 3)
    return torch.einsum("bkij,bkj->bki", blocks, v)


def _n_solve(pc: PCData, rhs, ops: GeometryOps, group=None):
    """Solve Ñ⁻¹ U = rhs per body; rhs (B, 6), this rank's bodies with a
    ``group``.  RAS: one dense (6B)² matvec with the coupled Ñ, the rhs
    gathered over the group and this rank's rows kept."""
    if pc.n_full is not None:
        B_l = rhs.shape[0]
        rhs_all = collectives.all_gather(rhs, group)
        b0 = collectives.rank(group) * B_l
        return (pc.n_full @ rhs_all.reshape(-1)).reshape(-1, 6)[b0:b0 + B_l]
    if pc.n_ref is not None:
        f_b = torch.einsum("bji,bj->bi", ops.rot, rhs[:, 0:3])
        t_b = torch.einsum("bji,bj->bi", ops.rot, rhs[:, 3:6])
        u_body = torch.einsum("pq,bq->bp", pc.n_ref,
                              torch.cat([f_b, t_b], dim=-1))
        u = torch.einsum("bij,bj->bi", ops.rot, u_body[:, 0:3])
        om = torch.einsum("bij,bj->bi", ops.rot, u_body[:, 3:6])
        return torch.cat([u, om], dim=-1)
    return torch.linalg.solve(pc.n_mat, rhs[..., None])[..., 0]


def apply_pc(pc: PCData, slip, F, ops: GeometryOps, cfg: SimulationConfig,
             group=None):
    """Apply the saddle preconditioner: (slip (N,3), F (B,6)) → (λ, U).
    group: distributed mode (this rank's bodies); only the RAS flavor
    communicates (:func:`_inv_m_apply`, :func:`_n_solve`)."""
    B, n, _ = ops.offsets.shape
    slip_b = slip.reshape(B, n, 3)
    im_slip = _inv_m_apply(pc, slip_b, ops, group)
    rhs = -F - kin.KT_dot(im_slip, ops.offsets)
    U = _n_solve(pc, rhs, ops, group)
    lam = _inv_m_apply(pc, slip_b + kin.K_dot(U, ops.offsets), ops, group)
    return (cfg.m_scale * lam).reshape(-1, 3), U
