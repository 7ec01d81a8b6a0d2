"""Saddle-point operator and block preconditioner — the port of the
main-path subset of ``rigid_body_light_tpu/ops/saddle.py``.

    [ M   −K ] [λ]   [slip]
    [ Kᵀ   0 ] [U] = [−F  ]

The preconditioner approximates M⁻¹ by a per-blob diagonal (``diag``), a
per-body block inverse (``block``) or the rotation-equivariant free-space
body-frame inverse (``block_free``), forms Ñ⁻¹ = Kᵀ M̃⁻¹ K per body, then

    U = Ñ (−F − Kᵀ M̃⁻¹ slip),   λ = m_scale · M̃⁻¹ (slip + K U).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from rigid_body_light_tpu_torch.config import SimulationConfig
from rigid_body_light_tpu_torch.ops import ewald
from rigid_body_light_tpu_torch.ops import ewald_cuda
from rigid_body_light_tpu_torch.ops import farfield
from rigid_body_light_tpu_torch.ops import kinematics as kin
from rigid_body_light_tpu_torch.ops import quaternion as quat
from rigid_body_light_tpu_torch.ops import rpy
from rigid_body_light_tpu_torch.ops import rpy_cuda
from rigid_body_light_tpu_torch.state import BodyState


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


def mobility_apply_fn(cfg: SimulationConfig):
    """The blob-space mobility product (F (N,3), r (N,3)) → (N,3), damped
    iff ``cfg.wall``.  A 3-D ``cfg.box`` routes to the triply-periodic
    Ewald operator (:func:`_ewald_apply_fn`).  With ``farfield_grid`` set
    it is the proxy-grid far field (:func:`_farfield_apply_fn`).  Otherwise
    float32 with ``use_pallas`` goes through the CUDA pair-sweep wrappers
    (kernel K1 on the card), and anything else takes the plain sweep."""
    if cfg.box is not None and len(cfg.box) == 3:
        return _ewald_apply_fn(cfg, multi=False)
    if cfg.farfield_grid is not None:
        return _farfield_apply_fn(cfg)
    if cfg.use_pallas and cfg.dtype == torch.float32:
        def apply_kernel(F, r):
            return rpy_cuda.mobility_apply(F, r, a=cfg.a, eta=cfg.eta,
                                           wall=cfg.wall,
                                           h_floor=cfg.wall_h_floor)
        return apply_kernel

    def apply_plain(F, r):
        return rpy.mobility_apply(F, r, a=cfg.a, eta=cfg.eta, wall=cfg.wall,
                                  row_tile=cfg.matvec_row_tile,
                                  h_floor=cfg.wall_h_floor)
    return apply_plain


def mobility_apply_multi_fn(cfg: SimulationConfig):
    """Multi-RHS product (Fs (k,N,3), r (N,3)) → (k,N,3) sharing the pair
    fields across RHS (kernel K2 on the card for the fused two-draw
    noise; the far field's ndim-polymorphic apply with ``farfield_grid``;
    the Ewald operator with a 3-D box)."""
    if cfg.box is not None and len(cfg.box) == 3:
        return _ewald_apply_fn(cfg, multi=True)
    if cfg.farfield_grid is not None:
        return _farfield_apply_fn(cfg)
    if cfg.use_pallas and cfg.dtype == torch.float32:
        def apply_kernel(Fs, r):
            return rpy_cuda.mobility_apply_multi(Fs, r, a=cfg.a, eta=cfg.eta,
                                                 wall=cfg.wall,
                                                 h_floor=cfg.wall_h_floor)
        return apply_kernel

    def apply_plain(Fs, r):
        return rpy.mobility_apply_multi(Fs, r, a=cfg.a, eta=cfg.eta,
                                        wall=cfg.wall,
                                        row_tile=cfg.matvec_row_tile,
                                        h_floor=cfg.wall_h_floor)
    return apply_plain


@functools.lru_cache(maxsize=8)
def _ewald_params(box, a, eta, xi, tol):
    """``ewald.make_params`` (the host Chebyshev fit, tens of milliseconds
    and more) once per configuration: a step asks for the operator anew,
    and the arrays of the result are never written to."""
    return ewald.make_params(box, a, eta, xi=xi, tol=tol)


def _ewald_apply_fn(cfg: SimulationConfig, multi: bool):
    """Triply-periodic positively-split Ewald operator (:mod:`.ewald`) for a
    3-D ``cfg.box``.  Monodisperse float32 with ``use_pallas`` sweeps the
    real-space part through kernel K4 (:mod:`.ewald_cuda`); anything else
    takes the plain sweep (closed-form scalars in float64).  The config
    already refuses the balanced split (``ewald_rc``, ``ewald_grid_p``)."""
    params = _ewald_params(cfg.box, cfg.a, cfg.eta,
                           cfg.ewald_xi if cfg.ewald_xi > 0 else None,
                           cfg.ewald_tol)
    if cfg.use_pallas and cfg.dtype == torch.float32:
        kernel = (ewald_cuda.mobility_apply_multi if multi
                  else ewald_cuda.mobility_apply)

        def apply_kernel(F, r):
            return kernel(F, r, params)
        return apply_kernel
    plain = ewald.mobility_apply_multi if multi else ewald.mobility_apply

    def apply_plain(F, r):
        return plain(F, r, params, row_tile=cfg.matvec_row_tile)
    return apply_plain


def _farfield_apply_fn(cfg: SimulationConfig):
    """Proxy-grid near + far mobility (:mod:`.farfield`), O(N) at fixed
    density.  It takes (N, 3) or (k, N, 3) forces, so it serves both
    apply-fn entry points; float32 with ``use_pallas`` sweeps the near part
    through kernel K3.

    The returned callable carries ``prepare`` / ``prepare_geometry``
    attributes: loop hosts build the position setup once with
    :func:`hoist_positions`, and a step shares one kernel-lattice build
    across its position sets with :func:`pin_geometry`."""
    grid = None if cfg.farfield_grid == "auto" else cfg.farfield_grid
    max_nbr = cfg.farfield_nbr_tiles if cfg.farfield_nbr_tiles > 0 else None
    kw = dict(a=cfg.a, eta=cfg.eta, wall=cfg.wall, grid=grid,
              p=cfg.farfield_p, max_nbr=max_nbr, h_floor=cfg.wall_h_floor)

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
    slip = mob_apply(lam.reshape(-1, 3), ops.flat_positions)
    slip = slip.reshape(B, n, 3) - kin.K_dot(U, ops.offsets)
    F = kin.KT_dot(lam_b, ops.offsets)
    return slip.reshape(-1, 3), F


class PCData(NamedTuple):
    """Preconditioner factors for one configuration (see the JAX PCData).

    inv_m_diag: (N, 3, 3) per-blob inverse self mobilities (diag) or None.
    inv_m_block: (B, 3n, 3n) per-body inverse mobility blocks (block) or None.
    n_mat: (B, 6, 6) Ñ⁻¹ = Kᵀ M̃⁻¹ K blocks, solved per application.
    minv_ref / n_ref: body-frame constants of ``block_free``: the free-space
      per-body mobility inverse (3n, 3n) and N̂ = (K̂ᵀ M̂⁻¹ K̂)⁻¹ (6, 6).
    """

    inv_m_diag: Optional[torch.Tensor]
    inv_m_block: Optional[torch.Tensor]
    n_mat: Optional[torch.Tensor]
    minv_ref: Optional[torch.Tensor] = None
    n_ref: Optional[torch.Tensor] = None


# floor (relative to the free 4/3 self mobility) on the diag PC's self blocks
_PC_SELF_FLOOR = 0.05


def build_pc(ops: GeometryOps, cfg: SimulationConfig) -> PCData:
    B, n, _ = ops.offsets.shape
    mode = cfg.pc_mode or ("block" if cfg.block_diag_pc else "diag")
    if mode not in ("diag", "block", "block_free"):
        raise ValueError(f"unknown pc_mode {mode!r}; use diag, block or "
                         "block_free")
    if mode == "block_free":
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
        inv_m_block = torch.stack([
            torch.linalg.inv(rpy.mobility_matrix(
                pos_b, cfg.a, cfg.eta, cfg.wall, h_floor=cfg.wall_h_floor))
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


def _inv_m_apply(pc: PCData, v, ops: GeometryOps):
    """M̃⁻¹ · v for any PC flavor; v and the result (B, n, 3)."""
    B, n, _ = v.shape
    if pc.minv_ref is not None:
        v_body = torch.einsum("bji,bnj->bni", ops.rot, v).reshape(B, 3 * n)
        w = torch.einsum("pq,bq->bp", pc.minv_ref, v_body).reshape(B, n, 3)
        return torch.einsum("bij,bnj->bni", ops.rot, w)
    if pc.inv_m_block is not None:
        vf = v.reshape(B, 3 * n)
        return torch.einsum("bij,bj->bi", pc.inv_m_block, vf).reshape(B, n, 3)
    blocks = pc.inv_m_diag.reshape(B, n, 3, 3)
    return torch.einsum("bkij,bkj->bki", blocks, v)


def _n_solve(pc: PCData, rhs, ops: GeometryOps):
    """Solve Ñ⁻¹ U = rhs per body; rhs (B, 6)."""
    if pc.n_ref is not None:
        f_b = torch.einsum("bji,bj->bi", ops.rot, rhs[:, 0:3])
        t_b = torch.einsum("bji,bj->bi", ops.rot, rhs[:, 3:6])
        u_body = torch.einsum("pq,bq->bp", pc.n_ref,
                              torch.cat([f_b, t_b], dim=-1))
        u = torch.einsum("bij,bj->bi", ops.rot, u_body[:, 0:3])
        om = torch.einsum("bij,bj->bi", ops.rot, u_body[:, 3:6])
        return torch.cat([u, om], dim=-1)
    return torch.linalg.solve(pc.n_mat, rhs[..., None])[..., 0]


def apply_pc(pc: PCData, slip, F, ops: GeometryOps, cfg: SimulationConfig):
    """Apply the saddle preconditioner: (slip (N,3), F (B,6)) → (λ, U)."""
    B, n, _ = ops.offsets.shape
    slip_b = slip.reshape(B, n, 3)
    im_slip = _inv_m_apply(pc, slip_b, ops)
    rhs = -F - kin.KT_dot(im_slip, ops.offsets)
    U = _n_solve(pc, rhs, ops)
    lam = _inv_m_apply(pc, slip_b + kin.K_dot(U, ops.offsets), ops)
    return (cfg.m_scale * lam).reshape(-1, 3), U
