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

from typing import NamedTuple, Optional

import torch

from rigid_body_light_tpu_torch.config import SimulationConfig
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
    iff ``cfg.wall``.  float32 with ``use_pallas`` goes through the CUDA
    pair-sweep wrappers (kernel K1 on the card); otherwise the plain
    sweep."""
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
    noise)."""
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
