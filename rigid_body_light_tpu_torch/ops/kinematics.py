"""Rigid-body kinematic operators — the port of
``rigid_body_light_tpu/ops/kinematics.py``.

For body j with world-frame blob offsets r_k = R(Q_j)·ref_k:

    (K U)_{jk} = u_j + ω_j × r_k                  [(B,n,3) from (B,6)]
    (Kᵀ λ)_j   = (Σ_k λ_k, Σ_k r_k × λ_k)         [(B,6) from (B,n,3)]
    (KᵀK)⁻¹_j  = blkdiag(I/n, (Σ|ref|² I − R·MOI·Rᵀ)⁻¹)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rigid_body_light_tpu_torch.ops import quaternion as quat


class RefGeometry(NamedTuple):
    """Constants of the centered reference configuration.

    ref_cfg: (n, 3) blob positions in the body frame, centered at their mean.
    sum_r2: Σ_k |ref_k|² (0-d tensor).
    moi: Σ_k ref_k ref_kᵀ (3, 3).
    """

    ref_cfg: torch.Tensor
    sum_r2: torch.Tensor
    moi: torch.Tensor

    @property
    def n_blobs(self) -> int:
        return self.ref_cfg.shape[0]


def make_ref_geometry(ref_cfg, dtype=torch.float32, device=None) -> RefGeometry:
    ref = torch.as_tensor(ref_cfg, dtype=dtype, device=device).reshape(-1, 3)
    ref = ref - torch.mean(ref, dim=0, keepdim=True)
    return RefGeometry(ref_cfg=ref, sum_r2=torch.sum(ref * ref),
                       moi=torch.einsum("ki,kj->ij", ref, ref))


def blob_offsets(geom: RefGeometry, Q) -> torch.Tensor:
    """World-frame blob offsets r_k = R(Q)·ref_k, shape (B, n, 3)."""
    R = quat.to_rotation_matrix(Q)
    return torch.einsum("bij,kj->bki", R, geom.ref_cfg)


def blob_positions(geom: RefGeometry, X, Q) -> torch.Tensor:
    """World-frame blob positions, shape (B, n, 3)."""
    return blob_offsets(geom, Q) + X[:, None, :]


def K_dot(U, offsets) -> torch.Tensor:
    """K·U: body velocities (B, 6) → blob velocities (B, n, 3)."""
    u = U[:, None, 0:3]
    om = U[:, None, 3:6].expand_as(offsets)
    return u + torch.linalg.cross(om, offsets, dim=-1)


def KT_dot(lam, offsets) -> torch.Tensor:
    """Kᵀ·λ: blob forces (B, n, 3) → body force/torque (B, 6)."""
    f = torch.sum(lam, dim=1)
    tau = torch.sum(torch.linalg.cross(offsets, lam, dim=-1), dim=1)
    return torch.cat([f, tau], dim=-1)


def ktk_inv(geom: RefGeometry, Q) -> torch.Tensor:
    """(KᵀK)⁻¹ per body, shape (B, 6, 6); block-diagonal closed form."""
    B = Q.shape[0]
    n = geom.n_blobs
    R = quat.to_rotation_matrix(Q)
    eye3 = torch.eye(3, dtype=Q.dtype, device=Q.device)
    D = geom.sum_r2 * eye3 - torch.einsum("bij,jk,blk->bil", R, geom.moi, R)
    out = torch.zeros((B, 6, 6), dtype=Q.dtype, device=Q.device)
    out[:, 0:3, 0:3] = eye3 / n
    out[:, 3:6, 3:6] = torch.linalg.inv(D)
    return out


def Kinv_dot(V, offsets, ktkinv) -> torch.Tensor:
    """K⁺·V = (KᵀK)⁻¹ Kᵀ V: blob velocities (B, n, 3) → body (B, 6)."""
    return torch.einsum("bij,bj->bi", ktkinv, KT_dot(V, offsets))


def KinvT_dot(W, offsets, ktkinv) -> torch.Tensor:
    """K⁺ᵀ·W = K (KᵀK)⁻¹ W: body (B, 6) → blob (B, n, 3)."""
    return K_dot(torch.einsum("bij,bj->bi", ktkinv, W), offsets)


def update_X_Q(X, Q, dU):
    """Advance body configs by dU (B, 6) = (ΔX, Δθ axis-angle):
    X += ΔX, Q ← exp(Δθ) ∘ Q, renormalized.  Non-mutating."""
    X_new = X + dU[:, 0:3]
    q_rot = quat.from_rotation_vector(dU[:, 3:6])
    Q_new = quat.normalize(quat.multiply(q_rot, Q))
    return X_new, Q_new
