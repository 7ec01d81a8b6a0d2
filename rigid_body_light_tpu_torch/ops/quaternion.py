"""Quaternion utilities (scalar-first q = (w, x, y, z)) — the port of
``rigid_body_light_tpu/ops/quaternion.py``.  Shapes (..., 4), batched on
leading axes."""

from __future__ import annotations

import torch


def normalize(q):
    """Unit-normalize quaternions along the last axis."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def multiply(q1, q2):
    """Hamilton product q1 ∘ q2, scalar-first, broadcasting on leading axes."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def to_rotation_matrix(q):
    """(..., 4) unit quaternions → (..., 3, 3) rotation matrices."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one = torch.ones_like(w)
    r = torch.stack(
        [
            one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def from_rotation_vector(om):
    """Axis-angle exponential: (..., 3) rotation vectors → (..., 4) quats.

    q = (cos(|ω|/2), sin(|ω|/2) ω/|ω|), with the |ω|→0 limit taken by the
    Taylor series below |ω|² = 1e-12, as the JAX version does.
    """
    norm2 = torch.sum(om * om, dim=-1, keepdim=True)
    small = norm2 < 1e-12
    norm = torch.sqrt(torch.where(small, torch.ones_like(norm2), norm2))
    half = 0.5 * norm
    w = torch.where(small, 1.0 - norm2 / 8.0, torch.cos(half))
    # sin(n/2)/n with series fallback: 1/2 - n^2/48 + O(n^4)
    factor = torch.where(small, 0.5 - norm2 / 48.0, torch.sin(half) / norm)
    return normalize(torch.cat([w, factor * om], dim=-1))


def rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    return torch.einsum("...ij,...j->...i", to_rotation_matrix(q), v)
