"""Plain commit of a Brownian-dynamics step: bodies advanced by
dU = U·dt, X ← X + ΔX, Q ← exp(Δθ) ∘ Q (scalar-first Hamilton product,
normalized), a body's move refused where it translates ΔX ≥ max_move·a,
turns |Δθ| ≥ max_rotation or sinks a blob below the wall, and the whole
step refused where its solve's residual is not below max_step_residual.
"""

from __future__ import annotations

import torch

from benchmark.reference.arith import Arith
from benchmark.reference.rpy import rotation


def quat_exp(om):
    """(B, 3) rotation vectors → (B, 4) unit quaternions."""
    th = torch.linalg.norm(om, dim=-1, keepdim=True)
    safe = torch.where(th > 0, th, torch.ones_like(th))
    s = torch.where(th > 0, torch.sin(safe / 2) / safe,
                    torch.full_like(th, 0.5))
    return torch.cat([torch.cos(th / 2), s * om], dim=-1)


def hamilton(p, q):
    w1, x1, y1, z1 = p.unbind(-1)
    w2, x2, y2, z2 = q.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def commit(X, Q, U, residual, ref, sim, ar: Arith):
    """(X', Q') of the step that solved U (B, 6) with ``residual``, under
    the configuration ``sim`` (a dict of the simulation's settings: dt, a,
    wall, max_move, max_rotation, max_step_residual, reject_below_wall)."""
    X, Q = ar.op(X), ar.op(Q)
    if not float(residual) < sim["max_step_residual"]:
        return X, Q
    dU = ar.op(U) * sim["dt"]
    X_new = X + dU[:, :3]
    Q_new = ar.op(hamilton(ar.op(quat_exp(dU[:, 3:])), Q))
    Q_new = Q_new / torch.linalg.norm(Q_new, dim=-1, keepdim=True)
    ok = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    if sim["max_move"] > 0:
        ok &= torch.linalg.norm(dU[:, :3], dim=-1) < sim["max_move"] * sim["a"]
    if sim["max_rotation"] > 0:
        ok &= torch.linalg.norm(dU[:, 3:], dim=-1) < sim["max_rotation"]
    if sim["wall"] and sim["reject_below_wall"]:
        refd = torch.as_tensor(ref, dtype=X.dtype, device=X.device)
        z = torch.einsum("bij,kj->bki", rotation(Q_new), refd)[..., 2] \
            + X_new[:, None, 2]
        ok &= (z > 0).all(dim=1)
    return (torch.where(ok[:, None], X_new, X),
            torch.where(ok[:, None], Q_new, Q))
