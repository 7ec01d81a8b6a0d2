"""Plain rigid-body saddle problem: its residual and a solve.

The mobility problem of rigid bodies made of blobs is

    M λ − K U = s,    Kᵀ λ = F

for the blob forces λ (N, 3) and the body velocities U (B, 6) = (v, ω),
with (K U)ᵢ = v + ω × (rᵢ − X) and Kᵀλ = (Σ λᵢ, Σ (rᵢ − X) × λᵢ) over a
body's blobs (Swan, Brady, Moore, J. Chem. Phys. 135, 014701 (2011);
Balboa Usabiaga et al., Commun. Appl. Math. Comput. Sci. 11, 217 (2016)).

:func:`residual_gap` judges a given (λ, U): the first equation at the
rows the check samples, the second at every body.  :func:`solve` is the
control's solve: restarted GMRES, right-preconditioned by each body's
free-space block (the body's own blobs, in its frame, inverted once and
rotated), with any mobility product as its operator.  It stops at the
tolerance, or where its residual stalls: a solve in TF32 levels off near
TF32's own rounding, and iterating on would change nothing.
"""

from __future__ import annotations

from typing import Callable

import torch

from benchmark.reference.rpy import _free_blocks


def k_dot(U, off):
    """K·U: (B, 6) → (B, n, 3) at body-frame offsets rotated to the world,
    ``off`` (B, n, 3)."""
    return U[:, None, :3] + torch.linalg.cross(
        U[:, None, 3:].expand_as(off), off, dim=-1)


def kt_dot(lam, off):
    """Kᵀ·λ: (B, n, 3) → (B, 6)."""
    return torch.cat([lam.sum(1),
                      torch.linalg.cross(off, lam, dim=-1).sum(1)], dim=-1)


def residual_gap(M_lam_rows, rows, lam, U, slip, force, off):
    """The larger of the two equations' gaps of (λ, U):

    the first at ``rows``: max |Mλ − KU − s| over max |Mλ| there
    (``M_lam_rows`` is the reference's Mλ at those rows); the second at
    every body: max |Kᵀλ − F| over max Σ|λᵢ| (forces) and
    max Σ|rᵢ − X||λᵢ| (torques) of a body."""
    B, n, _ = off.shape
    KU = k_dot(U, off).reshape(-1, 3)[rows]
    first = ((M_lam_rows - KU - slip.reshape(-1, 3)[rows]).abs().max()
             / M_lam_rows.abs().max())
    lam = lam.reshape(B, n, 3)
    got = kt_dot(lam, off) - force
    size = torch.linalg.norm(lam, dim=-1)
    f_scale = size.sum(1).max()
    t_scale = (torch.linalg.norm(off, dim=-1) * size).sum(1).max()
    second = torch.maximum(got[:, :3].abs().max() / f_scale,
                           got[:, 3:].abs().max() / t_scale)
    return max(float(first), float(second))


class BodyBlockPC:
    """The block-diagonal saddle preconditioner of one body shape: M̂⁻¹ of
    the body's free-space blob mobility in its own frame and
    N̂ = (K̂ᵀ M̂⁻¹ K̂)⁻¹, applied per body after rotating into its frame."""

    def __init__(self, ref, a, eta, dtype, device):
        r = torch.as_tensor(ref, dtype=torch.float64, device=device)
        n = r.shape[0]
        d = (r[:, None, :] - r[None, :, :]) / a
        rr = torch.sqrt(torch.sum(d * d, dim=-1))
        c1, c2 = _free_blocks(d, rr, a)
        eye = torch.eye(3, dtype=torch.float64, device=device)
        selfp = torch.eye(n, dtype=torch.bool, device=device)
        c1 = torch.where(selfp, torch.full_like(c1, 4.0 / 3.0), c1)
        c2 = torch.where(selfp, torch.zeros_like(c2), c2)
        M = (c1[..., None, None] * eye
             + c2[..., None, None] * d[..., :, None] * d[..., None, :])
        M = M.permute(0, 2, 1, 3).reshape(3 * n, 3 * n) \
            / (8.0 * torch.pi * eta * a)
        minv = torch.cholesky_inverse(torch.linalg.cholesky(M))
        K = torch.zeros((n, 3, 6), dtype=torch.float64, device=device)
        K[:, :, :3] = eye
        K[:, 0, 4], K[:, 0, 5] = r[:, 2], -r[:, 1]
        K[:, 1, 3], K[:, 1, 5] = -r[:, 2], r[:, 0]
        K[:, 2, 3], K[:, 2, 4] = r[:, 1], -r[:, 0]
        K = K.reshape(3 * n, 6)
        self.minv = minv.to(dtype)
        self.K = K.to(dtype)
        self.nhat = torch.linalg.inv(K.T @ minv @ K).to(dtype)

    def apply(self, s, f, R):
        """(λ, U) of each body's own saddle block for the right-hand side
        (s (B, n, 3), f (B, 6)) with rotations R (B, 3, 3)."""
        B, n, _ = s.shape
        s_b = torch.einsum("bji,bkj->bki", R, s).reshape(B, 3 * n)
        f_b = torch.cat([torch.einsum("bji,bj->bi", R, f[:, :3]),
                         torch.einsum("bji,bj->bi", R, f[:, 3:])], dim=-1)
        t = s_b @ self.minv.T
        U_b = (f_b - t @ self.K) @ self.nhat.T
        lam_b = (t + (U_b @ self.K.T) @ self.minv.T).reshape(B, n, 3)
        lam = torch.einsum("bij,bkj->bki", R, lam_b)
        U = torch.cat([torch.einsum("bij,bj->bi", R, U_b[:, :3]),
                       torch.einsum("bij,bj->bi", R, U_b[:, 3:])], dim=-1)
        return lam, U


STALL = 5     # iterations over which the residual has to halve


def solve(mob: Callable, off, R, slip, force, pc: BodyBlockPC, tol,
          restart, maxiter):
    """(λ (B, n, 3), U (B, 6), relative residual, iterations) of the saddle
    problem with the mobility product ``mob`` (F (N, 3) → U (N, 3)), by
    GMRES right-preconditioned with ``pc``, in the dtype of ``off``; it
    ends at ``tol``, at ``maxiter``, or where the residual did not halve
    over the last STALL iterations."""
    B, n, _ = off.shape
    nl = B * n * 3

    def split(x):
        return x[:nl].reshape(B, n, 3), x[nl:].reshape(B, 6)

    def A(x):
        lam, U = split(x)
        first = mob(lam.reshape(-1, 3)).reshape(B, n, 3) - k_dot(U, off)
        return torch.cat([first.reshape(-1), kt_dot(lam, off).reshape(-1)])

    def P(y):
        lam, U = pc.apply(*split(y), R)
        return torch.cat([lam.reshape(-1), U.reshape(-1)])

    b = torch.cat([slip.reshape(-1), force.reshape(-1)]).to(off.dtype)
    bnorm = torch.linalg.norm(b)
    x = torch.zeros_like(b)
    r = b.clone()
    done, trail, stalled = 0, [], False
    while not stalled and done < maxiter \
            and float(torch.linalg.norm(r) / bnorm) > tol:
        beta = torch.linalg.norm(r)
        m = min(restart, maxiter - done)
        V, Z = [r / beta], []
        H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
        for k in range(m):
            Z.append(P(V[k]))
            w = A(Z[k])
            for i in range(k + 1):            # modified Gram–Schmidt
                H[i, k] = torch.dot(w, V[i])
                w = w - H[i, k] * V[i]
            H[k + 1, k] = torch.linalg.norm(w)
            V.append(w / H[k + 1, k])
            e1 = torch.zeros((k + 2, 1), dtype=b.dtype, device=b.device)
            e1[0] = beta
            y = torch.linalg.lstsq(H[:k + 2, :k + 1], e1).solution
            done += 1
            trail.append(float(torch.linalg.norm(H[:k + 2, :k + 1] @ y - e1)
                               / bnorm))
            stalled = len(trail) > STALL \
                and trail[-1] > 0.5 * trail[-1 - STALL]
            if trail[-1] <= tol or stalled:
                break
        x = x + sum(yi * zi for yi, zi in zip(y[:, 0], Z))
        r = b - A(x)
    lam, U = split(x)
    return lam, U, float(torch.linalg.norm(r) / bnorm), done
