"""Restarted GMRES — the port of ``rigid_body_light_tpu/ops/gmres.py``.

Same algorithm: a flat Krylov basis V (m+1, n) orthogonalized by classical
Gram–Schmidt applied twice (CGS2), a Givens QR of the Hessenberg column
per iteration so the residual estimate |g[j]| is known inside the cycle,
early exit from the cycle once it falls to ``atol``, back substitution on
the executed block only, and restart cycles that exit on the true
residual.

Where JAX skips the rest of a cycle with ``lax.cond``, the port breaks out
of a Python loop: one host sync per inner iteration.  The O(m) Givens and
Hessenberg scalars live on the host (numpy, in the run dtype); the O(n)
basis and the matvecs stay on the device of ``b``.

Distributed mode (``group``, a ``torch.distributed`` process group; the
JAX package's ``axis_name``): vectors are this rank's shard of the
unknown, and every inner product and norm is all-reduced over the group
before it reaches the host, so every rank computes the same Givens and
Hessenberg scalars and takes the same branches; the basis stays sharded.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from rigid_body_light_tpu_torch.utils.collectives import psum


class GmresResult(NamedTuple):
    x: torch.Tensor
    residual: torch.Tensor  # relative preconditioned residual ‖P(b−Ax)‖/‖Pb‖
    iters: int              # inner iterations executed (exact)


def _np_dtype(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _cycle(matvec: Callable, x0, r0, m: int, atol, group=None):
    """One GMRES(m) cycle from residual r0 → (x_new, n_exec)."""
    n = r0.shape[0]
    dtype, dev = r0.dtype, r0.device
    npdt = _np_dtype(dtype)
    tiny = npdt(1e-30)
    beta = torch.sqrt(psum(torch.sum(r0 * r0), group))
    v0 = r0 / torch.clamp(beta, min=1e-30)
    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
    V[0] = v0
    R = np.zeros((m, m), npdt)       # upper-triangular factor of H
    cs = np.zeros((m,), npdt)
    sn = np.zeros((m,), npdt)
    g = np.zeros((m + 1,), npdt)     # rotated RHS; |g[j]| = residual estimate
    g[0] = beta.item()
    n_exec = 0
    for j in range(m):
        if not abs(g[j]) > atol:
            break
        w = matvec(V[j])
        # CGS2: project twice against the whole basis (unset rows are zero)
        h1 = psum(V @ w, group)
        w = w - h1 @ V
        h2 = psum(V @ w, group)
        w = w - h2 @ V
        hn = torch.sqrt(psum(torch.sum(w * w), group))
        V[j + 1] = w / torch.clamp(hn, min=1e-30)
        col = (h1 + h2).cpu().numpy()
        col[j + 1] = hn.item()
        for i in range(j):          # the j previous rotations
            a, b = col[i], col[i + 1]
            col[i] = cs[i] * a + sn[i] * b
            col[i + 1] = -sn[i] * a + cs[i] * b
        # new rotation; the stored diagonal is floored so a breakdown sends
        # the matching y component to ~0 instead of NaN
        denom = np.sqrt(col[j] ** 2 + col[j + 1] ** 2)
        c = col[j] / np.maximum(denom, tiny)
        s = col[j + 1] / np.maximum(denom, tiny)
        col[j] = np.maximum(denom, tiny)
        col[j + 1] = 0.0
        g[j], g[j + 1] = c * g[j], -s * g[j]
        R[:, j] = col[:m]
        cs[j], sn[j] = c, s
        n_exec += 1
    if n_exec == 0:
        return x0, 0
    y = torch.linalg.solve_triangular(
        torch.from_numpy(R[:n_exec, :n_exec]),
        torch.from_numpy(g[:n_exec])[:, None], upper=True)[:, 0]
    return x0 + y.to(dev) @ V[:n_exec], n_exec


def gmres(matvec: Callable, b, x0=None, tol: float = 1e-6, restart: int = 40,
          max_restarts: int = 5, group=None) -> GmresResult:
    """Solve matvec(x) = b for flat vectors; restarted, early-exiting.
    group: distributed mode, ``b`` / ``x0`` this rank's shard."""
    b = b.reshape(-1)
    npdt = _np_dtype(b.dtype)
    if x0 is None:
        x0 = torch.zeros_like(b)
    b_norm = torch.clamp(torch.sqrt(psum(torch.sum(b * b), group)),
                         min=1e-30)
    atol = npdt(tol) * npdt(b_norm.item())
    atol2 = atol * atol
    x = x0
    r = b - matvec(x)
    k = it = 0
    while (k < max_restarts
           and npdt(psum(torch.sum(r * r), group).item()) > atol2):
        x, n_exec = _cycle(matvec, x, r, restart, atol, group)
        r = b - matvec(x)
        k += 1
        it += n_exec
    return GmresResult(x=x, residual=torch.sqrt(psum(torch.sum(r * r), group))
                       / b_norm, iters=it)
