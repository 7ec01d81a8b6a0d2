"""Brownian increments M^{1/2}·W by Lanczos — the port of
``rigid_body_light_tpu/ops/lanczos.py`` (one device).

m Lanczos iterations with the matrix-free damped mobility product build a
tridiagonal T and an orthonormal basis V; then
M^{1/2} W ≈ ‖W‖ · Vᵀ · (V_T √Λ V_Tᵀ) e₁, for a fixed m or, adaptively,
until the truncation estimate falls to a tolerance.  Preconditioned with
the body-frame free-space factor (``m_half_w_precond``,
``make_noise_preconditioner``), or on the plain blob space (``m_half_w``,
and ``m_half_w_pair`` for two draws through the fused 2-RHS product).

The Gaussian draws W are inputs: the caller makes them (from a
``torch.Generator``, or the JAX package's keys in the parity tests).

Distributed mode (``group``, a ``torch.distributed`` process group; the
JAX package's ``axis_name``): W's rows are this rank's shard, the inner
products are all-reduced over the group, so every rank runs the same
recurrence and stops at the same iteration, and the basis stays sharded.
"""

from __future__ import annotations

from typing import Callable

import torch

from rigid_body_light_tpu_torch.ops import rpy, saddle
from rigid_body_light_tpu_torch.utils import profiling
from rigid_body_light_tpu_torch.utils.collectives import psum


def _y_coeffs(alphas, betas, s, m):
    """√T·e₁ coefficients of the size-``s`` leading block of the tridiagonal.

    alphas/betas: (k, m) recurrence coefficients.  The block beyond ``s`` is
    masked to the identity with its coupling zeroed, so its spurious
    eigenpairs have zero e₁-projection; eigenvalues are clamped at 0.
    """
    idx = torch.arange(m, device=alphas.device)
    a = torch.where(idx < s, alphas, torch.ones_like(alphas))
    b = torch.where(idx < s - 1, betas, torch.zeros_like(betas))
    T = torch.zeros(alphas.shape + (m,), dtype=alphas.dtype,
                    device=alphas.device)
    T[:, idx, idx] = a
    T[:, idx[:-1], idx[1:]] = b[:, :-1]
    T[:, idx[1:], idx[:-1]] = b[:, :-1]
    evals, evecs = torch.linalg.eigh(T)
    sq = torch.sqrt(torch.clamp(evals, min=0.0))
    e1_proj = evecs[:, 0, :]
    return torch.einsum("kmj,kj->km", evecs, sq * e1_proj)


def _trunc_err(alphas, betas, s, m):
    """Relative (s−1 → s) truncation estimate per batch row, shape (k,)."""
    y = _y_coeffs(alphas, betas, s, m)
    y_prev = _y_coeffs(alphas, betas, s - 1, m)
    num = torch.linalg.norm(y - y_prev, dim=1)
    den = torch.clamp(torch.linalg.norm(y, dim=1), min=1e-30)
    return num / den


def sqrt_matvec_batched(matvec: Callable, W, iters: int = 30,
                        max_iters: int = 0, err_tol: float = 0.0,
                        return_err: bool = False, return_iters: bool = False,
                        group=None):
    """A^{1/2}·w_k for a batch W (k, sz) with a joint matvec (k, sz) →
    (k, sz), with full reorthogonalization.  Returns (k, sz); with
    ``return_err`` also the truncation estimate err (k,), with
    ``return_iters`` also the iterations run (an int), in that order.

    Fixed mode runs ``iters`` iterations.  Adaptive mode (``max_iters >
    iters`` and ``err_tol > 0``, as in the JAX package) allocates the basis
    at ``max_iters``, runs at least ``iters`` iterations and goes on, up to
    ``max_iters``, while the largest estimate exceeds ``err_tol``.

    The m×m eigensolves run on the host (they are tiny); the O(sz) basis
    stays on the device of ``W``.  group: distributed mode (the module
    docstring).
    """
    k, sz = W.shape
    dtype, dev = W.dtype, W.device
    adaptive = max_iters > iters and err_tol > 0.0
    m = max_iters if adaptive else iters
    norm_w = torch.sqrt(psum(torch.sum(W * W, dim=1), group))
    V = torch.zeros((k, m, sz), dtype=dtype, device=dev)
    V[:, 0] = W / torch.clamp(norm_w, min=1e-30)[:, None]
    alphas = torch.zeros((k, m), dtype=dtype, device=dev)
    betas = torch.zeros((k, m), dtype=dtype, device=dev)
    v_prev = torch.zeros((k, sz), dtype=dtype, device=dev)
    beta_prev = torch.zeros((k,), dtype=dtype, device=dev)
    i = 0
    while i < iters or (
            adaptive and i < m
            and torch.max(_trunc_err(alphas.cpu(), betas.cpu(), i, m))
            > err_tol):
        v = V[:, i].clone()
        av = matvec(v)
        alpha = psum(torch.einsum("ks,ks->k", v, av), group)
        r = av - alpha[:, None] * v - beta_prev[:, None] * v_prev
        # full reorthogonalization against the basis built so far (rows
        # ≥ i+1 are still zero) — keeps small m accurate in float32
        proj = psum(torch.einsum("kms,ks->km", V, r), group)
        r = r - torch.einsum("km,kms->ks", proj, V)
        beta = torch.sqrt(psum(torch.sum(r * r, dim=1), group))
        if i + 1 < m:
            V[:, i + 1] = r / torch.clamp(beta, min=1e-30)[:, None]
        alphas[:, i] = alpha
        betas[:, i] = beta
        v_prev, beta_prev = v, beta
        i += 1
    a_h, b_h = alphas.cpu(), betas.cpu()
    y = _y_coeffs(a_h, b_h, i, m).to(dev)
    out = norm_w[:, None] * torch.einsum("km,kms->ks", y, V)
    extra = ()
    if return_err:
        extra += (_trunc_err(a_h, b_h, i, m).to(dev),)
    if return_iters:
        extra += (i,)
    return (out,) + extra if extra else out


def sqrt_matvec(matvec: Callable, w, iters: int = 30):
    """A^{1/2}·w for an SPD operator ``matvec`` on (sz,) vectors."""
    return sqrt_matvec_batched(lambda vk: matvec(vk[0])[None], w[None],
                               iters=iters)[0]


def m_half_w(mob_apply: Callable, positions, W, iters: int = 30,
             max_iters: int = 0, err_tol: float = 0.0,
             return_err: bool = False, group=None):
    """M^{1/2}W on the blob space from a Gaussian draw ``W`` (3N,) in the
    blob layout (x, y, z of blob 0, then blob 1, …), without the body-frame
    preconditioner.  mob_apply: (F (N,3), r (N,3)) → (N,3), the damped
    product.  Returns (N, 3), or ((N, 3), the truncation estimate) with
    ``return_err``; ``max_iters`` / ``err_tol``: the adaptive recurrence of
    :func:`sqrt_matvec_batched`; group: distributed mode."""
    positions = positions.reshape(-1, 3)
    mob_apply = saddle.hoist_positions(mob_apply, positions)

    def mv(vk):
        with profiling.span("mobility"):
            return mob_apply(vk[0].reshape(-1, 3), positions).reshape(1, -1)

    out = sqrt_matvec_batched(mv, W.reshape(1, -1).to(positions.dtype),
                              iters=iters, max_iters=max_iters,
                              err_tol=err_tol, return_err=return_err,
                              group=group)
    if return_err:
        out, err = out
        return out[0].reshape(-1, 3), err[0]
    return out[0].reshape(-1, 3)


def m_half_w_pair(mob_apply_multi: Callable, positions, W, iters: int = 30,
                  max_iters: int = 0, err_tol: float = 0.0,
                  return_err: bool = False, group=None):
    """Two independent M^{1/2}W draws from ``W`` (2, 3N) (blob layout, as
    :func:`m_half_w`), both recurrences through one 2-RHS product
    ``mob_apply_multi`` ((2, N, 3), r) → (2, N, 3) a step.  Returns
    ((N, 3), (N, 3)), plus the larger truncation estimate with
    ``return_err``; group: distributed mode."""
    positions = positions.reshape(-1, 3)
    mob_apply_multi = saddle.hoist_positions(mob_apply_multi, positions)

    def mv2(vk):
        with profiling.span("mobility"):
            return mob_apply_multi(vk.reshape(2, -1, 3),
                                   positions).reshape(2, -1)

    out = sqrt_matvec_batched(mv2, W.reshape(2, -1).to(positions.dtype),
                              iters=iters, max_iters=max_iters,
                              err_tol=err_tol, return_err=return_err,
                              group=group)
    if return_err:
        out, err = out
        return (out[0].reshape(-1, 3), out[1].reshape(-1, 3),
                torch.max(err))
    return out[0].reshape(-1, 3), out[1].reshape(-1, 3)


def make_noise_preconditioner(ref_cfg, a, eta):
    """Body-frame factor constants (L, L⁻¹), each (3n, 3n): L = chol of the
    free-space per-body mobility M_ref, computed once per geometry in the
    dtype and on the device of ``ref_cfg``."""
    m_ref = rpy.mobility_matrix(ref_cfg, a, eta, wall=False)
    L = torch.linalg.cholesky(m_ref)
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
    return L, L_inv


def _rot_apply(rot, v, transpose=False):
    """Apply blkdiag(R, ..., R) per body: v (B, n, 3) → (B, n, 3)."""
    eq = "bji,bnj->bni" if transpose else "bij,bnj->bni"
    return torch.einsum(eq, rot, v)


def m_half_w_precond(mob_apply_or_multi: Callable, positions, rot, L, L_inv,
                     W, iters: int = 10, multi: bool = False,
                     return_err: bool = False, max_iters: int = 0,
                     err_tol: float = 0.0, group=None):
    """Preconditioned M^{1/2}W draws from Gaussian draws ``W``: one (B·3n,)
    draw (multi=False) or two, (2, B·3n), through the fused 2-RHS product
    (multi=True).  Returns (N, 3), or a pair of (N, 3); with ``return_err``
    the last element is the max relative truncation estimate (measured in
    the preconditioned G-space).  ``max_iters`` / ``err_tol``: the adaptive
    recurrence of :func:`sqrt_matvec_batched`; group: distributed mode
    (``positions``, ``rot`` and ``W`` this rank's bodies).

    G·v = L⁻¹ R̃ᵀ · M · R̃ L⁻ᵀ v, noise = R̃ L · G^{1/2} W.
    """
    positions = positions.reshape(-1, 3)
    # far-field operators: one position setup for the whole recurrence
    mob_apply_or_multi = saddle.hoist_positions(mob_apply_or_multi, positions)
    three_n = L.shape[0]
    B = positions.shape[0] * 3 // three_n
    n = three_n // 3
    k = 2 if multi else 1
    W = W.reshape(k, B * three_n).to(positions.dtype)
    rot_k = rot.expand((k,) + rot.shape).reshape(k * B, 3, 3)

    def to_world(vk):  # (k, sz) -> (k, N, 3): R̃ L^{-T} v
        u = torch.einsum("qp,kbq->kbp", L_inv, vk.reshape(k, B, three_n))
        return _rot_apply(rot_k, u.reshape(k * B, n, 3)).reshape(k, B * n, 3)

    def from_world(xk):  # (k, N, 3) -> (k, sz): L^{-1} R̃ᵀ x
        xb = _rot_apply(rot_k, xk.reshape(k * B, n, 3),
                        transpose=True).reshape(k, B, three_n)
        return torch.einsum("pq,kbq->kbp", L_inv, xb).reshape(k, -1)

    def mv(vk):  # G v
        x = to_world(vk)
        with profiling.span("mobility"):
            if multi:
                mx = mob_apply_or_multi(x, positions)
            else:
                mx = mob_apply_or_multi(x[0], positions)[None]
        return from_world(mx)

    g = sqrt_matvec_batched(mv, W, iters=iters, max_iters=max_iters,
                            err_tol=err_tol, return_err=return_err,
                            group=group)
    err = None
    if return_err:
        g, err = g
        err = torch.max(err)
    lg = torch.einsum("pq,kbq->kbp", L, g.reshape(k, B, three_n))
    out = _rot_apply(rot_k, lg.reshape(k * B, n, 3)).reshape(k, B * n, 3)
    if multi:
        return (out[0], out[1], err) if return_err else (out[0], out[1])
    return (out[0], err) if return_err else out[0]
