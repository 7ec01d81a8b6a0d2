"""GMRES solves of the rigid multiblob system — the port of
``solve_saddle`` (the preconditioned saddle solve), the differentiable
solve ``make_differentiable_solver`` (implicit adjoints) and
``solve_resistance`` from ``rigid_body_light_tpu/ops/solvers.py``."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from rigid_body_light_tpu_torch.config import SimulationConfig
from rigid_body_light_tpu_torch.ops import gmres as gmres_mod
from rigid_body_light_tpu_torch.ops import kinematics as kin
from rigid_body_light_tpu_torch.ops import saddle as saddle_mod
from rigid_body_light_tpu_torch.utils import profiling
from rigid_body_light_tpu_torch.utils.collectives import psum


class SolveResult(NamedTuple):
    lam: torch.Tensor       # (N, 3) constraint forces on blobs
    U: torch.Tensor         # (B, 6) rigid body velocities
    residual: torch.Tensor  # final relative residual (preconditioned system)
    iters: int = None       # inner GMRES iterations executed
    true_residual: Optional[torch.Tensor] = None  # ‖b − A·x‖/‖b‖ on the
                                                  # unpreconditioned system


def solve_saddle(ops: saddle_mod.GeometryOps, cfg: SimulationConfig, slip,
                 force, pc: saddle_mod.PCData = None, x0=None,
                 mob_apply: Callable = None,
                 true_residual: bool = False, group=None) -> SolveResult:
    """Solve [M −K; Kᵀ 0][λ; U] = [slip; F] with left-preconditioned GMRES.
    With ``cfg.pc_mode == "ras"`` and ``pc`` without its halo tier, the
    halo coupling is built here at ``ops``' geometry.

    slip: (N, 3) prescribed blob slip; force: (B, 6) applied force/torque
    (with slip=0 the solve returns U = (KᵀM⁻¹K)⁻¹·F).  x0: optional (λ, U)
    warm start.  true_residual=True also reports the residual of the
    unpreconditioned system (one extra mobility matvec).

    group: distributed mode (a ``torch.distributed`` process group; the JAX
    package's ``axis_name``): ``ops`` / ``slip`` / ``force`` are this
    rank's bodies, ``mob_apply`` the local operator of
    :mod:`rigid_body_light_tpu_torch.parallel`, and the Krylov reductions
    are all-reduced over the group; the RAS preconditioner is built and
    applied over the group (:func:`.saddle.build_pc_ras`).
    """
    if mob_apply is None:
        mob_apply = saddle_mod.mobility_apply_fn(cfg)
    # far-field operators: build the position setup once here, not once
    # per GMRES iteration
    mob_apply = saddle_mod.hoist_positions(mob_apply, ops.flat_positions)
    with profiling.span("pc_build"):
        if pc is None:
            pc = saddle_mod.build_pc(ops, cfg)
        if cfg.pc_mode == "ras" and pc.halo_w is None:
            # the RAS halo coupling at this solve's geometry, on the static
            # block_free tier (run_bd builds that once, a lone call above)
            pc = saddle_mod.build_pc_ras(ops, cfg, static_pc=pc, group=group)
    dtype = ops.positions.dtype
    B, n, _ = ops.offsets.shape
    nb = 3 * B * n
    slip = slip.to(dtype).reshape(-1, 3)
    force = force.to(dtype).reshape(-1, 6)

    def pc_apply_flat(s, f):
        with profiling.span("pc_apply"):
            lam, U = saddle_mod.apply_pc(pc, s, f, ops, cfg, group)
            return torch.cat([lam.reshape(-1), U.reshape(-1)])

    def matvec(x):
        s, f = saddle_mod.apply_saddle(x[:nb].reshape(-1, 3),
                                       x[nb:].reshape(-1, 6), ops, cfg,
                                       mob_apply)
        return pc_apply_flat(s, f)

    b = pc_apply_flat(slip, force)
    if x0 is not None:
        x0 = torch.cat([x0[0].reshape(-1), x0[1].reshape(-1)])
    max_restarts = max(1, -(-cfg.gmres_maxiter // cfg.gmres_restart))
    with profiling.span("gmres"):
        result = gmres_mod.gmres(matvec, b, x0=x0, tol=cfg.gmres_tol,
                                 restart=cfg.gmres_restart,
                                 max_restarts=max_restarts, group=group)
    lam = result.x[:nb].reshape(-1, 3)
    U = result.x[nb:].reshape(-1, 6)
    tr = None
    if true_residual:
        s, f = saddle_mod.apply_saddle(lam, U, ops, cfg, mob_apply)
        rvec = torch.cat([(slip - s).reshape(-1), (force - f).reshape(-1)])
        bvec = torch.cat([slip.reshape(-1), force.reshape(-1)])
        tr = (torch.sqrt(psum(torch.sum(rvec * rvec), group))
              / torch.clamp(torch.sqrt(psum(torch.sum(bvec * bvec), group)),
                            min=1e-30))
    return SolveResult(lam=lam, U=U, residual=result.residual,
                       iters=result.iters, true_residual=tr)


class _SaddleSolve(torch.autograd.Function):
    """(offsets, positions, slip, force) → (λ, U) of the saddle solve,
    differentiated by the implicit-function theorem (see
    :func:`make_differentiable_solver`)."""

    @staticmethod
    def forward(ctx, offsets, positions, slip, force, ktkinv, rot, cfg):
        ops = saddle_mod.GeometryOps(offsets=offsets, positions=positions,
                                     ktkinv=ktkinv, rot=rot)
        res = solve_saddle(ops, cfg, slip, force)
        ctx.save_for_backward(offsets, positions, ktkinv, rot, res.lam,
                              res.U)
        ctx.cfg = cfg
        ctx.shapes = (slip.shape, force.shape)
        return res.lam, res.U

    @staticmethod
    def backward(ctx, lam_bar, U_bar):
        offsets, positions, ktkinv, rot, lam, U = ctx.saved_tensors
        cfg = ctx.cfg
        ops = saddle_mod.GeometryOps(offsets=offsets, positions=positions,
                                     ktkinv=ktkinv, rot=rot)
        # Aᵀ = S·A·S with S = diag(I, −I): the adjoint solve is the same
        # solver on sign-flipped blocks, y = (λ_adj, −U_adj)
        with torch.no_grad():
            adj = solve_saddle(ops, cfg, lam_bar, -U_bar)
        y0, y1 = adj.lam, -adj.U
        off_bar = pos_bar = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            # θ̄ = vjp_θ[A(θ)·x](−y) at the solution x = (λ, U)
            with torch.enable_grad():
                o = offsets.detach().requires_grad_()
                p = positions.detach().requires_grad_()
                s, f = saddle_mod.apply_saddle(
                    lam, U, saddle_mod.GeometryOps(offsets=o, positions=p,
                                                   ktkinv=ktkinv, rot=rot),
                    cfg, saddle_mod.mobility_apply_fn(cfg))
                off_bar, pos_bar = torch.autograd.grad(
                    (s, f), (o, p), (-y0, -y1), allow_unused=True)
        slip_shape, force_shape = ctx.shapes
        return (off_bar, pos_bar, y0.reshape(slip_shape),
                y1.reshape(force_shape), None, None, None)


def make_differentiable_solver(cfg: SimulationConfig) -> Callable:
    """A differentiable mobility solve ``solve(ops, slip, force) → (λ, U)``.

    The forward pass is the preconditioned GMRES of :func:`solve_saddle`
    (under ``torch.no_grad``: its loop is not differentiated).  Gradients
    come from the implicit-function theorem: with A·x = b,

        solve Aᵀ·y = x̄,   b̄ = y,   θ̄ = vjp_θ[A(θ)·x](−y).

    The saddle operator satisfies Aᵀ = S·A·S with S = diag(I, −I) on
    (λ, U), so the adjoint solve is the same solver with slip λ̄ and force
    −Ū.  The operator's vjp differentiates :func:`.saddle.apply_saddle`
    with the configuration's mobility product: through K1 on the card
    (:class:`.rpy_cuda.MobilityApply`: its position cotangent by autograd
    of the plain sweep), the plain sweep otherwise; a kernel without a
    backward (K2, K3, K4) raises there.  The block preconditioner is built
    inside the solve and carries no gradient, which the implicit-function
    theorem allows: the solution does not depend on it.

    Differentiable inputs: ``ops.offsets`` and ``ops.positions`` (chain
    through :func:`.saddle.geometry_ops` for ∂/∂X and ∂/∂Q), ``slip`` (N, 3)
    and ``force`` (B, 6); ``ops.ktkinv`` and ``ops.rot`` feed only the
    preconditioner and get none."""
    def solve(ops: saddle_mod.GeometryOps, slip, force):
        return _SaddleSolve.apply(ops.offsets, ops.positions, slip, force,
                                  ops.ktkinv, ops.rot, cfg)
    return solve


def solve_resistance(ops: saddle_mod.GeometryOps, cfg: SimulationConfig, U,
                     slip=None, mob_apply: Callable = None):
    """Resistance problem: given body velocities U (B, 6), find the applied
    force/torque F = Kᵀλ with M·λ = K·U + slip.

    The blob-space system M·λ = rhs is SPD and well-conditioned after
    damping, so it is solved by unpreconditioned GMRES on M alone, with the
    operator's position setup built once (:func:`.saddle.hoist_positions`).
    Returns (F (B, 6), λ (N, 3), residual).
    """
    if mob_apply is None:
        mob_apply = saddle_mod.mobility_apply_fn(cfg)
    mob_apply = saddle_mod.hoist_positions(mob_apply, ops.flat_positions)
    dtype, dev = ops.positions.dtype, ops.positions.device
    B, n, _ = ops.offsets.shape
    U = torch.as_tensor(U, dtype=dtype, device=dev).reshape(-1, 6)
    rhs = kin.K_dot(U, ops.offsets).reshape(-1, 3)
    if slip is not None:
        rhs = rhs + torch.as_tensor(slip, dtype=dtype,
                                    device=dev).reshape(-1, 3)
    pos = ops.flat_positions

    def matvec(x):
        return mob_apply(x.reshape(-1, 3), pos).reshape(-1)

    max_restarts = max(1, -(-cfg.gmres_maxiter // cfg.gmres_restart))
    result = gmres_mod.gmres(matvec, rhs.reshape(-1), tol=cfg.gmres_tol,
                             restart=cfg.gmres_restart,
                             max_restarts=max_restarts)
    lam = result.x.reshape(B, n, 3)
    F = kin.KT_dot(lam, ops.offsets)
    return F, lam.reshape(-1, 3), result.residual
