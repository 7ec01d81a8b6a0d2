"""GMRES solves of the rigid multiblob system — the port of
``solve_saddle`` (the preconditioned saddle solve) and
``solve_resistance`` from ``rigid_body_light_tpu/ops/solvers.py``."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from rigid_body_light_tpu_torch.config import SimulationConfig
from rigid_body_light_tpu_torch.ops import gmres as gmres_mod
from rigid_body_light_tpu_torch.ops import kinematics as kin
from rigid_body_light_tpu_torch.ops import saddle as saddle_mod
from rigid_body_light_tpu_torch.utils import profiling


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
                 true_residual: bool = False) -> SolveResult:
    """Solve [M −K; Kᵀ 0][λ; U] = [slip; F] with left-preconditioned GMRES.
    With ``cfg.pc_mode == "ras"`` and ``pc`` without its halo tier, the
    halo coupling is built here at ``ops``' geometry.

    slip: (N, 3) prescribed blob slip; force: (B, 6) applied force/torque
    (with slip=0 the solve returns U = (KᵀM⁻¹K)⁻¹·F).  x0: optional (λ, U)
    warm start.  true_residual=True also reports the residual of the
    unpreconditioned system (one extra mobility matvec).
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
            pc = saddle_mod.build_pc_ras(ops, cfg, static_pc=pc)
    dtype = ops.positions.dtype
    B, n, _ = ops.offsets.shape
    nb = 3 * B * n
    slip = slip.to(dtype).reshape(-1, 3)
    force = force.to(dtype).reshape(-1, 6)

    def pc_apply_flat(s, f):
        with profiling.span("pc_apply"):
            lam, U = saddle_mod.apply_pc(pc, s, f, ops, cfg)
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
                                 max_restarts=max_restarts)
    lam = result.x[:nb].reshape(-1, 3)
    U = result.x[nb:].reshape(-1, 6)
    tr = None
    if true_residual:
        s, f = saddle_mod.apply_saddle(lam, U, ops, cfg, mob_apply)
        rvec = torch.cat([(slip - s).reshape(-1), (force - f).reshape(-1)])
        bvec = torch.cat([slip.reshape(-1), force.reshape(-1)])
        tr = (torch.sqrt(torch.sum(rvec * rvec))
              / torch.clamp(torch.sqrt(torch.sum(bvec * bvec)), min=1e-30))
    return SolveResult(lam=lam, U=U, residual=result.residual,
                       iters=result.iters, true_residual=tr)


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
