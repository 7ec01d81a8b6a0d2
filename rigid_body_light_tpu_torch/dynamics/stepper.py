"""Brownian-dynamics time steppers — the port of
``rigid_body_light_tpu/dynamics/stepper.py``.

The fluctuating step is the EM–midpoint scheme with RFD drift (Sprinkle et
al. 2017): Lanczos M^{1/2}W draws at q^n, the midpoint-slip RFD drift, a
predictor half-kick, the saddle solve at the half-kicked configuration,
and a guarded commit; or, with ``drift_mode="em_exact"``, plain
Euler–Maruyama with the solved-mobility RFD drift kBT·∂·N added to the
solve's U.  Loops are Python loops; there is no ``jit``.

PyTorch generators do not reproduce ``jax.random``, so the Gaussian draws
are inputs: ``stochastic_step`` takes ``draws=(W1, W2, W_rfd)`` or makes
them from an explicit ``torch.Generator`` (:func:`make_draws`).  Their
shapes by mode:

- W1, W2: (B·3n,) each — in the body-frame layout of the preconditioned
  Lanczos (``lanczos_precond``), else in the blob layout of
  ``lanczos.m_half_w``.  W2 is None where the step takes one draw
  (``split_rand`` off, or ``em_exact``, whose single √(2kBT/dt) draw has
  the split pair's distribution).
- W_rfd: (B, n, 3), the blob-space draw of the midpoint scheme's M-RFD;
  (B, 6), the body-space draw of ``em_exact``'s N-RFD.

Distributed mode (``group``, a ``torch.distributed`` process group; the
JAX package's ``axis_name``): the state, forces and draws are this rank's
bodies, ``mob_apply`` is the local operator of
:mod:`rigid_body_light_tpu_torch.parallel`, and every Krylov and Lanczos
reduction is all-reduced over the group.  Where the JAX step folds its key
with the device index, a rank draws its own bodies' draws from its own
generator (or takes them through ``draws``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from rigid_body_light_tpu_torch.config import SimulationConfig
from rigid_body_light_tpu_torch.ops import kinematics as kin
from rigid_body_light_tpu_torch.ops import lanczos
from rigid_body_light_tpu_torch.ops import rfd
from rigid_body_light_tpu_torch.ops import saddle as saddle_mod
from rigid_body_light_tpu_torch.ops import solvers
from rigid_body_light_tpu_torch.state import BodyState
from rigid_body_light_tpu_torch.utils import profiling
from rigid_body_light_tpu_torch.utils.validation import check_box_geometry


class StepAux(NamedTuple):
    U: torch.Tensor           # (B, 6) body velocities used for the commit
    lam: torch.Tensor         # (N, 3) constraint forces
    residual: torch.Tensor    # GMRES relative residual
    iters: int = None         # inner GMRES iterations executed (exact)
    noise_err: torch.Tensor = None  # Lanczos truncation estimate (0 if kBT=0)


def _commit(geom, cfg, state, dU):
    """Advance configs by dU, rejecting per-body moves that sink a blob
    below the wall, translate more than ``max_move·a`` or rotate more than
    ``max_rotation`` radians (the JAX ``_commit`` guards)."""
    X_new, Q_new = kin.update_X_Q(state.X, state.Q, dU)
    valid = torch.ones((state.X.shape[0],), dtype=torch.bool,
                       device=state.X.device)
    if cfg.max_move > 0:
        valid = valid & (torch.linalg.norm(dU[:, 0:3], dim=-1)
                         < cfg.max_move * cfg.a)
    if cfg.max_rotation > 0:
        valid = valid & (torch.linalg.norm(dU[:, 3:6], dim=-1)
                         < cfg.max_rotation)
    if cfg.wall and cfg.reject_below_wall:
        pos_new = kin.blob_positions(geom, X_new, Q_new)
        valid = valid & torch.all(pos_new[:, :, 2] > 0.0, dim=1)
    return BodyState(X=torch.where(valid[:, None], X_new, state.X),
                     Q=torch.where(valid[:, None], Q_new, state.Q))


def _residual_ok(res, cfg):
    return res.residual < cfg.max_step_residual


def deterministic_step(geom: kin.RefGeometry, cfg: SimulationConfig,
                       state: BodyState, force, slip=None,
                       mob_apply: Callable = None, group=None):
    """One deterministic step: solve the mobility problem, advance by U·dt.
    group: distributed mode (the module docstring).  Returns (new_state,
    StepAux)."""
    if mob_apply is None:
        mob_apply = saddle_mod.mobility_apply_fn(cfg)
    ops = saddle_mod.geometry_ops(geom, state)
    if slip is None:
        slip = torch.zeros_like(ops.flat_positions)
    res = solvers.solve_saddle(ops, cfg, slip, force, mob_apply=mob_apply,
                               group=group)
    dU = torch.where(_residual_ok(res, cfg), res.U,
                     torch.zeros_like(res.U)) * cfg.dt
    return _commit(geom, cfg, state, dU), StepAux(
        U=res.U, lam=res.lam, residual=res.residual, iters=res.iters)


def make_differentiable_step(geom: kin.RefGeometry, cfg: SimulationConfig):
    """A differentiable deterministic BD step ``step(state, force,
    slip=None) → BodyState``: :func:`.saddle.geometry_ops`, the
    implicit-adjoint solve (:func:`.solvers.make_differentiable_solver`)
    and :func:`.kinematics.update_X_Q` (whose axis-angle exponential keeps
    a finite gradient at ω = 0) chained, so autograd runs through X, Q,
    ``force`` and ``slip``, and through trajectories of such steps.

    The production guards (below-wall and oversized-move rejection, the
    residual check) are left out: they are piecewise-constant masks whose
    gradients vanish; keep the steps inside their range instead."""
    solve = solvers.make_differentiable_solver(cfg)

    def step(state: BodyState, force, slip=None):
        ops = saddle_mod.geometry_ops(geom, state)
        if slip is None:
            slip = torch.zeros_like(ops.flat_positions)
        lam, U = solve(ops, slip, force)
        X_new, Q_new = kin.update_X_Q(state.X, state.Q, U * cfg.dt)
        return BodyState(X=X_new, Q=Q_new)

    return step


def uses_split(cfg: SimulationConfig) -> bool:
    """Whether a step draws two Lanczos draws (the split increment of the
    midpoint scheme) or one."""
    return cfg.split_rand and cfg.drift_mode != "em_exact"


def make_draws(geom: kin.RefGeometry, state: BodyState,
               generator: torch.Generator, cfg: SimulationConfig = None):
    """The step's Gaussian draws (W1, W2, W_rfd) from ``generator``, on the
    state's device and in its dtype, in the shapes of ``cfg``'s mode (the
    module docstring; no cfg: the midpoint scheme's)."""
    B, n = state.X.shape[0], geom.n_blobs
    kw = dict(generator=generator, dtype=state.X.dtype, device=state.X.device)
    if cfg is not None and cfg.drift_mode == "em_exact":
        return torch.randn(B * 3 * n, **kw), None, torch.randn((B, 6), **kw)
    return (torch.randn(B * 3 * n, **kw), torch.randn(B * 3 * n, **kw),
            torch.randn((B, n, 3), **kw))


def stochastic_step(geom: kin.RefGeometry, cfg: SimulationConfig,
                    state: BodyState, force, slip=None,
                    mob_apply: Callable = None, x0=None, pc=None,
                    noise_pc=None, mob_multi: Callable = None, draws=None,
                    generator: torch.Generator = None, group=None):
    """One fluctuating BD step (EM–midpoint with RFD drift, or
    ``em_exact``).

      1. M^{1/2}W₁ (and W₂ with ``split_rand``) by Lanczos at q^n,
         preconditioned with ``lanczos_precond`` — the two draws fused
         through the 2-RHS product when the operator is the default one or
         ``mob_multi`` is given.
      2. Brownian increment BI = c₂(M^{1/2}W₁ − M^{1/2}W₂) [split] or
         c₂·M^{1/2}W₁, with c₁ = 2√(kBT/dt), c₂ = √(kBT/dt) [split], else
         c₁ = c₂ = √(2kBT/dt).
      3. Midpoint: drift D = kBT·M_RFD at q^n; predictor half-kick
         q^{n+1/2} = q^n + (dt/2)·K⁺(c₁ M^{1/2}W₁), guarded like a commit;
         saddle solve at q^{n+1/2} with RHS [slip − (D + BI); F].
         ``em_exact``: saddle solve at q^n with RHS [slip − BI; F], then
         U += kBT·N_RFD (:func:`rfd.n_rfd_exact`, two more solves).
      4. Commit q^{n+1} = q^n + U·dt, unless the solve residual exceeds
         ``max_step_residual``.

    draws: (W1, W2, W_rfd) in the shapes of the module docstring, or None
    to draw them from ``generator``.  x0: optional (λ, U) warm start.
    group: distributed mode (the module docstring), which needs the local
    ``mob_apply``.  Returns (new_state, StepAux).
    """
    with profiling.span("step"):
        return _stochastic_step(geom, cfg, state, force, slip, mob_apply, x0,
                                pc, noise_pc, mob_multi, draws, generator,
                                group)


def _stochastic_step(geom, cfg, state, force, slip, mob_apply, x0, pc,
                     noise_pc, mob_multi, draws, generator, group):
    default_mob = mob_apply is None
    if default_mob:
        if group is not None:
            raise ValueError(
                "distributed stochastic_step needs an explicit ring "
                "mob_apply (parallel.ring_mobility_apply_fn)")
        mob_apply = saddle_mod.mobility_apply_fn(cfg)
    dtype = state.X.dtype
    with profiling.span("kinematics"):
        ops = saddle_mod.geometry_ops(geom, state)
    # far field: build the kernel lattices once per step and share them
    # across the noise draw, RFD's displaced applies and the half-kick
    # solve (their position sets differ by far less than a cell); no-op
    # for the pair-sweep operators.  A caller that passes one operator as
    # both products (the distributed stepper) shares the pinned one: the
    # unpinned operator would build the lattices again for the noise
    same_multi = mob_multi is not None and mob_multi is mob_apply
    mob_apply = saddle_mod.pin_geometry(mob_apply, ops.flat_positions)
    if same_multi:
        mob_multi = mob_apply
    B, n, _ = ops.offsets.shape
    if slip is None:
        slip = torch.zeros_like(ops.flat_positions)

    kBT = cfg.kBT
    drift_U = None
    if kBT > 0.0:
        if draws is None:
            if generator is None:
                raise ValueError("stochastic_step needs draws or a generator")
            draws = make_draws(geom, state, generator, cfg)
        W1, W2, W_rfd = (None if w is None else
                         torch.as_tensor(w, dtype=dtype,
                                         device=state.X.device)
                         for w in draws)
        if cfg.lanczos_precond and noise_pc is None:
            noise_pc = lanczos.make_noise_preconditioner(geom.ref_cfg, cfg.a,
                                                         cfg.eta)
        with profiling.span("noise"):
            mhw1, noise_err, c1, bi = _brownian(
                cfg, mob_apply, mob_multi, default_mob, ops, noise_pc, W1, W2,
                group)
        if cfg.drift_mode == "em_exact":
            # plain EM: solve at q^n, add the solved-mobility divergence
            # drift afterwards — no midpoint kick (it would double count)
            slip_eff = slip - bi
            ops_solve = ops
            with profiling.span("rfd"):
                drift_U = kBT * rfd.n_rfd_exact(geom, state, cfg, W_rfd,
                                                mob_apply, pc=pc, group=group)
        else:
            with profiling.span("rfd"):
                drift = kBT * rfd.m_rfd(geom, state, ops, cfg, W_rfd,
                                        mob_apply)
            slip_eff = slip - (drift + bi)
            with profiling.span("kinematics"):
                u_half = kin.Kinv_dot((c1 * mhw1).reshape(B, n, 3),
                                      ops.offsets, ops.ktkinv)
                half_state = _commit(geom, cfg, state,
                                     (cfg.dt / 2.0) * u_half)
                ops_solve = saddle_mod.geometry_ops(geom, half_state)
    else:
        slip_eff = slip
        ops_solve = ops
        noise_err = torch.zeros((), dtype=dtype, device=state.X.device)

    res = solvers.solve_saddle(ops_solve, cfg, slip_eff, force,
                               mob_apply=mob_apply, x0=x0, pc=pc, group=group)
    U_total = res.U if drift_U is None else res.U + drift_U
    # a failed solve moves nothing (a garbage U launches bodies across the
    # box); aux.residual surfaces the event
    dU = torch.where(_residual_ok(res, cfg), U_total,
                     torch.zeros_like(U_total)) * cfg.dt
    with profiling.span("kinematics"):
        new_state = _commit(geom, cfg, state, dU)
    return new_state, StepAux(
        U=U_total, lam=res.lam, residual=res.residual, iters=res.iters,
        noise_err=noise_err.to(dtype))


def _brownian(cfg, mob_apply, mob_multi, default_mob, ops, noise_pc, W1,
              W2, group=None):
    """The step's Lanczos draws at q^n → (M^{1/2}W₁, noise_err, c₁, the
    Brownian increment BI): preconditioned with ``cfg.lanczos_precond``
    (``noise_pc`` = (L, L⁻¹)), and fused through the 2-RHS product when the
    operator is the default one or ``mob_multi`` is given."""
    kBT = cfg.kBT
    pos = ops.flat_positions
    lz = dict(iters=cfg.lanczos_iters, max_iters=cfg.lanczos_max_iters,
              err_tol=cfg.lanczos_err_tol, return_err=True, group=group)

    def one(mob, W):
        if cfg.lanczos_precond:
            return lanczos.m_half_w_precond(mob, pos, ops.rot, *noise_pc, W,
                                            **lz)
        return lanczos.m_half_w(mob, pos, W, **lz)

    if not uses_split(cfg):
        mhw1, noise_err = one(mob_apply, W1)
        c1 = c2 = math.sqrt(2.0 * kBT / cfg.dt)
        return mhw1, noise_err, c1, c2 * mhw1
    if default_mob or mob_multi is not None:
        if mob_multi is None:
            # the far-field apply is ndim-polymorphic: reuse the pinned
            # operator, not a second lattice build
            mob_multi = (mob_apply if hasattr(mob_apply, "prepare")
                         else saddle_mod.mobility_apply_multi_fn(cfg))
        if cfg.lanczos_precond:
            mhw1, mhw2, noise_err = lanczos.m_half_w_precond(
                mob_multi, pos, ops.rot, *noise_pc, torch.stack([W1, W2]),
                multi=True, **lz)
        else:
            mhw1, mhw2, noise_err = lanczos.m_half_w_pair(
                mob_multi, pos, torch.stack([W1, W2]), **lz)
    else:
        mhw1, e1 = one(mob_apply, W1)
        mhw2, e2 = one(mob_apply, W2)
        noise_err = torch.maximum(e1, e2)
    c1 = 2.0 * math.sqrt(kBT / cfg.dt)
    c2 = math.sqrt(kBT / cfg.dt)
    return mhw1, noise_err, c1, c2 * (mhw1 - mhw2)


def run_bd(geom: kin.RefGeometry, cfg: SimulationConfig, state: BodyState,
           n_steps: int, generator: torch.Generator = None,
           force_fn: Callable = None, slip_fn: Callable = None,
           mob_apply: Callable = None, save_every: int = 1,
           mob_multi: Callable = None, draws_fn: Callable = None,
           group=None):
    """Run a BD trajectory of ``n_steps`` stochastic steps.

    force_fn / slip_fn: (BodyState, step) → (B, 6) force / (N, 3) slip
    (default 0).  draws_fn: step → (W1, W2, W_rfd) in the shapes of the
    module docstring, else the draws come from ``generator``.  The
    ``block_free`` PC (the static tier of ``ras``, whose halo coupling each
    solve builds fresh) and the noise-PC factors are built once; a lagged PC (``pc_refresh`` > 1) is rebuilt every
    ``pc_refresh`` steps; each solve is warm-started from the previous
    step's (λ, U), zeroed after a failed solve.  A periodic box too small
    for the body geometry raises ``ValueError`` before the first step.
    group: distributed mode (the module docstring): ``state``, the forces,
    the slip and the draws are this rank's bodies.  Returns (final_state, trajectory dict of stacked snapshots every
    ``save_every`` steps: X, Q, residual, iters, noise_err).
    """
    dtype, dev = state.X.dtype, state.X.device
    B = state.X.shape[0]
    if cfg.box is not None:
        check_box_geometry(cfg.box, geom.ref_cfg.cpu().numpy(), cfg.a)
    if force_fn is None:
        def force_fn(s, i):
            return torch.zeros((B, 6), dtype=dtype, device=dev)
    # block_free holds only body-frame constants: built once; ras has the
    # same static tier, and solve_saddle attaches its halo coupling fresh at
    # each solve's geometry (a lagged halo tier is refused by the config)
    pc_mode = cfg.pc_mode or ("block" if cfg.block_diag_pc else "diag")
    static_pc = pc_mode in ("block_free", "ras")
    lagged_pc = cfg.pc_refresh > 1 and not static_pc
    noise_pc = (lanczos.make_noise_preconditioner(geom.ref_cfg, cfg.a, cfg.eta)
                if (cfg.lanczos_precond and cfg.kBT > 0.0) else None)
    pc = (saddle_mod.build_pc(saddle_mod.geometry_ops(geom, state), cfg)
          if (lagged_pc or static_pc) else None)
    x_prev = (torch.zeros((B * geom.n_blobs, 3), dtype=dtype, device=dev),
              torch.zeros((B, 6), dtype=dtype, device=dev))
    out = {"X": [], "Q": [], "residual": [], "iters": [], "noise_err": []}
    s = state
    for i in range(n_steps):
        if lagged_pc and i % cfg.pc_refresh == 0:
            pc = saddle_mod.build_pc(saddle_mod.geometry_ops(geom, s), cfg)
        s, aux = stochastic_step(
            geom, cfg, s, force_fn(s, i),
            slip=slip_fn(s, i) if slip_fn is not None else None,
            mob_apply=mob_apply, x0=x_prev, pc=pc, noise_pc=noise_pc,
            mob_multi=mob_multi,
            draws=draws_fn(i) if draws_fn is not None else None,
            generator=generator, group=group)
        for key, v in (("X", s.X), ("Q", s.Q), ("residual", aux.residual),
                       ("iters", torch.tensor(aux.iters)),
                       ("noise_err", aux.noise_err)):
            out[key].append(v)
        # a failed solve's (λ, U) would poison the next warm start
        ok = _residual_ok(aux, cfg)
        x_prev = (torch.where(ok, aux.lam, torch.zeros_like(aux.lam)),
                  torch.where(ok, aux.U, torch.zeros_like(aux.U)))
    keep = slice(save_every - 1, None, save_every)
    return s, {k: torch.stack(v)[keep] for k, v in out.items()}
