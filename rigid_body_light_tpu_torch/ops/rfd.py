"""Random-finite-difference drift — the port of
``rigid_body_light_tpu/ops/rfd.py`` (one device).  The Gaussian draws are
inputs: a blob-space draw (B, n, 3) for :func:`m_rfd`, a body-space draw
(B, 6) for :func:`n_rfd_exact` and :func:`kt_inv_rfd`."""

from __future__ import annotations

from typing import Callable

import torch

from rigid_body_light_tpu_torch.config import SimulationConfig
from rigid_body_light_tpu_torch.ops import kinematics as kin
from rigid_body_light_tpu_torch.ops import saddle as saddle_mod
from rigid_body_light_tpu_torch.state import BodyState
from rigid_body_light_tpu_torch.utils import profiling


def _displaced_positions(geom, state: BodyState, dU):
    """Blob positions of the configuration displaced by dU (B, 6)."""
    X, Q = kin.update_X_Q(state.X, state.Q, dU)
    return kin.blob_positions(geom, X, Q)


def m_rfd(geom: kin.RefGeometry, state: BodyState,
          ops: saddle_mod.GeometryOps, cfg: SimulationConfig, w,
          mob_apply: Callable = None):
    """Drift term (1/δ)[M(q + δu/2) − M(q − δu/2)]·W with u = K⁺W, for a
    Gaussian blob-space draw ``w`` (B, n, 3); returns (N, 3).

    In float32 the difference of two mobility products divided by
    δ = rfd_delta amplifies their roundoff by ~1/δ.
    """
    if mob_apply is None:
        mob_apply = saddle_mod.mobility_apply_fn(cfg)
    B, n, _ = ops.offsets.shape
    w = w.reshape(B, n, 3).to(ops.positions.dtype)
    u = kin.Kinv_dot(w, ops.offsets, ops.ktkinv)
    delta = cfg.rfd_delta
    dU = (delta / 2.0) * u
    r_p = _displaced_positions(geom, state, dU).reshape(-1, 3)
    r_m = _displaced_positions(geom, state, -dU).reshape(-1, 3)
    w_flat = w.reshape(-1, 3)
    with profiling.span("mobility"):
        return (mob_apply(w_flat, r_p) - mob_apply(w_flat, r_m)) / delta


def m_rfd_from_u(geom: kin.RefGeometry, state: BodyState,
                 cfg: SimulationConfig, u, w, mob_apply: Callable = None,
                 delta: float = 1.0e-3):
    """(1/δ)[M(q+δu/2) − M(q−δu/2)]·w for a direction u (B, 6) and a blob
    vector w (N, 3) given by the caller.  Returns (N, 3)."""
    if mob_apply is None:
        mob_apply = saddle_mod.mobility_apply_fn(cfg)
    dtype = state.X.dtype
    dU = (delta / 2.0) * u.to(dtype)
    r_p = _displaced_positions(geom, state, dU).reshape(-1, 3)
    r_m = _displaced_positions(geom, state, -dU).reshape(-1, 3)
    w = w.to(dtype).reshape(-1, 3)
    with profiling.span("mobility"):
        return (mob_apply(w, r_p) - mob_apply(w, r_m)) / delta


def kt_rfd_from_u(geom: kin.RefGeometry, state: BodyState,
                  cfg: SimulationConfig, u, w, delta: float = 1.0e-3):
    """(1/δ)[Kᵀ(q+δu/2) − Kᵀ(q−δu/2)]·w for a direction u (B, 6) and a blob
    vector w (N, 3) given by the caller.  Returns (B, 6)."""
    dtype = state.X.dtype
    dU = (delta / 2.0) * u.to(dtype)
    w = w.to(dtype)

    def kt_at(dU_signed):
        _, Q = kin.update_X_Q(state.X, state.Q, dU_signed)
        offsets = kin.blob_offsets(geom, Q)
        return kin.KT_dot(w.reshape(offsets.shape), offsets)

    return (kt_at(dU) - kt_at(-dU)) / delta


def rfd_delta(cfg: SimulationConfig, dtype) -> float:
    """δ of the solved-mobility RFD: ``cfg.rfd_delta``, floored at 1e-2 in
    float32, where the difference of two GMRES solutions (~δ·∂N·W) must
    sit above the solver's tolerance (VALIDATION.md: δ = 1e-4 diverges,
    δ = 1e-2 is unbiased)."""
    if dtype == torch.float32:
        return max(cfg.rfd_delta, 1.0e-2)
    return cfg.rfd_delta


def n_rfd_exact(geom: kin.RefGeometry, state: BodyState,
                cfg: SimulationConfig, w, mob_apply: Callable = None,
                pc=None, group=None):
    """Body-space divergence drift ∂·N by a centered RFD on the solved body
    mobility N(q) = (KᵀM⁻¹K)⁻¹, for a Gaussian body-space draw ``w``
    (B, 6):

        ∂·N ≈ (1/δ)[N(q + δW/2)·W − N(q − δW/2)·W],

    two extra saddle solves (``drift_mode='em_exact'``).  Returns (B, 6);
    multiply by kBT at the call site.  δ: :func:`rfd_delta`.  ``pc``: the
    step's preconditioner, good at q ± δW/2 too.  group: distributed mode
    (``state`` and ``w`` this rank's bodies, ``mob_apply`` the local
    operator; the two solves all-reduce their Krylov recurrences).
    """
    from rigid_body_light_tpu_torch.ops import solvers

    if mob_apply is None:
        mob_apply = saddle_mod.mobility_apply_fn(cfg)
    dtype = state.X.dtype
    B = state.X.shape[0]
    w = w.reshape(B, 6).to(dtype)
    delta = rfd_delta(cfg, dtype)
    dU = (delta / 2.0) * w
    zero_slip = torch.zeros((B * geom.n_blobs, 3), dtype=dtype,
                            device=state.X.device)

    def n_dot_w(dU_signed):
        X, Q = kin.update_X_Q(state.X, state.Q, dU_signed)
        ops = saddle_mod.geometry_ops(geom, BodyState(X=X, Q=Q))
        return solvers.solve_saddle(ops, cfg, zero_slip, w,
                                    mob_apply=mob_apply, pc=pc,
                                    group=group).U

    return (n_dot_w(dU) - n_dot_w(-dU)) / delta


def kt_inv_rfd(geom: kin.RefGeometry, state: BodyState,
               ops: saddle_mod.GeometryOps, cfg: SimulationConfig, w):
    """Kᵀ·(1/δ)[K⁺ᵀ(q+δW/2) − K⁺ᵀ(q−δW/2)]·W for a Gaussian body-space
    draw ``w`` (B, 6), δ = ``cfg.rfd_delta``.  Returns (B, 6)."""
    dtype = state.X.dtype
    w = w.reshape(-1, 6).to(dtype)
    delta = cfg.rfd_delta
    dU = (delta / 2.0) * w

    def kinvT_at(dU_signed):
        _, Q = kin.update_X_Q(state.X, state.Q, dU_signed)
        offsets = kin.blob_offsets(geom, Q)
        return kin.KinvT_dot(w, offsets, kin.ktk_inv(geom, Q))

    diff = (kinvT_at(dU) - kinvT_at(-dU)) / delta
    return kin.KT_dot(diff, ops.offsets)
