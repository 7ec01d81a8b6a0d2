"""Random-finite-difference drift — the port of ``m_rfd`` from
``rigid_body_light_tpu/ops/rfd.py``.  The Gaussian draw is an input."""

from __future__ import annotations

from typing import Callable

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
