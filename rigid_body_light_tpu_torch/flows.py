"""Ambient background flows as prescribed blob slip — the port of
``rigid_body_light_tpu/flows.py``.

In the mobility formulation a background flow U∞(x) enters the saddle RHS as
a slip: the no-slip condition on each blob reads K·U + u_slip = M·λ + U∞(r),
i.e. pass ``slip = −U∞(blob positions)`` (with the sign convention of
``solve_saddle``'s upper RHS block).  These factories return ``slip_fn``
callables ``(state, step) → (N, 3)`` for
:func:`rigid_body_light_tpu_torch.dynamics.run_bd` and ``RigidBody.run`` —
the standard way to drive shear/extensional rheology runs.
"""

from __future__ import annotations

from typing import Callable

import torch

from rigid_body_light_tpu_torch.ops import kinematics as kin
from rigid_body_light_tpu_torch.state import BodyState


def _slip_from_flow(geom, flow_at):
    def slip_fn(state: BodyState, step=0):
        pos = kin.blob_positions(geom, state.X, state.Q).reshape(-1, 3)
        return -flow_at(pos)

    return slip_fn


def shear_flow(geom, gamma_dot: float, flow_axis: int = 0,
               gradient_axis: int = 2) -> Callable:
    """Simple shear U∞ = γ̇ · x[gradient_axis] · ê[flow_axis].

    E.g. the canonical wall-bounded shear: flow along x growing with height z.
    """

    def flow_at(pos):
        u = torch.zeros_like(pos)
        u[:, flow_axis] = gamma_dot * pos[:, gradient_axis]
        return u

    return _slip_from_flow(geom, flow_at)


def extensional_flow(geom, rate: float) -> Callable:
    """Planar extensional flow U∞ = rate · (x, −y, 0)."""

    def flow_at(pos):
        return torch.stack(
            [rate * pos[:, 0], -rate * pos[:, 1], torch.zeros_like(pos[:, 2])],
            dim=-1)

    return _slip_from_flow(geom, flow_at)


def uniform_flow(geom, velocity) -> Callable:
    """Constant ambient flow U∞ = v (e.g. a settling-frame change)."""

    def flow_at(pos):
        v = torch.as_tensor(velocity, dtype=pos.dtype, device=pos.device)
        return v.expand(pos.shape)

    return _slip_from_flow(geom, flow_at)
