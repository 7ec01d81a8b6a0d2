"""External force fields for BD runs — the port of
``rigid_body_light_tpu/forces.py``.

Each factory returns a ``force_fn(state, step) → (B, 6)`` for
:func:`rigid_body_light_tpu_torch.dynamics.run_bd`, in the state's dtype
and on its device; the fields compose additively via :func:`sum_forces`.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from rigid_body_light_tpu_torch.state import BodyState


def _as(x, state: BodyState):
    return torch.as_tensor(x, dtype=state.X.dtype, device=state.X.device)


def _minimum_image(d, box):
    """Minimum-image wrap of the x, y (and z for a 3-D box) components of
    displacements d (..., 3), absolute units."""
    if any(b <= 0 for b in box):
        raise ValueError(f"periodic box lengths must be positive, got {box}")
    comps = list(d.unbind(-1))
    for ax, L in enumerate(box):
        comps[ax] = comps[ax] - L * torch.round(comps[ax] / L)
    return torch.stack(comps, dim=-1)


def gravity(g_force) -> Callable:
    """Constant body force/torque, e.g. buoyant weight (0,0,-mg, 0,0,0).

    g_force: (6,) or (B, 6) array-like.
    """
    def fn(state: BodyState, step=0):
        return _as(g_force, state).expand(state.X.shape[0], 6)

    return fn


def wall_repulsion(strength: float, debye_length: float,
                   radius: float = 1.0) -> Callable:
    """Soft exponential wall repulsion along +z:

        F_z = strength · exp(−(h − radius)/debye_length),  h = body height.
    """
    def fn(state: BodyState, step=0):
        h = state.X[:, 2]
        out = torch.zeros((state.X.shape[0], 6), dtype=state.X.dtype,
                          device=state.X.device)
        out[:, 2] = strength * torch.exp(-(h - radius) / debye_length)
        return out

    return fn


def harmonic_trap(k, center) -> Callable:
    """Harmonic restoring force −k·(X − center) on each body's tracking
    point."""
    def fn(state: BodyState, step=0):
        out = torch.zeros((state.X.shape[0], 6), dtype=state.X.dtype,
                          device=state.X.device)
        out[:, 0:3] = -_as(k, state) * (state.X - _as(center, state))
        return out

    return fn


def pair_yukawa(strength: float, debye_length: float, diameter: float,
                box=None) -> Callable:
    """Pairwise screened-Coulomb (Yukawa) body-body repulsion:

        F_ij = strength · exp(−(r−d)/λ) · r̂,   r = |X_i − X_j|,

    over body centers, no self interaction.  box: optional (Lx, Ly) or
    (Lx, Ly, Lz) minimum-image wrap (match ``SimulationConfig.box``).
    """
    def fn(state: BodyState, step=0):
        X = state.X
        B = X.shape[0]
        d = X[:, None, :] - X[None, :, :]
        if box is not None:
            d = _minimum_image(d, box)
        r2 = torch.sum(d * d, dim=-1)
        eye = torch.eye(B, dtype=torch.bool, device=X.device)
        r = torch.sqrt(torch.where(eye, torch.ones_like(r2), r2))
        mag = strength * torch.exp(-(r - diameter) / debye_length) / r
        mag = torch.where(eye, torch.zeros_like(mag), mag)
        out = torch.zeros((B, 6), dtype=X.dtype, device=X.device)
        out[:, 0:3] = torch.einsum("ij,ijk->ik", mag, d)
        return out

    return fn


def sum_forces(*force_fns: Sequence[Callable]) -> Callable:
    """Compose force fields additively."""
    def fn(state: BodyState, step=0):
        total = force_fns[0](state, step)
        for f in force_fns[1:]:
            total = total + f(state, step)
        return total

    return fn
