"""Carry parameters and state across from the JAX package.

Everything arrives as numpy arrays and plain dicts (this module never
imports ``jax``), so both packages can compute the same thing from the
same numbers:

    cfg_t   = config_from_dict(dataclasses.asdict(cfg_jax))
    geom_t  = geometry_from_numpy(np.asarray(geom_jax.ref_cfg))
    state_t = state_from_numpy(np.asarray(state.X), np.asarray(state.Q))
    pc_t    = pc_from_numpy(np.asarray(pc.minv_ref), np.asarray(pc.n_ref))
    npc_t   = noise_pc_from_numpy(np.asarray(L), np.asarray(L_inv))
"""

from __future__ import annotations

import numpy as np
import torch

from rigid_body_light_tpu_torch.config import SimulationConfig
from rigid_body_light_tpu_torch.ops import kinematics as kin
from rigid_body_light_tpu_torch.ops.saddle import PCData
from rigid_body_light_tpu_torch.state import BodyState


def _torch_dtype(dtype):
    """A dtype given as a string ("float32") or anything numpy names."""
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"unsupported dtype {dtype!r}")
    return getattr(torch, name)


def config_from_dict(d) -> SimulationConfig:
    """``SimulationConfig`` from ``dataclasses.asdict`` of the JAX config."""
    d = dict(d)
    d["dtype"] = _torch_dtype(d["dtype"])
    return SimulationConfig(**d)


def geometry_from_numpy(ref_cfg, dtype=torch.float32, device=None):
    return kin.make_ref_geometry(np.array(ref_cfg), dtype=dtype,
                                 device=device)


def state_from_numpy(X, Q, dtype=torch.float32, device=None) -> BodyState:
    """The JAX state's (X, Q) as-is (already normalized)."""
    return BodyState(X=torch.as_tensor(np.array(X), dtype=dtype,
                                       device=device).reshape(-1, 3),
                     Q=torch.as_tensor(np.array(Q), dtype=dtype,
                                       device=device).reshape(-1, 4))


def pc_from_numpy(minv_ref, n_ref, dtype=torch.float32, device=None) -> PCData:
    """A ``block_free`` PC from its two body-frame constants."""
    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return PCData(inv_m_diag=None, inv_m_block=None, n_mat=None,
                  minv_ref=t(minv_ref), n_ref=t(n_ref))


def noise_pc_from_numpy(L, L_inv, dtype=torch.float32, device=None):
    """The noise-preconditioner factors (L, L⁻¹)."""
    return (torch.as_tensor(np.array(L), dtype=dtype, device=device),
            torch.as_tensor(np.array(L_inv), dtype=dtype, device=device))
