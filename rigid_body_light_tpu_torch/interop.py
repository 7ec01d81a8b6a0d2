"""Carry parameters and state across from the JAX package.

Everything arrives as numpy arrays and plain dicts (this module never
imports ``jax``), so both packages can compute the same thing from the
same numbers.  Tensors go to the card unless ``device`` names another
(the CPU tests pass ``device="cpu"``):

    cfg_t   = config_from_dict(dataclasses.asdict(cfg_jax))
    geom_t  = geometry_from_numpy(np.asarray(geom_jax.ref_cfg))
    state_t = state_from_numpy(np.asarray(state.X), np.asarray(state.Q))
    pc_t    = pc_from_numpy(np.asarray(pc.minv_ref), np.asarray(pc.n_ref))
    npc_t   = noise_pc_from_numpy(np.asarray(L), np.asarray(L_inv))
    ew_t    = ewald_params_from_numpy(**params_jax._asdict())

and a mixture's (``multi``):

    mgeom_t  = multi_geometry_from_numpy([np.asarray(g.ref_cfg) for g in
                                          mgeom_j.geoms], mgeom_j.radii)
    states_t = states_from_numpy([(np.asarray(s.X), np.asarray(s.Q))
                                  for s in states_j])
    npcs_t   = noise_pcs_from_numpy([(np.asarray(L), np.asarray(L_inv))
                                     for L, L_inv in npcs_j])
"""

from __future__ import annotations

import numpy as np
import torch

from rigid_body_light_tpu_torch.config import SimulationConfig
from rigid_body_light_tpu_torch.multi import MultiGeometry
from rigid_body_light_tpu_torch.ops import kinematics as kin
from rigid_body_light_tpu_torch.ops.ewald import EwaldParams
from rigid_body_light_tpu_torch.ops.saddle import PCData
from rigid_body_light_tpu_torch.state import BodyState, resolve_device


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


def ewald_params_from_numpy(box, a, eta, xi, kvecs, wk, wk_raw=None,
                            cheb_bounds=None, cheb_A=None, cheb_B=None,
                            rc=None, nvecs=None) -> EwaldParams:
    """The port's ``EwaldParams`` from the fields of the JAX package's
    (numpy arrays and floats), so both packages can run on the very same
    wavevectors, weights and Chebyshev coefficients."""
    def arr(v, dtype):
        return None if v is None else np.array(v, dtype)
    return EwaldParams(
        box=tuple(float(b) for b in box), a=float(a), eta=float(eta),
        xi=float(xi), kvecs=arr(kvecs, np.float64), wk=arr(wk, np.float64),
        wk_raw=arr(wk_raw, np.float64),
        cheb_bounds=arr(cheb_bounds, np.float64),
        cheb_A=arr(cheb_A, np.float64), cheb_B=arr(cheb_B, np.float64),
        rc=None if rc is None else float(rc), nvecs=arr(nvecs, np.int32))


def geometry_from_numpy(ref_cfg, dtype=torch.float32, device="cuda"):
    return kin.make_ref_geometry(np.array(ref_cfg), dtype=dtype,
                                 device=device)


def state_from_numpy(X, Q, dtype=torch.float32, device="cuda") -> BodyState:
    """The JAX state's (X, Q) as-is (already normalized)."""
    device = resolve_device(device)
    return BodyState(X=torch.as_tensor(np.array(X), dtype=dtype,
                                       device=device).reshape(-1, 3),
                     Q=torch.as_tensor(np.array(Q), dtype=dtype,
                                       device=device).reshape(-1, 4))


def pc_from_numpy(minv_ref, n_ref, dtype=torch.float32,
                  device="cuda") -> PCData:
    """A ``block_free`` PC from its two body-frame constants."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return PCData(inv_m_diag=None, inv_m_block=None, n_mat=None,
                  minv_ref=t(minv_ref), n_ref=t(n_ref))


def noise_pc_from_numpy(L, L_inv, dtype=torch.float32, device="cuda"):
    """The noise-preconditioner factors (L, L⁻¹)."""
    device = resolve_device(device)
    return (torch.as_tensor(np.array(L), dtype=dtype, device=device),
            torch.as_tensor(np.array(L_inv), dtype=dtype, device=device))


def multi_geometry_from_numpy(ref_cfgs, radii=None, dtype=torch.float32,
                              device="cuda") -> MultiGeometry:
    """A mixture's geometry from its species' (n_s, 3) reference
    configurations and per-species blob radii (None entries: the
    configuration's ``a``)."""
    return MultiGeometry.create([np.array(c) for c in ref_cfgs], dtype=dtype,
                                radii=radii, device=device)


def states_from_numpy(pairs, dtype=torch.float32, device="cuda"):
    """A mixture's states from per-species (X, Q) arrays."""
    return tuple(state_from_numpy(X, Q, dtype=dtype, device=device)
                 for X, Q in pairs)


def noise_pcs_from_numpy(pairs, dtype=torch.float32, device="cuda"):
    """A mixture's per-species noise factors from (L, L⁻¹) arrays."""
    return tuple(noise_pc_from_numpy(L, L_inv, dtype=dtype, device=device)
                 for L, L_inv in pairs)
