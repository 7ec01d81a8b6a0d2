"""Simulation configuration — the port of ``rigid_body_light_tpu/config.py``.

Same field names, defaults and ``__post_init__`` checks as the JAX
``SimulationConfig``, with ``dtype`` a ``torch.dtype``.  The far field's
band tier with a 2-D box raises here already (the JAX package raises at
the first apply).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """Configuration of a rigid multiblob system (see the JAX package's
    ``SimulationConfig`` for the meaning of every field).

    ``use_pallas`` keeps its JAX name so configurations carry across
    unchanged: in the port it selects the hand-written CUDA kernels
    (:mod:`rigid_body_light_tpu_torch.ops.rpy_cuda`, ``farfield_cuda``,
    ``ewald_cuda``) for float32 mobility products; False, or float64, takes
    the plain PyTorch sweep.

    A 3-D ``box`` is the triply-periodic Ewald operator: the classic split,
    or with ``ewald_rc`` the balanced split (its real part over sorted
    tiles, its wave part dense or, with ``ewald_grid_p``, on the
    cell-spectral grid), with or without per-blob radii.  A 2-D ``(Lx, Ly)`` box is the wall-bounded pseudo-2D film: the minimum
    image in the plane, or with ``image_shells`` S ≥ 1 the exact
    doubly-periodic image sum, and with ``farfield_grid`` too its O(N) far
    field (:mod:`rigid_body_light_tpu_torch.ops.farfield`; S ≥ 1 and the
    wall, and ≥ 4 cells on x and y, checked at its first apply as in the
    JAX package).
    """

    a: float = 1.0
    eta: float = 1.0
    dt: float = 1.0
    kBT: float = 0.0
    wall: bool = False
    box: Any = None
    image_shells: int = 0
    ewald_xi: float = 0.0
    ewald_tol: float = 1.0e-6
    ewald_rc: float = 0.0
    ewald_nbr_tiles: int = 0
    ewald_grid_p: int = 0
    farfield_grid: Any = None
    farfield_p: int = 4
    farfield_band_p: int = 0
    farfield_nbr_tiles: int = 0
    block_diag_pc: bool = False
    pc_mode: str = ""
    pc_halo: float = 4.0
    pc_halo_max: int = 64
    pc_refresh: int = 1
    split_rand: bool = True
    drift_mode: str = "midpoint_slip"
    reject_below_wall: bool = True
    max_step_residual: float = 1e-2
    max_move: float = 5.0
    max_rotation: float = 0.5
    rfd_delta: float = 1.0e-4
    dtype: Any = torch.float32
    m_scale: float = 1.0
    lanczos_iters: int = 30
    lanczos_max_iters: int = 0
    lanczos_err_tol: float = 0.0
    lanczos_precond: bool = True
    gmres_tol: float = 1.0e-6
    gmres_maxiter: int = 200
    gmres_restart: int = 40
    matvec_row_tile: int = 512
    use_pallas: bool = True
    wall_h_floor: float = 0.75
    validate_config: bool = True   # RigidBody's O(N²) overlap check

    def __post_init__(self):
        if not isinstance(self.dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got {self.dtype!r}")
        # the JAX package's validation, in its order
        if self.box is not None:
            box = tuple(float(b) for b in self.box)
            if len(box) not in (2, 3) or any(b <= 0 for b in box):
                raise ValueError(
                    f"box must be None, a positive (Lx, Ly) pair or a "
                    f"positive (Lx, Ly, Lz) triple, got {self.box!r}")
            if len(box) == 3 and self.wall:
                raise ValueError(
                    "a 3-D (triply periodic Ewald) box is incompatible with "
                    "wall=True — use a 2-D (Lx, Ly) box for wall-bounded "
                    "pseudo-periodicity")
            object.__setattr__(self, "box", box)
        if self.image_shells:
            if self.image_shells < 0:
                raise ValueError(
                    f"image_shells must be ≥ 0, got {self.image_shells}")
            if self.box is None or len(self.box) != 2:
                raise ValueError(
                    "image_shells needs a 2-D (Lx, Ly) box — the exact "
                    "image sum is the doubly-periodic (pseudo-2D) geometry")
        if 0 < self.lanczos_max_iters <= self.lanczos_iters:
            raise ValueError(
                f"lanczos_max_iters={self.lanczos_max_iters} ≤ "
                f"lanczos_iters={self.lanczos_iters}: the adaptive noise "
                f"mode would silently never engage (it extends PAST "
                f"lanczos_iters up to the cap) — raise the cap or drop it")
        if self.farfield_grid is not None:
            if self.box is not None and len(self.box) == 3:
                raise ValueError(
                    "farfield_grid needs an open or 2-D-periodic domain — "
                    "3-D boxes already have the Ewald wave-space far field")
            if self.box is not None and not self.wall:
                raise ValueError(
                    "farfield_grid with a 2-D (Lx, Ly) box is the pseudo-2D "
                    "doubly-periodic WALL mode — needs wall=True (the free-"
                    "space Stokeslet's in-plane lattice sum diverges)")
            if self.box is not None and self.image_shells < 1:
                raise ValueError(
                    "the pseudo-2D far field (farfield_grid + 2-D box) needs "
                    "image_shells ≥ 1: its cyclic kernel lattice picks one "
                    "signed representative per cell offset")
            g = self.farfield_grid
            if isinstance(g, str):
                if g != "auto":
                    raise ValueError(
                        f"farfield_grid must be None, 'auto', an int or a "
                        f"(Gx, Gy, Gz) triple, got {g!r}")
            elif not isinstance(g, int):
                g = tuple(int(v) for v in g)
                if len(g) != 3 or any(v < 2 for v in g):
                    raise ValueError(
                        f"farfield_grid triple must be 3 counts ≥ 2, got "
                        f"{self.farfield_grid!r}")
                # a normalized tuple keeps the dataclass hashable
                object.__setattr__(self, "farfield_grid", g)
            # the proxy-grid operator is approximate: a solve converges to
            # the p-accurate operator's solution, so a gmres_tol below the
            # operator error reports residuals the physics cannot honor.
            # The JAX package's measured operator errors (monodisperse wall,
            # the worst case): p=4 ≈ 5e-3, p=6 ≈ 5e-4.
            est = {3: 2e-2, 4: 5e-3, 5: 1.5e-3, 6: 5e-4}.get(
                self.farfield_p, 1e-4 if self.farfield_p > 6 else 5e-2)
            if self.farfield_band_p:
                # two tiers: the larger of the band order's error at offset
                # 2 and the FFT order's at offsets ≥ 4 (the JAX package's
                # measured per-offset interpolation errors)
                band_tbl = {3: 2e-2, 4: 6e-3, 5: 1.6e-3, 6: 2e-4, 7: 1e-4}
                far4_tbl = {3: 1e-3, 4: 3e-4, 5: 2e-5, 6: 3e-6}
                est = max(band_tbl.get(self.farfield_band_p, 5e-5),
                          far4_tbl.get(self.farfield_p, 1e-6))
            if self.gmres_tol < est:
                warnings.warn(
                    f"gmres_tol={self.gmres_tol:g} is below the proxy-grid "
                    f"far field's measured operator error at farfield_p="
                    f"{self.farfield_p} (~{est:g}): the solve will converge "
                    f"to the approximate operator's solution, not to "
                    f"gmres_tol of the exact one.  Raise farfield_p (6 ≈ "
                    f"5e-4) or relax gmres_tol.", stacklevel=2)
        if self.ewald_rc > 0:
            if self.ewald_xi > 0:
                raise ValueError(
                    "pass either ewald_rc (balanced splitting) or ewald_xi, "
                    "not both — rc determines xi")
            if self.box is None or len(self.box) != 3:
                raise ValueError("ewald_rc needs a 3-D (Lx, Ly, Lz) box")
        if self.ewald_grid_p:
            if self.ewald_rc <= 0:
                raise ValueError("ewald_grid_p needs ewald_rc > 0 (balanced "
                                 "splitting)")
            if self.ewald_grid_p < 2:
                raise ValueError(
                    f"ewald_grid_p must be >= 2 nodes per dim (or 0 = off), "
                    f"got {self.ewald_grid_p}")
        if self.drift_mode not in ("midpoint_slip", "em_exact"):
            raise ValueError(
                f"unknown drift_mode {self.drift_mode!r}; use 'midpoint_slip' "
                "or 'em_exact' (a typo here would otherwise silently run the "
                "midpoint scheme)")
        if self.pc_mode == "ras" and self.pc_refresh > 1:
            raise ValueError(
                "pc_refresh > 1 with pc_mode='ras' is not supported: a "
                "lagged halo tier is measured catastrophic (BENCH_NOTES "
                "round 4)")
        if self.max_step_residual > 0 and self.gmres_tol >= self.max_step_residual:
            raise ValueError(
                f"gmres_tol ({self.gmres_tol}) must be below max_step_residual "
                f"({self.max_step_residual}) — otherwise every 'converged' solve "
                "is rejected and the trajectory silently freezes")
        if (self.box is not None and self.farfield_grid is not None
                and self.farfield_band_p > 0):
            # the JAX package's farfield._check_band, raised here
            raise ValueError(
                "farfield_band_p does not compose with the pseudo-2D (2-D "
                "box) far field yet — its lattices are cyclic/image-summed; "
                "use image_shells for accuracy there")

    def replace(self, **kw) -> "SimulationConfig":
        return dataclasses.replace(self, **kw)
