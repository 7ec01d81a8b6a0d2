"""The system under test, built from a cell's data: the port's
configuration, body geometry, initial state and forces.  The only module
of the harness that imports the port, and only inside its functions."""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import torch

from benchmark import traffic as traffic_mod
from benchmark.reference.rpy import load_shell
from benchmark.spec import ROOT


class System(NamedTuple):
    cfg: object          # the port's SimulationConfig
    geom: object         # the port's RefGeometry
    state: object        # the port's BodyState at the seed's placements
    force_fn: Callable   # (state, step) → (B, 6)
    chunk: int
    sim: dict            # the settings, as the reference reads them
    shell: tuple         # (a, (n, 3) float64 offsets) from the structure file


def settings(cell) -> dict:
    """The simulation settings of a cell: its configuration's, then its
    traffic mix's."""
    return {**cell["config"]["simulation"],
            **cell["traffic"].get("simulation", {})}


def build(cell, seed, device) -> System:
    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch.ops import kinematics as kin
    from rigid_body_light_tpu_torch.run import build_forces

    conf = cell["config"]
    path = os.path.join(ROOT, conf["structure"])
    params, blobs = rt.load_structure(path)
    sim = settings(cell)
    cfg = rt.SimulationConfig(a=params["sep"] / 2, dtype=torch.float32,
                              **sim)
    geom = kin.make_ref_geometry(blobs, dtype=torch.float32, device=device)
    X, Q = traffic_mod.placements(cell["traffic"], seed, device)
    state = rt.make_state(X, Q, dtype=torch.float32, device=device)
    forces = build_forces(conf["forces"], default_box=sim.get("box"))
    if forces is None:
        def forces(s, i):
            return torch.zeros((s.X.shape[0], 6), dtype=s.X.dtype,
                               device=s.X.device)
    ref_sim = {"a": cfg.a, "eta": cfg.eta, "dt": cfg.dt, "wall": cfg.wall,
               "box": cfg.box, "h_floor": cfg.wall_h_floor,
               "max_move": cfg.max_move, "max_rotation": cfg.max_rotation,
               "max_step_residual": cfg.max_step_residual,
               "reject_below_wall": cfg.reject_below_wall,
               "ewald_rc": cfg.ewald_rc,
               "gmres_tol": cfg.gmres_tol,
               "gmres_restart": cfg.gmres_restart}
    tr = cell["traffic"]
    return System(cfg, geom, state, forces, int(tr["chunk"]), ref_sim,
                  load_shell(path))


def run_chunk(system: System, state, n_steps, generator, force_fn):
    """One chunk of the window: ``run_bd`` as the port's runner calls it."""
    from rigid_body_light_tpu_torch.dynamics import stepper

    return stepper.run_bd(system.geom, system.cfg, state, n_steps,
                  generator=generator, force_fn=force_fn)


def program_outputs(system: System, state, generator):
    """What the check judges, from the port at ``state``: the blob
    mobility product on one and on two seeded right-hand sides (the
    window's GMRES and fused-noise operators), one fluctuating step of
    the window's entry with seeded draws, and the window's saddle solve
    of a seeded slip and force.  Returns a dict of float64 host
    tensors."""
    from benchmark.check import solve_inputs
    from rigid_body_light_tpu_torch.dynamics import stepper
    from rigid_body_light_tpu_torch.ops import lanczos, saddle, solvers

    cfg, geom = system.cfg, system.geom
    ops = saddle.geometry_ops(geom, state)
    r = ops.flat_positions
    kw = dict(generator=generator, dtype=torch.float32, device=r.device)
    F1 = torch.randn(r.shape, **kw)
    F2 = torch.randn((2,) + tuple(r.shape), **kw)
    U1 = saddle.mobility_apply_fn(cfg)(F1, r)
    U2 = saddle.mobility_apply_multi_fn(cfg)(F2, r)
    pc = saddle.build_pc(ops, cfg)
    noise_pc = lanczos.make_noise_preconditioner(geom.ref_cfg, cfg.a, cfg.eta)
    draws = stepper.make_draws(geom, state, generator, cfg)
    new, aux = stepper.stochastic_step(
        geom, cfg, state, system.force_fn(state, 0), pc=pc,
        noise_pc=noise_pc, draws=draws)
    slip, force = (v.float() for v in solve_inputs(
        state.X, state.Q, system.shell, cfg.eta, generator))
    res = solvers.solve_saddle(ops, cfg, slip, force, pc=pc)
    host = {"X": state.X, "Q": state.Q, "F1": F1, "F2": F2, "U1": U1,
            "U2": U2, "X_new": new.X, "Q_new": new.Q, "U_step": aux.U,
            "residual": aux.residual, "slip": slip, "force": force,
            "lam": res.lam, "U_solve": res.U}
    return {k: v.detach().double().cpu() for k, v in host.items()}


def positions(system: System, state):
    """(N, 3) blob positions of ``state`` as the port forms them."""
    from rigid_body_light_tpu_torch.ops import saddle

    return saddle.geometry_ops(system.geom, state).flat_positions
