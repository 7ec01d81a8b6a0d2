#!/usr/bin/env python3
"""Is the pseudo-2D film's mobility positive definite?  The lowest
eigenvalues of the damped film mobility B·M·B (float64, dense), and the
GMRES iterations and moves of two film steps.

    python3 scripts/torch_film_operator.py [--device cpu|cuda]
                                           [--shells shell_N_42 shell_N_162]

The film is chip_smoke.py's: 16 bodies on a 4 × 4 lattice (spacing 2.5,
heights 2.0-2.4, identity orientation) in the (10, 10) box it tiles
exactly, above the wall; also the lattice with each body shifted in the
plane by up to ±0.05 and ±0.3 (off the seams), and 4 bodies in a (5, 5)
box.  The slice uses shell_N_642; the dense matrix of 10,272 blobs is out
of reach, so smaller shells stand in (the same bodies' radius, fewer
blobs).  For each: the damped mobility's lowest eigenvalue and its
count of negative ones at image_shells 0, 1 and 2.  Then, per shell, two
steps of ``run_bd`` in float32 with the film's physics
(examples/periodic_film.json) at image_shells 0 for the 16-body film and
2 for the 4-body one: GMRES iterations, residuals and the largest move.
Runs on the card (the steps through the pair-sweep kernels); ``--device
cpu`` takes the plain sweep and a few minutes on 4 CPU cores.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def film(rt, kin, forces, torch, shell, n_side, shells, shift, seed, device,
         dtype):
    params, ref = rt.load_structure(shell)
    box = (2.5 * n_side, 2.5 * n_side)
    B = n_side * n_side
    xs = np.array([[2.5 * (i % n_side), 2.5 * (i // n_side),
                    2.0 + 0.2 * (i % 3)] for i in range(B)])
    xs[:, :2] += np.random.default_rng(seed).uniform(-shift, shift, (B, 2))
    cfg = rt.SimulationConfig(
        a=params["sep"] / 2, dt=0.01, kBT=0.3, wall=True, box=box,
        image_shells=shells, dtype=dtype, lanczos_iters=8,
        gmres_tol=1e-4, gmres_restart=20, gmres_maxiter=60,
        pc_mode="block_free")
    geom = kin.make_ref_geometry(ref, dtype=dtype, device=device)
    state = rt.make_state(xs, np.tile([1.0, 0, 0, 0], (B, 1)), dtype=dtype,
                          device=device)
    force_fn = forces.sum_forces(
        forces.gravity(np.array([0, 0, -1.0, 0, 0, 0])),
        forces.wall_repulsion(4.0, 0.3),
        forces.pair_yukawa(1.0, 0.5, diameter=2.0, box=box))
    return cfg, geom, state, force_fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shells", nargs="+",
                    default=["shell_N_42", "shell_N_162"])
    args = ap.parse_args()
    import torch

    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch import forces
    from rigid_body_light_tpu_torch.dynamics import run_bd
    from rigid_body_light_tpu_torch.ops import kinematics as kin
    from rigid_body_light_tpu_torch.ops import rpy

    dev = torch.device(args.device)
    for shell in args.shells:
        for n_side, shift in ((4, 0.0), (4, 0.05), (4, 0.3), (2, 0.0)):
            for S in (0, 1, 2):
                cfg, geom, state, _ = film(rt, kin, forces, torch, shell,
                                           n_side, S, shift, 0, dev,
                                           torch.float64)
                r = kin.blob_positions(geom, state.X, state.Q).reshape(-1, 3)
                M = rpy.mobility_matrix(r, cfg.a, cfg.eta, True, box=cfg.box,
                                        image_shells=S)
                b = rpy.damping_factors(r, cfg.a).repeat_interleave(3)
                M = b[:, None] * M * b[None, :]
                ev = torch.linalg.eigvalsh(0.5 * (M + M.T))
                print(f"{shell}: {n_side * n_side} bodies, box {cfg.box}, "
                      f"shift ±{shift:g}, image_shells={S}: {r.shape[0]} "
                      f"blobs, lowest eigenvalue {ev[0].item():.6g} (largest "
                      f"{ev[-1].item():.6g}), {int((ev < 0).sum())} negative",
                      flush=True)
        for n_side, S in ((4, 0), (2, 2)):
            cfg, geom, state, force_fn = film(rt, kin, forces, torch, shell,
                                              n_side, S, 0.0, 0, dev,
                                              torch.float32)
            gen = torch.Generator(device=dev).manual_seed(0)
            s, tr = run_bd(geom, cfg, state, 2, generator=gen,
                           force_fn=force_fn)
            print(f"{shell}: {n_side * n_side} bodies, box {cfg.box}, "
                  f"image_shells={S}, 2 steps: GMRES iterations "
                  f"{tr['iters'].tolist()}, residuals "
                  f"{[f'{x:.3e}' for x in tr['residual'].tolist()]}, largest "
                  f"move {(s.X - state.X).abs().max().item():.4g}", flush=True)


if __name__ == "__main__":
    main()
