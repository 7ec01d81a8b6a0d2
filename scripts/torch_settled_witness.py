#!/usr/bin/env python3
"""Does the gap between the block_free and the RAS solution of the settled
saddle system follow the GMRES tolerance or the preconditioner?

    python3 scripts/torch_settled_witness.py [--device cpu|cuda]
        [--shell shell_N_642] [--out FILE.json]

At the geometry of the settled checkpoint (``scripts/data/settled_642.npz``,
16 bodies; ``--shell shell_N_42`` puts 42-blob shells of the same
hydrodynamic radius there, a size for the CPU) the script solves one
saddle system with a random slip (standard normal, seed 0) and the
settled forces (gravity −ẑ, wall repulsion 4 / 0.3 / 1) with both
preconditioners:

- in float64 through the plain mobility sweep (``use_pallas=False``), at
  gmres_tol 1e-5 and 1e-10;
- on the card also in float32 through the kernels at 1e-5, the solve whose
  two U were compared in ``chip_smoke.py``'s first form of phase 17.

It prints, for each solve, the GMRES iterations, the preconditioned and
the true residual, and max|U − U_ref|/max|U_ref| against the float64 RAS
solve at 1e-10; and for each tolerance the gap max|U_ras − U_bf|/max|U_bf|
and the share of the solution's norm that U holds.  If the gap follows
the tolerance it shrinks with it in float64; if it followed the
preconditioner it would stay.  One JSON line last.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import rigid_body_light_tpu_torch as rt                      # noqa: E402
from rigid_body_light_tpu_torch import forces                # noqa: E402
from rigid_body_light_tpu_torch.ops import kinematics as kin  # noqa: E402
from rigid_body_light_tpu_torch.ops import saddle, solvers   # noqa: E402
from rigid_body_light_tpu_torch.utils import checkpoint      # noqa: E402

CKPT = os.path.join(ROOT, "scripts", "data", "settled_642.npz")
SEED = 0
TOLS = (1e-5, 1e-10)
MAXITER = 2000


def setup(shell, dtype, device):
    params, ref = rt.load_structure(shell)
    cfg = rt.SimulationConfig(
        a=params["sep"] / 2, dt=0.01, kBT=1.0, wall=True, dtype=dtype,
        gmres_restart=60, gmres_maxiter=MAXITER, matvec_row_tile=512,
        pc_mode="ras", pc_halo=8.0, pc_halo_max=64)
    geom = kin.make_ref_geometry(ref, dtype=dtype, device=device)
    state, _, _, _ = checkpoint.load_checkpoint(CKPT, dtype=dtype,
                                                device=device)
    force_fn = forces.sum_forces(
        forces.gravity(np.array([0, 0, -1.0, 0, 0, 0])),
        forces.wall_repulsion(strength=4.0, debye_length=0.3, radius=1.0))
    return cfg, saddle.geometry_ops(geom, state), force_fn(state, 0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shell", default="shell_N_642")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    runs = [(torch.float64, False, tol) for tol in TOLS]
    if dev.type == "cuda":
        runs.append((torch.float32, True, 1e-5))
    slip_np = None
    out = {"shell": args.shell, "device": args.device, "solves": []}
    sols = {}
    for dtype, kernels, tol in runs:
        cfg, ops, f = setup(args.shell, dtype, dev)
        n = ops.flat_positions.shape[0]
        if slip_np is None:
            slip_np = np.random.default_rng(SEED).standard_normal((n, 3))
        slip = torch.from_numpy(slip_np).to(dev, dtype)
        for mode in ("block_free", "ras"):
            c = cfg.replace(pc_mode=mode, gmres_tol=tol, use_pallas=kernels)
            res = solvers.solve_saddle(ops, c, slip, f, true_residual=True)
            key = (str(dtype).split(".")[-1], tol, mode)
            sols[key] = res
            print(f"{key[0]} gmres_tol {tol:g} {mode}: {res.iters} "
                  f"iterations, residual {float(res.residual):.3e}, true "
                  f"residual {float(res.true_residual):.3e}", flush=True)
    ref = sols[("float64", TOLS[-1], "ras")]
    U_ref = ref.U.double()
    share = (U_ref.norm() / torch.sqrt(U_ref.norm() ** 2
                                       + ref.lam.double().norm() ** 2)).item()
    print(f"n = {n} blobs; |U| / |(lambda, U)| of the reference solution "
          f"(float64 RAS at {TOLS[-1]:g}): {share:.3e}")
    for (dt, tol, mode), res in sols.items():
        err = ((res.U.double() - U_ref).abs().max()
               / U_ref.abs().max()).item()
        out["solves"].append(dict(dtype=dt, tol=tol, mode=mode,
                                  iters=int(res.iters),
                                  residual=float(res.residual),
                                  true_residual=float(res.true_residual),
                                  u_err_vs_ref=err))
        print(f"{dt} {tol:g} {mode}: max|U - U_ref|/max|U_ref| = {err:.3e}")
    out["gaps"] = []
    for dt, tol in sorted({(k[0], k[1]) for k in sols}):
        bf, ras = sols[(dt, tol, "block_free")], sols[(dt, tol, "ras")]
        gap = ((ras.U.double() - bf.U.double()).abs().max()
               / bf.U.double().abs().max()).item()
        out["gaps"].append(dict(dtype=dt, tol=tol, gap=gap))
        print(f"{dt} gmres_tol {tol:g}: max|U_ras - U_bf|/max|U_bf| = "
              f"{gap:.3e}")
    out["u_share"] = share
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
