#!/usr/bin/env python3
"""Per-step GMRES residuals and iterations of an example config, through
the pair-sweep kernels and through the plain float32 sweep.

    python3 scripts/torch_example_residuals.py [examples/periodic_film.json]
        [--steps N] [--device cuda|cpu] [--seed S]

Builds the example's bodies, forces and solver as the run driver does
(``rigid_body_light_tpu_torch.run``), then runs ``dynamics.run_bd`` for
``--steps`` steps (default: the config's ``checkpoint_every``) twice from
the same generator seed: with ``use_pallas`` (K1/K2 on the card) and
without (the plain float32 sweep).  Prints one JSON line per path: the
steps whose residual ends above ``gmres_tol``, the largest residual, and
the iteration counts.  Steps are not comparable one by one (the float32
operators differ by roundoff and the trajectories part); the counts are.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rigid_body_light_tpu_torch import load_structure, run  # noqa: E402
from rigid_body_light_tpu_torch.dynamics import run_bd  # noqa: E402
from rigid_body_light_tpu_torch.ops import kinematics as kin  # noqa: E402
from rigid_body_light_tpu_torch.state import make_state  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", nargs="?", default="examples/periodic_film.json")
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    with open(args.config) as f:
        conf = json.load(f)
    params, blobs = load_structure(conf["structure"])
    a = conf.get("a") or params["sep"] / 2
    dtype = torch.float64 if conf.get("dtype") == "float64" else torch.float32
    cfg = run._build_cfg(conf, a, dtype)
    geom = kin.make_ref_geometry(blobs, dtype=dtype, device=args.device)
    X, Q = run.place_bodies(conf.get("placement"), conf["n_bodies"],
                            np.random.default_rng(conf.get("seed", 0)),
                            cfg.wall)
    state = make_state(X, Q, dtype=dtype, device=args.device)
    force_fn = run.build_forces(conf.get("forces"),
                                default_box=conf.get("box"))
    steps = args.steps or conf["checkpoint_every"]
    for use_pallas in (True, False):
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        _, tr = run_bd(geom, cfg.replace(use_pallas=use_pallas), state, steps,
                       generator=gen, force_fn=force_fn)
        res = tr["residual"].double().cpu().numpy()
        iters = tr["iters"].cpu().numpy()
        above = np.nonzero(res > cfg.gmres_tol)[0]
        print(json.dumps({
            "config": args.config, "path": "kernels" if use_pallas
            else "plain float32", "device": args.device, "steps": steps,
            "gmres_tol": cfg.gmres_tol, "gmres_maxiter": cfg.gmres_maxiter,
            "steps_above_tol": above.tolist(),
            "residuals_above_tol": res[above].tolist(),
            "max_residual": float(res.max()),
            "mean_iters": float(iters.mean()), "max_iters": int(iters.max()),
        }), flush=True)


if __name__ == "__main__":
    main()
