#!/usr/bin/env python3
"""Time the PyTorch port's pair-sweep kernels of several checkouts in
turns on one card.

    python3 scripts/torch_sweep_turns.py [--only GROUPS] OUT_DIR CHECKOUT_A ...

Each CHECKOUT is the root of a checkout of this repository (for example
another commit, unpacked with ``git archive`` into a gitignored
directory).  The script starts one process per checkout, in the order
A B ... B A, so that a drift of the card's clock over the call reaches
every checkout alike.  Each process imports that checkout's
``rigid_body_light_tpu_torch`` and ``chip_smoke.py``, builds the kernels
from that checkout's sources, and times them by CUDA events at the shapes
of the main paths (``chip_smoke``'s slices):

  K1 at 1 and 2 RHS (2 RHS where the checkout's K1 takes it) and K2 at 2
  RHS at the dense slice's 10,272 positions, wall;
  where the checkout has them, K1's box forms at 1 and 2 RHS and K2's at
  2 RHS at the pseudo-2D film's 10,272 positions in its (10, 10) box, at
  image_shells 0 and 2;
  K3 at 1 and 2 RHS at the far-field slice's 102,480 positions;
  K4 at 1 and 2 RHS at the periodic slice's 10,272 positions;
  K4's slab form at 1 and 2 RHS on the distributed ring's blocks of those
  positions, n/4 × n/4 (D = 4) and n/2 × n/2 (D = 2), and its two
  kernels' device time apart (the sweep, the chunk sum) by torch.profiler;
  K1 beyond the slices, up to where its blocks walk groups of tiles, at
  the sizes of SCALE_K1 (clouds at the dense slice's blob density, as
  chip_smoke's phase 16), and K4 at 1 and 2 RHS at the sizes of
  K4_SCALE (uniform clouds in the periodic box).

``--only`` takes a comma-separated subset of the groups "dense" (K1, K2),
"film", "K3", "K4", "K4 slab", "K1 scale" and "K4 scale" (default: all).
Every process saves its outputs under OUT_DIR; the last lines compare
each checkout's outputs with the first's (bitwise, and max|ΔU|/max|U|)
and list the times.  Needs one CUDA card.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np

SEED = 0
REPS = 20
# (blobs, RHS) of K1 beyond the slices: sizes where the earlier grouping
# (tile_items.cuh) stepped its group size (129 and 161 tiles), the first
# sizes past 256 and 512 tiles, the far-field slice's size and the JAX
# package's measured size; calls timed at each (the largest take ~0.5 s a
# call on an H100)
SCALE_K1 = [(16_512, 1), (20_544, 1), (33_000, 1), (50_000, 1), (66_000, 1),
            (66_000, 2), (102_480, 1), (102_480, 2), (409_600, 1),
            (409_600, 2)]
SCALE_REPS = {16_512: REPS, 20_544: REPS, 33_000: 10, 50_000: 10,
              66_000: 10, 102_480: 5, 409_600: 3}
# K4 beyond the periodic slice, uniform clouds in its box, 1 and 2 RHS
K4_SCALE = {16_512: REPS, 33_000: 10, 66_000: 5}
GROUPS = ("dense", "film", "K3", "K4", "K4 slab", "K1 scale", "K4 scale")
SLAB_REPS = 50


def dense_cloud(torch, r_slice, n, seed, dev):
    """n positions at the blob density of ``r_slice`` (its bounding box),
    uniform in a square slab of its heights."""
    lo, hi = r_slice.min(dim=0).values, r_slice.max(dim=0).values
    dens = r_slice.shape[0] / torch.prod(hi - lo).item()
    z_lo, z_hi = lo[2].item(), hi[2].item()
    side = (n / (dens * (z_hi - z_lo))) ** 0.5
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform([0, 0, z_lo], [side, side, z_hi],
                                        (n, 3))).to(dev).float()


def kernel_us(torch, fn, reps):
    """{kernel: device µs a call} of the CUDA kernels ``fn`` launches, by
    torch.profiler over ``reps`` calls after one warm-up (empty where the
    trace holds no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if us > 0:
            m = re.search(r"(\w+)(<[^<>()]*>)?\(", e.key)
            name = m.group(1) + (m.group(2) or "") if m else e.key
            out[name] = out.get(name, 0.0) + us / reps
    return out


def child(out_path, groups):
    import torch

    import chip_smoke as cs
    from rigid_body_light_tpu_torch.ops import (cuda_build, ewald_cuda,
                                                farfield, farfield_cuda,
                                                kinematics, rpy_cuda, saddle)

    dev = torch.device("cuda", 0)
    for name, (_, log) in cuda_build.build().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")
    rng = np.random.default_rng(SEED)
    times, outs = {}, {}

    def timed(key, fn, keep=None):
        U = fn()
        outs[key] = (U if keep is None else U[:, keep]).cpu().numpy()
        times[key] = cs.cuda_ms(torch, fn, REPS)

    cfg, geom, state, _ = cs.slice_setup(torch, dev)
    h = cfg.wall_h_floor
    r = (kinematics.blob_positions(geom, state.X, state.Q).reshape(-1, 3)
         / cfg.a).contiguous()
    n = r.shape[0]
    F = torch.from_numpy(rng.standard_normal((2, n, 3))).to(dev).float()
    if "dense" in groups:
        timed("K1 1 RHS", lambda: rpy_cuda.pair_sweep_sym(r, F[0], True, h))
        try:
            rpy_cuda.pair_sweep_sym(r, F, True, h)
        except ValueError:
            pass    # this checkout's K1 takes one RHS
        else:
            timed("K1 2 RHS", lambda: rpy_cuda.pair_sweep_sym(r, F, True, h))
        timed("K2 2 RHS", lambda: rpy_cuda.pair_sweep_ordered(r, 0, r, F, 0,
                                                              True, h))
    if "film" in groups and hasattr(rpy_cuda, "box_args"):
        cfg_b, geom_b, state_b, _ = cs.film_setup(torch, dev, 0)
        r_b = (kinematics.blob_positions(geom_b, state_b.X, state_b.Q)
               .reshape(-1, 3) / cfg_b.a).contiguous()
        box_n = tuple(L / cfg_b.a for L in cfg_b.box)
        for S in (0, 2):
            b = rpy_cuda.box_args(box_n, S)
            for k in (1, 2):
                Fk = F[:k].contiguous()
                timed(f"K1 {k} RHS box S={S}", lambda: rpy_cuda.pair_sweep_sym(
                    r_b, Fk, True, h, box=b))
            timed(f"K2 2 RHS box S={S}", lambda: rpy_cuda.pair_sweep_ordered(
                r_b, 0, r_b, F, 0, True, h, box=b))

    if "K3" in groups:
        cfg_f, geom_f, state_f, _ = cs.farfield_setup(torch, dev,
                                                      cs.FF_BODIES)
        r_f = kinematics.blob_positions(geom_f, state_f.X,
                                        state_f.Q).reshape(-1, 3)
        ctx = farfield.prepare(r_f, a=cfg_f.a, wall=True, grid=cs.FF_GRID,
                               p=cs.FF_P)
        live = (ctx.id_s >= 0).contiguous()
        F_f = torch.from_numpy(rng.standard_normal(
            (2, ctx.x_s.shape[0], 3))).to(dev).float()
        for k in (1, 2):
            Fk = F_f[:k].contiguous()
            timed(f"K3 {k} RHS", lambda: farfield_cuda.near_sweep_kernel(
                ctx.x_s.contiguous(), ctx.ci_s.contiguous(), live, Fk,
                ctx.nbr, ctx.pairs, ctx.n_pairs, True, h), keep=live)

    cfg_e, geom_e, state_e = cs.ewald_setup(torch, dev)
    r_e = kinematics.blob_positions(geom_e, state_e.X, state_e.Q).reshape(
        -1, 3).contiguous()
    par = saddle._ewald_params(cfg_e.box, cfg_e.a, cfg_e.eta, None,
                               cfg_e.ewald_tol)
    F_e = torch.from_numpy(rng.standard_normal((2, n, 3))).to(dev).float()
    if "K4" in groups:
        for k in (1, 2):
            Fk = F_e[:k].contiguous()
            timed(f"K4 {k} RHS", lambda: ewald_cuda.real_sweep_kernel(
                r_e, Fk, par))
    for D in ((4, 2) if "K4 slab" in groups else ()):
        # the ring's block of rank 1 against rank 0's columns
        m = n // D
        rows, cols = r_e[m:2 * m].contiguous(), r_e[:m].contiguous()
        for k in (1, 2):
            Fk = F_e[:k, :m].contiguous()
            U = ewald_cuda.real_slab_kernel(rows, m, cols, 0, Fk, par)
            outs[f"K4 slab D={D} {k} RHS"] = U.cpu().numpy()
            times[f"K4 slab D={D} {k} RHS"] = cs.cuda_ms(
                torch, lambda: ewald_cuda.real_slab_kernel(rows, m, cols, 0,
                                                           Fk, par),
                SLAB_REPS)
            split = kernel_us(torch, lambda: ewald_cuda.real_slab_kernel(
                rows, m, cols, 0, Fk, par), SLAB_REPS)
            print(f"  K4 slab D={D} {k} RHS, torch.profiler, µs a call: "
                  + ", ".join(f"{key} {us:.2f}" for key, us in split.items()
                              if "slab" in key))
    for n_s, k in (SCALE_K1 if "K1 scale" in groups else ()):
        r_s = dense_cloud(torch, r, n_s, SEED + n_s, dev).contiguous()
        F_s = torch.from_numpy(np.random.default_rng(SEED + n_s + k)
                               .standard_normal((k, n_s, 3))).to(dev).float()
        U = rpy_cuda.pair_sweep_sym(r_s, F_s, True, h)
        outs[f"K1 {k} RHS n={n_s}"] = U.cpu().numpy()
        del U
        times[f"K1 {k} RHS n={n_s}"] = cs.cuda_ms(
            torch, lambda: rpy_cuda.pair_sweep_sym(r_s, F_s, True, h),
            SCALE_REPS[n_s])
        del r_s, F_s
        torch.cuda.empty_cache()
    for n_g, reps in (K4_SCALE.items() if "K4 scale" in groups else ()):
        rng_g = np.random.default_rng(SEED + n_g)
        r_g = torch.from_numpy(rng_g.uniform(0, cfg_e.box[0], (n_g, 3))).to(
            dev).float().contiguous()
        F_g = torch.from_numpy(rng_g.standard_normal((2, n_g, 3))).to(
            dev).float()
        for k in (1, 2):
            Fk = F_g[:k].contiguous()
            U = ewald_cuda.real_sweep_kernel(r_g, Fk, par)
            outs[f"K4 {k} RHS n={n_g}"] = U.cpu().numpy()
            times[f"K4 {k} RHS n={n_g}"] = cs.cuda_ms(
                torch, lambda: ewald_cuda.real_sweep_kernel(r_g, Fk, par),
                reps)
    np.savez(out_path, **outs)
    with open(out_path + ".json", "w") as f:
        json.dump(times, f)
    for key, ms in times.items():
        print(f"  {key}: {ms:.4f} ms")


def main():
    if len(sys.argv) > 3 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3].split(","))
        return 0
    args = sys.argv[1:]
    groups = ",".join(GROUPS)
    if args[:1] == ["--only"] and len(args) > 1:
        groups, args = args[1], args[2:]
        unknown = set(groups.split(",")) - set(GROUPS)
        if unknown:
            print(f"unknown groups {sorted(unknown)}; the groups: {GROUPS}",
                  file=sys.stderr)
            return 2
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir = os.path.abspath(args[0])
    dirs = [os.path.abspath(d) for d in args[1:]]
    os.makedirs(out_dir, exist_ok=True)
    order = list(range(len(dirs))) + list(range(len(dirs)))[::-1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    runs = []
    for turn, d in enumerate(order):
        path = os.path.join(out_dir, f"turn{turn}_{d}")
        print(f"--- turn {turn}: {dirs[d]}", flush=True)
        env = dict(os.environ, PYTHONPATH=dirs[d])
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", path, groups], cwd=dirs[d],
                              env=env)
        if proc.returncode != 0:
            print(f"turn {turn} failed: {proc.returncode}")
            return 1
        with open(path + ".json") as f:
            runs.append((d, json.load(f), dict(np.load(path + ".npz"))))
    for turn, (d, times, outs) in enumerate(runs):
        for key, ms in times.items():
            # the first turn that has this output is the reference
            t0, ref = next((t, o[key]) for t, (_, _, o) in enumerate(runs)
                           if key in o)
            cmp = "the reference"
            if t0 != turn:
                same = np.array_equal(outs[key], ref)
                rel = (np.abs(outs[key].astype(np.float64) - ref).max()
                       / np.abs(ref).max())
                cmp = f"bitwise {'equal' if same else 'different'}, " \
                      f"max|dU|/max|U| {rel:.3e} vs turn {t0}"
            print(f"turn {turn} checkout {d} {key}: {ms:.4f} ms ({cmp})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
