#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits nonzero):

  0. the card: name and power limit from nvidia-smi, torch and CUDA versions;
  1. build the pair-sweep kernels K1/K2 from
     rigid_body_light_tpu_torch/csrc/rpy_pair_sweep.cu (sm_90a);
  2. K1 (symmetric sweep, 1 RHS) against the plain PyTorch sweep in float64
     on the card, wall and free, at the slice's 10,272 blob positions and a
     ragged 1,000-blob cloud straddling the wall-height floor; then K1's
     time against the plain float32 sweep at the slice's shape;
  3. the same for K2 (ordered sweep, 2 RHS);
  4. the slice: 16 × shell_N_642 = 10,272 blobs above a wall (the JAX
     package's bench.py::seg_dispersed configuration), run_bd for 1 warm-up
     and 8 timed steps through the kernels, with the launch counts read
     around that run;
  5. one step through the kernels against one step through the plain
     float32 sweep, from identical draws.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it holds the per-kernel JSON summary.  Without a CUDA
device the script exits nonzero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np

N_BODIES = 16
SHELL = "shell_N_642"
WARM_STEPS = 1
TIMED_STEPS = 8
SEED = 0
# float32 kernel vs the float64 plain sweep, max|ΔU| / max|U|: the bound
# tests/test_pallas.py holds the TPU kernel to against a float64 oracle
KERNEL_TOL = 5e-6
# kernel step vs plain step, max|ΔX_k − ΔX_p| / max|ΔX_p|: the float32 step
# bound of tests/test_torch_step_f32.py (two float32 solves stopped at
# gmres_tol, plus the RFD drift's 1/rfd_delta = 1e4 amplification of
# float32 roundoff)
STEP_TOL = 2e-3
SOURCE = "rigid_body_light_tpu_torch/csrc/rpy_pair_sweep.cu"


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def slice_setup(torch, device):
    """bench.py::seg_dispersed: 16 × shell_N_642 on a 4 × 4 lattice at
    heights 2.0-2.4, force −ẑ on every body, its _base_cfg settings."""
    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch.ops import kinematics as kin

    params, ref = rt.load_structure(SHELL)
    xs = np.array([[2.5 * (i % 4), 2.5 * (i // 4), 2.0 + 0.2 * (i % 3)]
                   for i in range(N_BODIES)])
    qs = np.tile([1.0, 0, 0, 0], (N_BODIES, 1))
    cfg = rt.SimulationConfig(
        a=params["sep"] / 2, dt=0.01, kBT=1.0, wall=True,
        dtype=torch.float32, lanczos_iters=6, lanczos_precond=True,
        gmres_tol=1e-4, gmres_restart=20, gmres_maxiter=60,
        matvec_row_tile=512, pc_mode="block_free")
    geom = kin.make_ref_geometry(ref, dtype=torch.float32, device=device)
    state = rt.make_state(xs, qs, dtype=torch.float32, device=device)
    force = torch.zeros((N_BODIES, 6), dtype=torch.float32, device=device)
    force[:, 2] = -1.0
    return cfg, geom, state, force


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(torch, name, apply_kernel, apply_plain, clouds, a, eta):
    """Kernel (float32) against the plain sweep (float64), wall and free,
    on each cloud.  Returns the max absolute error at the first cloud's
    wall case (the main path's shape)."""
    main_err = None
    for label, r, F in clouds:
        for wall in (True, False):
            U = apply_kernel(F.float(), r.float(), a, eta, wall)
            torch.cuda.synchronize()
            ref = apply_plain(F.double(), r.double(), a, eta, wall)
            err = (U.double() - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            print(f"{name} {label} n={r.shape[0]} wall={wall}: max|dU|={err:.3e} "
                  f"max|dU|/max|U|={rel:.3e} (tol {KERNEL_TOL:g})")
            if not (rel <= KERNEL_TOL and torch.isfinite(U).all()):
                raise AssertionError(f"{name} disagrees with the plain "
                                     f"sweep on {label}, wall={wall}: {rel}")
            if main_err is None:
                main_err = err
    return main_err


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port's main path runs on the "
              "GPU only", file=sys.stderr)
        return 1
    try:
        from rigid_body_light_tpu_torch.dynamics import (make_draws, run_bd,
                                                         stochastic_step)
        from rigid_body_light_tpu_torch.ops import rpy, rpy_cuda
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # ---- 0. the card
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")

    # ---- 1. build
    t0 = time.perf_counter()
    rpy_cuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{rpy_cuda.build_info['path']}")
    for line in rpy_cuda.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    cfg, geom, state, force = slice_setup(torch, dev)
    from rigid_body_light_tpu_torch.ops import kinematics as kin
    r_slice = kin.blob_positions(geom, state.X, state.Q).reshape(-1, 3)
    n = r_slice.shape[0]
    a, eta, h = cfg.a, cfg.eta, cfg.wall_h_floor
    rng = np.random.default_rng(SEED)
    F2 = torch.from_numpy(rng.standard_normal((2, n, 3))).to(dev)
    ragged = torch.from_numpy(
        rng.uniform([-12 * a, -12 * a, 0.3 * a], [12 * a, 12 * a, 8 * a],
                    (1000, 3))).to(dev)
    Fr = torch.from_numpy(rng.standard_normal((2, 1000, 3))).to(dev)

    # ---- 2. K1 vs plain
    k1_err = check_kernel(
        torch, "K1 pair_sweep_sym",
        lambda F, r, a_, e_, w: rpy_cuda.mobility_apply(F[0], r, a_, e_, w),
        lambda F, r, a_, e_, w: rpy.mobility_apply(F[0], r, a_, e_, w),
        [("slice", r_slice, F2), ("ragged", ragged, Fr)],
        a, eta)
    r32 = (r_slice / a).contiguous()
    F32 = F2.float().contiguous()
    ids = torch.arange(n, device=dev)
    k1_ms = cuda_ms(torch, lambda: rpy_cuda.pair_sweep_sym(
        r32, F32[0], True, h), 20)
    k1_plain_ms = cuda_ms(torch, lambda: rpy.pair_sum(
        r32, ids, r32, ids, F32[0], wall=True, h_floor=h), 3)
    k1_gflops = n * n * (60 + 2 * 30) / 2 / (k1_ms * 1e-3) / 1e9
    print(f"K1 time at n={n}, wall, 1 RHS: kernel {k1_ms:.4f} ms "
          f"({k1_gflops:.1f} GFLOP/s at 60 flop/ordered pair), plain "
          f"float32 {k1_plain_ms:.4f} ms")

    # ---- 3. K2 vs plain
    k2_err = check_kernel(
        torch, "K2 pair_sweep_ordered",
        lambda F, r, a_, e_, w: rpy_cuda.mobility_apply_multi(F, r, a_, e_, w),
        lambda F, r, a_, e_, w: rpy.mobility_apply_multi(F, r, a_, e_, w),
        [("slice", r_slice, F2), ("ragged", ragged, Fr)],
        a, eta)
    k2_ms = cuda_ms(torch, lambda: rpy_cuda.pair_sweep_ordered(
        r32, 0, r32, F32, 0, True, h), 20)
    k2_plain_ms = cuda_ms(torch, lambda: rpy.pair_sum(
        r32, ids, r32, ids, F32, wall=True, h_floor=h), 3)
    k2_gflops = n * n * (60 + 2 * 30) / (k2_ms * 1e-3) / 1e9
    print(f"K2 time at n={n}, wall, 2 RHS: kernel {k2_ms:.4f} ms "
          f"({k2_gflops:.1f} GFLOP/s at 120 flop/ordered pair), plain "
          f"float32 {k2_plain_ms:.4f} ms")

    # ---- 4. the slice through the kernels
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = state.X.clone()
    rpy_cuda.reset_launch_counts()
    s, tr_w = run_bd(geom, cfg, state, WARM_STEPS, generator=gen,
                     force_fn=lambda s_, i: force)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, tr = run_bd(geom, cfg, s, TIMED_STEPS, generator=gen,
                   force_fn=lambda s_, i: force)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = rpy_cuda.launch_counts()
    res = torch.cat([tr_w["residual"], tr["residual"]])
    iters = torch.cat([tr_w["iters"], tr["iters"]]).double()
    print(f"slice: {N_BODIES} x {SHELL} = {n} blobs, {TIMED_STEPS} steps in "
          f"{wall_s:.3f} s = {TIMED_STEPS / wall_s:.4f} steps/s; max residual "
          f"{res.max().item():.3e}; mean GMRES iters {iters.mean().item():.2f};"
          f" max noise_err {tr['noise_err'].max().item():.3e}; launches "
          f"{counts}")
    qn = torch.linalg.norm(s.Q, dim=1)
    checks = {
        "max residual < 10 gmres_tol": res.max().item() < 10 * cfg.gmres_tol,
        "state finite": bool(torch.isfinite(s.X).all()
                             and torch.isfinite(s.Q).all()),
        "|q| within 1e-5 of 1": (qn - 1).abs().max().item() <= 1e-5,
        "bodies moved": (s.X - x0).abs().max().item() > 0,
        "K1 launched": counts["pair_sweep_sym"] > 0,
        "K2 launched": counts["pair_sweep_ordered"] > 0,
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"slice check failed: {what}")

    # ---- 5. kernel step vs plain step, identical draws
    draws = make_draws(geom, s, gen)
    s_k, aux_k = stochastic_step(geom, cfg, s, force, draws=draws)
    s_p, aux_p = stochastic_step(geom, cfg.replace(use_pallas=False), s,
                                 force, draws=draws)
    torch.cuda.synchronize()
    dX_k, dX_p = s_k.X - s.X, s_p.X - s.X
    rel = ((dX_k - dX_p).abs().max() / dX_p.abs().max()).item()
    print(f"step kernel vs plain: max|dX_k - dX_p|/max|dX_p| = {rel:.3e} "
          f"(tol {STEP_TOL:g}); iters {aux_k.iters} vs {aux_p.iters}; "
          f"residual {aux_k.residual.item():.3e} vs "
          f"{aux_p.residual.item():.3e}")
    if not (rel <= STEP_TOL and torch.isfinite(s_k.X).all()):
        raise AssertionError(f"kernel step disagrees with the plain step: "
                             f"{rel}")

    summary = {"kernels": [
        {"name": "pair_sweep_sym", "route": "cuda", "source": SOURCE,
         "replaces": "rigid_body_light_tpu/ops/rpy_pallas.py:312",
         "launches": counts["pair_sweep_sym"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "pair_sweep_ordered", "route": "cuda", "source": SOURCE,
         "replaces": "rigid_body_light_tpu/ops/rpy_pallas.py:175",
         "launches": counts["pair_sweep_ordered"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
