"""Production run driver — the port of ``rigid_body_light_tpu/run.py``:

    python -m rigid_body_light_tpu_torch.run config.json [--resume ckpt]
                                             [--device cuda|cpu]

A JSON config becomes a simulation: structures, body placement, force
fields, chunked stepping (``dynamics.run_bd``, or ``multi.run_bd_multi``
for a ``"species"`` mixture), the native trajectory writer, a checkpoint
after every chunk, resume.  The schema, the checks and the printed JSON
lines are the JAX driver's (its module docstring lists every key): per
chunk ``step``, ``steps_per_sec``, ``max_residual`` and
``mean_gmres_iters``, then a ``done`` line.

Differences from the JAX driver:

- the run is on the card unless ``--device cpu`` is given; without a card
  the default raises;
- the noise comes from one ``torch.Generator`` on the run's device, seeded
  from ``"seed"`` and carried across chunks; a checkpoint stores its state,
  so a resumed run draws the stream the uninterrupted run would have (a
  JAX checkpoint resumes from a generator seeded from its key data,
  ``utils.checkpoint.restore_generator``);
- a ``"mesh"`` key (multi-chip runs) raises ``NotImplementedError`` before
  anything is written: distribution is ROADMAP.md queue 1, item 16;
- the configuration, the chunking and the periodic box's geometry are all
  checked before the trajectory writer opens (and, without ``--resume``,
  truncates) ``trajectory.rblt``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def build_forces(specs, default_box=None):
    """The config's ``"forces"`` list → one ``force_fn(state, step)``, or
    None for an empty list."""
    from rigid_body_light_tpu_torch import forces

    fns = []
    for s in specs or []:
        t = s["type"]
        if t == "gravity":
            fns.append(forces.gravity(np.asarray(s["value"], np.float64)))
        elif t == "wall_repulsion":
            fns.append(forces.wall_repulsion(
                s["strength"], s["debye_length"], s.get("radius", 1.0)))
        elif t == "harmonic_trap":
            fns.append(forces.harmonic_trap(s["k"], np.asarray(s["center"])))
        elif t == "pair_yukawa":
            # the simulation box by default, so the repulsion sees the
            # geometry the hydrodynamics wraps
            box = s.get("box", default_box)
            box = tuple(box) if box else None
            fns.append(forces.pair_yukawa(
                s["strength"], s["debye_length"], s["diameter"], box=box))
        else:
            raise ValueError(f"unknown force type {t!r}")
    if not fns:
        return None
    return forces.sum_forces(*fns)


def place_bodies(spec, n_bodies, rng, wall):
    """Initial (X (B, 3), Q (B, 4)) as numpy arrays: a ``"grid"``,
    ``"random"`` (non-overlapping, from ``rng``, a numpy Generator) or a
    ``"file"`` npz with arrays X and Q — the JAX driver's placements."""
    spec = spec or {"type": "grid"}
    t = spec.get("type", "grid")
    if t == "grid":
        spacing = spec.get("spacing", 2.5)
        z0 = spec.get("z0", 2.0)
        side = int(np.ceil(np.sqrt(n_bodies)))
        X = np.array([[spacing * (i % side), spacing * (i // side),
                       z0 + 0.2 * (i % 3)] for i in range(n_bodies)])
        Q = np.tile([1.0, 0, 0, 0], (n_bodies, 1))
    elif t == "random":
        lo = 1.0 if wall else -10.0
        X = np.zeros((n_bodies, 3))
        placed = 0
        while placed < n_bodies:
            cand = rng.uniform([lo] * 3, [10.0] * 3)
            if (placed == 0
                    or np.linalg.norm(X[:placed] - cand, axis=1).min() > 2.0):
                X[placed] = cand
                placed += 1
        Q = rng.standard_normal((n_bodies, 4))
        Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    elif t == "file":
        with np.load(spec["path"]) as z:
            X, Q = z["X"], z["Q"]
    else:
        raise ValueError(f"unknown placement type {t!r}")
    return X, Q


def _chunking(conf):
    """(n_steps, save_every, chunk): a checkpoint after every chunk of
    ``checkpoint_every`` steps, a frame every ``save_every``."""
    n_steps = conf["n_steps"]
    save_every = conf.get("save_every", 10)
    ckpt_every = conf.get("checkpoint_every", max(1, n_steps // 5))
    chunk = min(ckpt_every, n_steps)
    if chunk % save_every != 0:
        raise ValueError(
            f"checkpoint_every ({chunk}) must be a multiple of save_every "
            f"({save_every}) — otherwise trajectory frames are dropped")
    if n_steps % chunk != 0:
        raise ValueError(
            f"n_steps ({n_steps}) must be a multiple of checkpoint_every "
            f"({chunk}) — each checkpoint chunk is one run_bd call")
    return n_steps, save_every, chunk


def _build_cfg(conf, a, dtype):
    """The SimulationConfig: every key of the ``"solver"`` section is a
    field (unknown keys raise at construction)."""
    from rigid_body_light_tpu_torch import SimulationConfig

    solver = dict(conf.get("solver", {}))
    solver.setdefault("gmres_tol", 1e-4)
    solver.setdefault("gmres_restart", 40)
    solver.setdefault("gmres_maxiter", 80)
    solver.setdefault("lanczos_iters", 30)
    return SimulationConfig(
        a=a, eta=conf.get("eta", 1.0), dt=conf["dt"], kBT=conf.get("kBT", 0.0),
        wall=bool(conf.get("wall", False)), dtype=dtype,
        box=tuple(conf["box"]) if conf.get("box") else None, **solver)


def _start(conf, args, device, dtype):
    """(output directory, the resumed (state, generator, step) or None).
    A checkpoint without random state resumes from ``"seed"``."""
    from rigid_body_light_tpu_torch.utils.checkpoint import (
        load_checkpoint, restore_generator)

    out_dir = conf.get("output_dir", "out")
    os.makedirs(out_dir, exist_ok=True)
    if not args.resume:
        return out_dir, None
    state, rng, step, _ = load_checkpoint(args.resume, dtype=dtype,
                                          device=device)
    gen = restore_generator(rng, device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(conf.get("seed", 0))
    print(f"resumed from {args.resume} at step {step}")
    return out_dir, (state, gen, step)


def _chunk_line(step, chunk, dt_chunk, traj):
    return json.dumps({
        "step": step,
        "steps_per_sec": round(chunk / dt_chunk, 4),
        "max_residual": float(traj["residual"].max()),
        "mean_gmres_iters": round(float(traj["iters"].double().mean()), 1),
    })


def _drive(run_chunk, state, gen, start_step, n_steps, chunk, save_every,
           dt, writer, ckpt_path, meta, frames_of):
    """The chunk loop: frames appended and flushed before the checkpoint
    that references them (a crash leaves no checkpoint ahead of the
    trajectory), one JSON line a chunk."""
    from rigid_body_light_tpu_torch.utils.checkpoint import save_checkpoint

    step = start_step
    while step < start_step + n_steps:
        t0 = time.perf_counter()
        state, traj = run_chunk(state, gen)
        Xs, Qs = frames_of(traj)   # host copies: the chunk's work is done
        dt_chunk = time.perf_counter() - t0
        for i in range(Xs.shape[0]):
            frame_step = step + (i + 1) * save_every
            writer.append(frame_step, frame_step * dt, Xs[i], Qs[i])
        step += chunk
        writer.flush()
        save_checkpoint(ckpt_path, state, gen, step=step, metadata=meta)
        print(_chunk_line(step, chunk, dt_chunk, traj), flush=True)
    return state


def main_multi(conf, args):
    """A ``"species"`` mixture through ``multi.run_bd_multi``; frames hold
    the concatenated bodies in species order (the sizes in the checkpoint's
    metadata and the ``done`` line)."""
    from rigid_body_light_tpu_torch import load_structure, multi
    from rigid_body_light_tpu_torch.runtime import TrajectoryWriter
    from rigid_body_light_tpu_torch.state import (BodyState, make_state,
                                                  resolve_device)
    from rigid_body_light_tpu_torch.utils.validation import check_box_geometry

    device = resolve_device(args.device)
    dtype = torch.float64 if conf.get("dtype") == "float64" else torch.float32
    rng = np.random.default_rng(conf.get("seed", 0))
    species = conf["species"]

    ref_cfgs, all_params = [], []
    for sp in species:
        params, blobs = load_structure(sp["structure"])
        ref_cfgs.append(np.asarray(blobs) * sp.get("scale", 1.0))
        all_params.append(params)
    a = conf.get("a") or all_params[0]["sep"] / 2
    cfg = _build_cfg(conf, a, dtype)
    mgeom = multi.MultiGeometry.create(
        ref_cfgs, dtype=dtype, radii=[sp.get("blob_radius") for sp in species],
        device=device)
    n_steps, save_every, chunk = _chunking(conf)
    if cfg.box is not None:
        for g in mgeom.geoms:
            check_box_geometry(cfg.box, g.ref_cfg.cpu().numpy(), cfg.a)

    out_dir, resumed = _start(conf, args, device, dtype)
    if resumed is not None:
        states, gen, start_step = resumed
        if isinstance(states, BodyState) or len(states) != len(species):
            raise RuntimeError(
                f"checkpoint {args.resume} does not match the configured "
                f"{len(species)}-species mixture")
    else:
        states = tuple(
            make_state(*place_bodies(sp.get("placement", conf.get("placement")),
                                     sp["n_bodies"], rng, cfg.wall),
                       dtype=dtype, device=device)
            for sp in species)
        gen = torch.Generator(device=device).manual_seed(conf.get("seed", 0))
        start_step = 0

    per_species_fns = [build_forces(sp.get("forces", conf.get("forces")),
                                    default_box=conf.get("box"))
                       for sp in species]
    sizes = tuple(s.X.shape[0] for s in states)

    def force_fn(ss, i):
        return tuple(
            fn(s, i) if fn is not None
            else torch.zeros((b, 6), dtype=dtype, device=device)
            for fn, s, b in zip(per_species_fns, ss, sizes))

    def run_chunk(ss, g):
        return multi.run_bd_multi(mgeom, cfg, ss, chunk, generator=g,
                                  force_fn=force_fn, save_every=save_every)

    def frames_of(traj):
        return (np.concatenate([x.cpu().numpy() for x in traj["X"]], axis=1),
                np.concatenate([q.cpu().numpy() for q in traj["Q"]], axis=1))

    traj_path = os.path.join(out_dir, "trajectory.rblt")
    writer = TrajectoryWriter(
        traj_path, sum(sizes),
        dtype=np.float64 if dtype == torch.float64 else np.float32,
        append=bool(args.resume))
    t_start = time.perf_counter()
    _drive(run_chunk, states, gen, start_step, n_steps, chunk, save_every,
           cfg.dt, writer, os.path.join(out_dir, "checkpoint.npz"),
           {"config": conf, "species_sizes": list(sizes)}, frames_of)
    writer.flush()
    writer.close()
    print(json.dumps({
        "done": True, "total_steps": n_steps,
        "wall_time_s": round(time.perf_counter() - t_start, 2),
        "trajectory": traj_path, "frames": writer.frames,
        "species_sizes": list(sizes)}))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="rigid_body_light_tpu_torch run driver")
    parser.add_argument("config", help="JSON config path")
    parser.add_argument("--resume", default=None,
                        help="checkpoint to resume from")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the run goes (default: the card)")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        conf = json.load(f)
    if conf.get("mesh"):
        raise NotImplementedError(
            "the 'mesh' key (a multi-chip run) is not ported to "
            "rigid_body_light_tpu_torch yet (ROADMAP.md queue 1, item 16): "
            "drop it to run on one device")

    if "species" in conf:
        return main_multi(conf, args)

    from rigid_body_light_tpu_torch import load_structure
    from rigid_body_light_tpu_torch.dynamics import run_bd
    from rigid_body_light_tpu_torch.ops import kinematics as kin
    from rigid_body_light_tpu_torch.runtime import TrajectoryWriter
    from rigid_body_light_tpu_torch.state import make_state, resolve_device
    from rigid_body_light_tpu_torch.utils.validation import check_box_geometry

    device = resolve_device(args.device)
    params, blobs = load_structure(conf["structure"])
    a = conf.get("a") or params["sep"] / 2
    dtype = torch.float64 if conf.get("dtype") == "float64" else torch.float32
    cfg = _build_cfg(conf, a, dtype)
    geom = kin.make_ref_geometry(blobs, dtype=dtype, device=device)
    rng = np.random.default_rng(conf.get("seed", 0))
    n_steps, save_every, chunk = _chunking(conf)
    if cfg.box is not None:
        check_box_geometry(cfg.box, geom.ref_cfg.cpu().numpy(), cfg.a)

    out_dir, resumed = _start(conf, args, device, dtype)
    if resumed is not None:
        state, gen, start_step = resumed
        if not hasattr(state, "X"):
            raise RuntimeError(
                f"checkpoint {args.resume} is a mixture checkpoint — add the "
                f"matching 'species' section to the config to resume it")
    else:
        X, Q = place_bodies(conf.get("placement"), conf["n_bodies"], rng,
                            cfg.wall)
        state = make_state(X, Q, dtype=dtype, device=device)
        gen = torch.Generator(device=device).manual_seed(conf.get("seed", 0))
        start_step = 0

    force_fn = build_forces(conf.get("forces"), default_box=conf.get("box"))

    def run_chunk(s, g):
        return run_bd(geom, cfg, s, chunk, generator=g, force_fn=force_fn,
                      save_every=save_every)

    def frames_of(traj):
        return traj["X"].cpu().numpy(), traj["Q"].cpu().numpy()

    traj_path = os.path.join(out_dir, "trajectory.rblt")
    writer = TrajectoryWriter(
        traj_path, state.X.shape[0],
        dtype=np.float64 if dtype == torch.float64 else np.float32,
        append=bool(args.resume))
    t_start = time.perf_counter()
    _drive(run_chunk, state, gen, start_step, n_steps, chunk, save_every,
           cfg.dt, writer, os.path.join(out_dir, "checkpoint.npz"),
           {"config": conf}, frames_of)
    writer.flush()
    writer.close()
    print(json.dumps({
        "done": True, "total_steps": n_steps,
        "wall_time_s": round(time.perf_counter() - t_start, 2),
        "trajectory": traj_path, "frames": writer.frames}))


if __name__ == "__main__":
    main()
