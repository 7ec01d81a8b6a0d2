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
- a ``"mesh"`` key (``{"shape": [...], "mode": "gather" | "distributed"}``)
  runs one process a device, launched as

      python -m torch.distributed.run --nproc_per_node D \
          -m rigid_body_light_tpu_torch.run config.json

  (NCCL on the card, one rank a GPU; gloo with ``--device cpu``; without
  the launcher, one process).  ``"gather"`` (1-D or 2-D) sends the pair
  sweep through :func:`.parallel.sharded_mobility_apply_fn` with the
  solver on every rank, which then draws the same noise; ``"distributed"``
  (1-D) is :func:`.parallel.make_distributed_run_bd`, each rank drawing
  its own bodies' noise from the seed plus its rank.  Rank 0 alone prints
  and writes the frames and the checkpoint (the other ranks' generator
  states go into its metadata), from gathered body arrays.  A mixture
  runs on the gather mesh with its radii closed in (``"distributed"``
  raises with the JAX package's text); the gather mode with a 3-D box or
  a ``farfield_grid`` raises, its sweep being the all-pairs
  minimum-image RPY;
- the configuration, the chunking, the periodic box's geometry and the
  mesh are all checked before the trajectory writer opens (and, without
  ``--resume``, truncates) ``trajectory.rblt``.
"""

from __future__ import annotations

import argparse
import atexit
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


def _world_size() -> int:
    """The processes of the run: the initialised group's, else the
    launcher's ``WORLD_SIZE``, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _init_group(device):
    """Join the launcher's process group (``torch.distributed.run`` sets
    its address), or make a group of this one process; NCCL for the card,
    gloo for the CPU.  Returns whether it made the group (False: the
    caller had initialised one)."""
    import socket

    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
        return True
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    return True


def _build_mesh_mob(conf, cfg, device, radii=None):
    """The config's ``"mesh"`` → (mesh, mob_apply, mode), or (None, None,
    None) without one — the JAX driver's checks and texts, the devices
    being the run's processes.  ``"gather"``: the sharded pair sweep as
    the operator (radii: a mixture's global per-blob radii, closed in);
    ``"distributed"``: mob_apply None (the caller builds
    :func:`.parallel.make_distributed_run_bd`), 1-D only.

    The gather sweep is the all-pairs minimum-image RPY, so the gather
    mode refuses a 3-D box (the Ewald operator) and a ``farfield_grid``
    (the far field), where the JAX driver would run that sweep in their
    place."""
    spec = conf.get("mesh")
    if not spec:
        return None, None, None
    n_avail = _world_size()
    shape = list(spec.get("shape", [n_avail]))
    mode = spec.get("mode", "gather")
    if mode not in ("gather", "distributed"):
        raise ValueError(f"mesh mode must be 'gather' or 'distributed', "
                         f"got {mode!r}")
    if mode == "gather" and (cfg.farfield_grid is not None or (
            cfg.box is not None and len(cfg.box) == 3)):
        what = ("a 3-D box (the Ewald operator)"
                if cfg.farfield_grid is None else
                "a farfield_grid (the far field)")
        raise ValueError(
            f"mesh mode 'gather' sweeps the all-pairs minimum-image RPY "
            f"(parallel.sharded_mobility_apply_fn), not the operator of "
            f"{what}: set \"mode\": \"distributed\" to run that operator "
            f"over the mesh")
    n_req = int(np.prod(shape))
    if n_req > n_avail:
        raise ValueError(
            f"mesh shape {shape} needs {n_req} devices but only {n_avail} "
            f"are visible (launch one process a device: python -m "
            f"torch.distributed.run --nproc_per_node {n_req} -m "
            f"rigid_body_light_tpu_torch.run CONFIG)")
    if mode == "distributed" and len(shape) != 1:
        raise ValueError(
            f"mesh mode 'distributed' needs a 1-D shape, got {shape}")
    if len(shape) not in (1, 2):
        raise ValueError(f"mesh shape must be 1-D or 2-D, got {shape}")
    if _init_group(device):
        import torch.distributed as dist

        atexit.register(dist.destroy_process_group)
    from rigid_body_light_tpu_torch import parallel

    if len(shape) == 1:
        mesh = parallel.make_mesh(shape[0])
    else:
        mesh = parallel.make_mesh_2d(tuple(shape))
    if mode == "distributed":
        return mesh, None, mode
    return mesh, parallel.sharded_mobility_apply_fn(cfg, mesh,
                                                    radii=radii), mode


def _mesh_line(mesh, mode):
    return json.dumps({"mesh": dict(zip(map(str, mesh.mesh_dim_names),
                                        map(int, mesh.shape))),
                       "mode": mode})


def _device(args, conf):
    """The run's device; under a launcher with a mesh on the card, this
    rank's GPU (``LOCAL_RANK``)."""
    from rigid_body_light_tpu_torch.state import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda" and conf.get("mesh"):
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    return device


def _start(conf, args, device, dtype, rank_seeds=False):
    """(output directory, the resumed (state, generator, step) or None).
    A checkpoint without random state resumes from ``"seed"``.
    rank_seeds: each rank of a distributed run has its own generator,
    seeded from ``"seed"`` plus its rank; rank r > 0 resumes from the
    state rank 0 stored for it in the checkpoint's metadata."""
    from rigid_body_light_tpu_torch.utils.checkpoint import (
        load_checkpoint, restore_generator)

    out_dir = conf.get("output_dir", "out")
    os.makedirs(out_dir, exist_ok=True)
    if not args.resume:
        return out_dir, None
    state, rng, step, meta = load_checkpoint(args.resume, dtype=dtype,
                                             device=device)
    rank = _rank() if rank_seeds else 0
    if rank_seeds:
        states = meta.get("rank_generator_states")
        if states is None or len(states) != _world_size():
            raise RuntimeError(
                f"checkpoint {args.resume} was not written by a "
                f"distributed run of {_world_size()} ranks")
        rng = np.asarray(states[rank], np.uint8)
    gen = restore_generator(rng, device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(
            conf.get("seed", 0) + rank)
    if _rank() == 0:
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
           dt, writer, ckpt_path, meta, frames_of, rank_seeds=False,
           meshed=False):
    """The chunk loop: frames appended and flushed before the checkpoint
    that references them (a crash leaves no checkpoint ahead of the
    trajectory), one JSON line a chunk.  ``writer`` None: a rank other
    than 0, which writes and prints nothing.  rank_seeds: every rank's
    generator state goes into the checkpoint's metadata.  meshed: the
    ranks wait for rank 0's checkpoint at the end of every chunk."""
    import torch.distributed as dist

    from rigid_body_light_tpu_torch.utils.checkpoint import save_checkpoint

    step = start_step
    while step < start_step + n_steps:
        t0 = time.perf_counter()
        state, traj = run_chunk(state, gen)
        Xs, Qs = frames_of(traj)   # host copies: the chunk's work is done
        dt_chunk = time.perf_counter() - t0
        step += chunk
        if rank_seeds:
            states = [None] * dist.get_world_size()
            dist.all_gather_object(states,
                                   gen.get_state().numpy().tolist())
            meta = dict(meta, rank_generator_states=states)
        if writer is not None:
            for i in range(Xs.shape[0]):
                frame_step = step - chunk + (i + 1) * save_every
                writer.append(frame_step, frame_step * dt, Xs[i], Qs[i])
            writer.flush()
            save_checkpoint(ckpt_path, state, gen, step=step, metadata=meta)
            print(_chunk_line(step, chunk, dt_chunk, traj), flush=True)
        if meshed:
            dist.barrier()
    return state


def main_multi(conf, args):
    """A ``"species"`` mixture through ``multi.run_bd_multi``; frames hold
    the concatenated bodies in species order (the sizes in the checkpoint's
    metadata and the ``done`` line).  A ``"mesh"`` runs it on the gather
    mesh (every rank the whole mixture, the pair sweep sharded, its radii
    closed in; rank 0 writes); the distributed mode is single-species."""
    from rigid_body_light_tpu_torch import load_structure, multi
    from rigid_body_light_tpu_torch.runtime import TrajectoryWriter
    from rigid_body_light_tpu_torch.state import BodyState, make_state
    from rigid_body_light_tpu_torch.utils.validation import check_box_geometry

    device = _device(args, conf)
    dtype = torch.float64 if conf.get("dtype") == "float64" else torch.float32
    rng = np.random.default_rng(conf.get("seed", 0))
    species = conf["species"]
    if (conf.get("mesh") or {}).get("mode") == "distributed":
        raise ValueError(
            "mesh mode 'distributed' is single-species only — mixtures "
            "run on the gather modes (omit 'mode' or set it to "
            "'gather')")

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
    radii = None
    if mgeom.is_poly():
        radii = torch.cat([
            torch.full((sp["n_bodies"] * g.n_blobs,), a_s, dtype=dtype,
                       device=device)
            for sp, g, a_s in zip(species, mgeom.geoms,
                                  mgeom.species_a(cfg))])
    # the mesh is checked before anything is written (as the single-species
    # driver's)
    mesh, mob_apply, mesh_mode = _build_mesh_mob(conf, cfg, device, radii)

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

    if mesh is not None and _rank() == 0:
        print(_mesh_line(mesh, mesh_mode), flush=True)

    def run_chunk(ss, g):
        return multi.run_bd_multi(mgeom, cfg, ss, chunk, generator=g,
                                  force_fn=force_fn, save_every=save_every,
                                  mob_apply=mob_apply)

    def frames_of(traj):
        return (np.concatenate([x.cpu().numpy() for x in traj["X"]], axis=1),
                np.concatenate([q.cpu().numpy() for q in traj["Q"]], axis=1))

    traj_path = os.path.join(out_dir, "trajectory.rblt")
    writer = None
    if _rank() == 0:
        writer = TrajectoryWriter(
            traj_path, sum(sizes),
            dtype=np.float64 if dtype == torch.float64 else np.float32,
            append=bool(args.resume))
    t_start = time.perf_counter()
    _drive(run_chunk, states, gen, start_step, n_steps, chunk, save_every,
           cfg.dt, writer, os.path.join(out_dir, "checkpoint.npz"),
           {"config": conf, "species_sizes": list(sizes)}, frames_of,
           meshed=mesh is not None)
    if writer is None:
        return
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

    if "species" in conf:
        return main_multi(conf, args)

    from rigid_body_light_tpu_torch import load_structure
    from rigid_body_light_tpu_torch.dynamics import run_bd
    from rigid_body_light_tpu_torch.ops import kinematics as kin
    from rigid_body_light_tpu_torch.runtime import TrajectoryWriter
    from rigid_body_light_tpu_torch.state import make_state
    from rigid_body_light_tpu_torch.utils.validation import check_box_geometry

    device = _device(args, conf)
    distributed = (conf.get("mesh") or {}).get("mode") == "distributed"
    params, blobs = load_structure(conf["structure"])
    a = conf.get("a") or params["sep"] / 2
    dtype = torch.float64 if conf.get("dtype") == "float64" else torch.float32
    cfg = _build_cfg(conf, a, dtype)
    geom = kin.make_ref_geometry(blobs, dtype=dtype, device=device)
    rng = np.random.default_rng(conf.get("seed", 0))
    n_steps, save_every, chunk = _chunking(conf)
    if cfg.box is not None:
        check_box_geometry(cfg.box, geom.ref_cfg.cpu().numpy(), cfg.a)

    # the mesh is checked before anything is written: the output
    # directory, or the writer, which without --resume truncates
    # trajectory.rblt
    mesh, mob_apply, mesh_mode = _build_mesh_mob(conf, cfg, device)
    out_dir, resumed = _start(conf, args, device, dtype,
                              rank_seeds=distributed)
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
        gen = None
        start_step = 0

    force_fn = build_forces(conf.get("forces"), default_box=conf.get("box"))

    B = state.X.shape[0]
    if mesh_mode == "distributed" and B % mesh.size() != 0:
        raise ValueError(
            f"mesh mode 'distributed' needs n_bodies divisible by the mesh "
            f"size: B={B}, D={mesh.size()}")
    rank = _rank()
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(
            conf.get("seed", 0) + (rank if distributed else 0))
    if mesh is not None and rank == 0:
        print(_mesh_line(mesh, mesh_mode), flush=True)

    if distributed:
        from rigid_body_light_tpu_torch import parallel

        run = parallel.make_distributed_run_bd(
            geom, cfg, mesh, chunk, force_fn=force_fn, save_every=save_every)

        def run_chunk(s, g):
            return run(s, generator=g)
    else:
        def run_chunk(s, g):
            return run_bd(geom, cfg, s, chunk, generator=g,
                          force_fn=force_fn, save_every=save_every,
                          mob_apply=mob_apply)

    def frames_of(traj):
        return traj["X"].cpu().numpy(), traj["Q"].cpu().numpy()

    traj_path = os.path.join(out_dir, "trajectory.rblt")
    writer = None
    if rank == 0:
        writer = TrajectoryWriter(
            traj_path, B,
            dtype=np.float64 if dtype == torch.float64 else np.float32,
            append=bool(args.resume))
    t_start = time.perf_counter()
    _drive(run_chunk, state, gen, start_step, n_steps, chunk, save_every,
           cfg.dt, writer, os.path.join(out_dir, "checkpoint.npz"),
           {"config": conf}, frames_of, rank_seeds=distributed,
           meshed=mesh is not None)
    if writer is None:
        return
    writer.flush()
    writer.close()
    print(json.dumps({
        "done": True, "total_steps": n_steps,
        "wall_time_s": round(time.perf_counter() - t_start, 2),
        "trajectory": traj_path, "frames": writer.frames}))


if __name__ == "__main__":
    main()
