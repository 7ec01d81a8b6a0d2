"""The rank side of the port's distributed CPU tests: gloo ranks started
with ``torch.multiprocessing`` (spawn), joined through a ``FileStore`` in
the test's ``tmp_path`` (no fixed port), each running one task of this
module on numpy inputs and writing its results back as numpy.

This module imports ``torch`` and the port only, never JAX: the test
files compute the JAX package's references in the pytest process, while
the ranks work (:func:`launch` returns at once, :func:`collect` joins).
"""

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def launch(task: str, world: int, tmp_path, payload):
    """Start ``world`` ranks running ``task`` (a function of this module:
    (rank, world, payload) → dict) on ``payload``; returns a handle for
    :func:`collect`."""
    path = str(tmp_path)
    with open(os.path.join(path, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.start_processes(_main, args=(world, path, task), nprocs=world,
                             join=False, start_method="spawn")
    return ctx, path, world


def collect(handle):
    """Wait for the ranks (a failed rank raises here and stops the others)
    and return their results, in rank order."""
    ctx, path, world = handle
    while not ctx.join(timeout=TIMEOUT_S):
        pass
    out = []
    for r in range(world):
        with open(os.path.join(path, f"result{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _main(rank, world, path, task):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(path, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        with open(os.path.join(path, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        res = globals()[task](rank, world, payload)
        with open(os.path.join(path, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.detach().cpu().numpy()


def _shard(x, rank, world):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _raises(fn, exc):
    """The message of the ``exc`` that ``fn()`` raises (None if it does not
    raise; another exception propagates)."""
    try:
        fn()
    except exc as e:
        return str(e)
    return None


# ----------------------------------------------------------------- sweeps
def sharding_task(rank, world, p):
    """The gather sweeps (1-D over the 4 ranks, SUMMA on 2 × 2) and the
    sharded mobility product on global inputs, and the ring on this rank's
    rows: float64 through the plain sweep, and float32 through K2's slab
    entry (whose CPU version is the plain sweep with global ids)."""
    from rigid_body_light_tpu_torch import SimulationConfig, parallel

    mesh = parallel.make_mesh(world)
    mesh2 = parallel.make_mesh_2d((2, 2))
    group = parallel.mesh_group(mesh)
    out = {}
    for key, c in p["gather"].items():
        r, F = _t(c["r"]), _t(c["F"])
        kw = dict(a=c["a"], wall=c["wall"])
        out[("1d",) + key] = _np(parallel.sharded_pair_sum(r, F, mesh, **kw))
        out[("2d",) + key] = _np(parallel.sharded_pair_sum_2d(r, F, mesh2,
                                                              **kw))
        cfg = SimulationConfig(a=c["a"], eta=1.3, wall=c["wall"],
                               dtype=torch.float64)
        for name, m in (("mob1d", mesh), ("mob2d", mesh2)):
            out[(name,) + key] = _np(
                parallel.sharded_mobility_apply_fn(cfg, m)(F, r))
    for key, c in p["ring"].items():
        r_l = _shard(_t(c["r"]), rank, world)
        F = _t(c["F"])
        F_l = (_shard(F, rank, world) if F.dim() == 2 else
               torch.stack([_shard(f, rank, world) for f in F]))
        radii = c.get("radii")
        kw = dict(a=c["a"], wall=c["wall"], box=c.get("box"),
                  image_shells=c.get("image_shells", 0),
                  radii_l=None if radii is None
                  else _shard(_t(radii), rank, world))
        out[("ring",) + key] = _np(parallel.ring_pair_sum_local(
            r_l, F_l, group, **kw))
        f32 = dict(kw, radii_l=None if radii is None
                   else kw["radii_l"].float())
        out[("ring32",) + key] = _np(parallel.ring_pair_sum_local(
            r_l.float(), F_l.float(), group, use_pallas=True, **f32))
    return out


# --------------------------------------------------------------- stepper
def _system(p):
    from rigid_body_light_tpu_torch import interop

    geom = interop.geometry_from_numpy(p["ref"], dtype=torch.float64,
                                       device="cpu")
    state = interop.state_from_numpy(p["X"], p["Q"], dtype=torch.float64,
                                     device="cpu")
    return geom, state


def _cfg(d):
    from rigid_body_light_tpu_torch import interop

    return interop.config_from_dict(d)


def _draws(d):
    return tuple(None if w is None else _t(w) for w in d)


def distributed_task(rank, world, p):
    """The distributed steps on 4 ranks: deterministic (dense and far
    field), stochastic from this rank's JAX draws (dense and far field), a
    3-step run_bd, the body count that must divide and the item-16
    refusals."""
    from rigid_body_light_tpu_torch import forces, multi, parallel

    mesh = parallel.make_mesh(world)
    group = parallel.mesh_group(mesh)
    geom, state = _system(p)
    F = _t(p["force"])
    out = {}
    for name in ("det", "det_far"):
        step = parallel.make_distributed_step(geom, _cfg(p[name]), mesh,
                                              deterministic=True)
        s, aux = step(state, F)
        out[name] = dict(X=_np(s.X), Q=_np(s.Q), U=_np(aux.U),
                         iters=aux.iters)
    for name in ("stoch", "stoch_far"):
        step = parallel.make_distributed_step(geom, _cfg(p[name]), mesh)
        s, aux = step(state, F, draws=_draws(p["draws"][rank]))
        out[name] = dict(X=_np(s.X), Q=_np(s.Q), iters=aux.iters,
                         noise_err=float(aux.noise_err))
    force_fn = forces.sum_forces(
        forces.gravity(np.array([0, 0, -1.0, 0, 0, 0])),
        forces.wall_repulsion(strength=2.0, debye_length=0.5, radius=1.0))
    run = parallel.make_distributed_run_bd(geom, _cfg(p["stoch"]), mesh,
                                           p["n_run"], force_fn=force_fn)
    steps = p["run_draws"][rank]
    final, traj = run(state, draws_fn=lambda i: _draws(steps[i]))
    out["run"] = dict(X=_np(final.X), Q=_np(final.Q), tX=_np(traj["X"]),
                      iters=_np(traj["iters"]))
    bad = state._replace(X=state.X[:6], Q=state.Q[:6])
    out["divide"] = _raises(lambda: step(bad, F[:6]), ValueError)
    from rigid_body_light_tpu_torch.dynamics import stochastic_step
    out["no_mob"] = _raises(lambda: stochastic_step(
        geom, _cfg(p["stoch"]), state, F, draws=_draws(p["draws"][rank]),
        group=group), ValueError)
    for name in ("ras", "box3", "film_far"):
        out[name] = _raises(lambda: parallel.make_distributed_step(
            geom, _cfg(p[name]), mesh), NotImplementedError)
    mg = multi.MultiGeometry.create([p["ref"]], dtype=torch.float64,
                                    device="cpu")
    out["mixture"] = _raises(lambda: multi.stochastic_step_multi(
        mg, _cfg(p["stoch"]), (state,), (F,), group=group),
        NotImplementedError)
    return out


# ------------------------------------------------------------ far field
def farfield_task(rank, world, p):
    """The far field's local apply on 4 ranks: mono and poly with the wall,
    with the ctx of prepare_local and with a pinned geometry tier, the
    band tier; each rank's rows."""
    from rigid_body_light_tpu_torch.ops import farfield

    group = dist.group.WORLD
    out = {}
    for name, c in p.items():
        r_l = _shard(_t(c["r"]), rank, world)
        F_l = _shard(_t(c["F"]), rank, world)
        radii = c.get("radii")
        kw = dict(c["kw"], radii_l=None if radii is None
                  else _shard(_t(radii), rank, world))
        out[name] = _np(farfield.mobility_apply_local(F_l, r_l, group, **kw))
        ctx = farfield.prepare_local(r_l, group, **kw)
        out[name + "_ctx"] = _np(farfield.mobility_apply_local(
            F_l, r_l, group, ctx=ctx, **kw))
        geo = farfield.prepare_geometry_local(r_l, group, **kw)
        ctx_g = farfield.prepare_local(r_l, group, geo=geo, **kw)
        out[name + "_pinned"] = _np(farfield.mobility_apply_local(
            F_l, r_l, group, ctx=ctx_g, **kw))
        out[name + "_boundary"] = int(ctx.n_boundary)
        out[name + "_pairs"] = int(ctx.n_pairs)
    return out


# ------------------------------------------------------------ run driver
def run_mesh_task(rank, world, p):
    """The run driver on this process group: each argv of ``p["runs"]`` in
    turn, then the error texts of the configs of ``p["bad"]``."""
    from rigid_body_light_tpu_torch import run

    for argv in p["runs"]:
        run.main(argv)
    return {name: _raises(lambda: run.main([path, "--device", "cpu"]),
                          ValueError)
            for name, path in p["bad"].items()}
