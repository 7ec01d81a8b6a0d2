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
def _system(p, dtype=torch.float64):
    from rigid_body_light_tpu_torch import interop

    geom = interop.geometry_from_numpy(p["ref"], dtype=dtype, device="cpu")
    state = interop.state_from_numpy(p["X"], p["Q"], dtype=dtype,
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
    3-step run_bd, the body count that must divide, and the paths that
    once refused (RAS, a 3-D box, the film's far field, the mixture) each
    taking a deterministic step."""
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
        out[name] = _runs(lambda: parallel.make_distributed_step(
            geom, _cfg(p[name]), mesh, deterministic=True)(state, F)[0].X)
    mg = multi.MultiGeometry.create([p["ref"]], dtype=torch.float64,
                                    device="cpu")
    out["mixture"] = _runs(lambda: parallel.make_distributed_step_multi(
        mg, _cfg(p["det"]), mesh)((state,), (F,))[0][0].X)
    return out


def _runs(fn):
    """(the message of a NotImplementedError that ``fn()`` raises, or None;
    whether the X it returned is finite)."""
    try:
        X = fn()
    except NotImplementedError as e:
        return str(e), False
    return None, bool(torch.isfinite(X).all())


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


# ------------------------------------------------------- the Ewald locals
def ewald_task(rank, world, p):
    """The distributed Ewald operator on 4 ranks: the classic ring
    (float64 plain, float32 through K4's wrappers, whose CPU versions are
    the plain blocks), the balanced split's tile slice (float64 mono and
    poly), the operator of the config routing (float32 poly, its tables
    from the gathered radii), the refusals (radii on the ring, ewald_grid_p), and the
    deterministic steps in a periodic box, classic and balanced."""
    from rigid_body_light_tpu_torch import parallel
    from rigid_body_light_tpu_torch.ops import ewald

    group = dist.group.WORLD
    out = {}
    for name, c in p["ops"].items():
        params = ewald.make_params(c["box"], c["a"], c["eta"], tol=c["tol"],
                                   rc=c.get("rc"))
        r_l = _shard(_t(c["r"]), rank, world)
        F = _t(c["F"])
        F_l = (_shard(F, rank, world) if F.dim() == 2 else
               torch.stack([_shard(f, rank, world) for f in F]))
        radii = c.get("radii")
        rad_l = None if radii is None else _shard(_t(radii), rank, world)
        out[name] = _np(ewald.mobility_apply_local(F_l, r_l, params, group,
                                                   radii_l=rad_l))
        if c.get("f32") and radii is None:
            out[name + "_f32"] = _np(ewald.mobility_apply_local(
                F_l.float(), r_l.float(), params, group, use_kernel=True))
    c = p["ops"]["ring"]
    params = ewald.make_params(c["box"], c["a"], c["eta"], tol=c["tol"])
    out["ring_radii"] = _raises(lambda: ewald.mobility_apply_local(
        _shard(_t(c["F"]), rank, world), _shard(_t(c["r"]), rank, world),
        params, group, radii_l=torch.ones(c["F"].shape[0] // world,
                                          dtype=torch.float64)),
        NotImplementedError)
    # the config routing: float32 poly tables built from the gathered radii
    cfg = _cfg(p["cfg_poly"])
    c = p["ops"]["cells_poly"]
    r_l = _shard(_t(c["r"]), rank, world).float()
    rad_l = _shard(_t(c["radii"]), rank, world).float()
    mob = parallel.ewald_mobility_apply_local_fn(cfg, group, radii=rad_l)
    out["fn_poly_f32"] = _np(mob(_shard(_t(c["F"][0]), rank, world).float(),
                                 r_l))
    out["grid_p"] = _raises(lambda: parallel.ewald_mobility_apply_local_fn(
        _cfg(p["cfg_grid"]), group), ValueError)
    geom, state = _system(p)
    mesh = parallel.make_mesh(world)
    F = _t(p["force"])
    for name in ("step_classic", "step_rc"):
        s, aux = parallel.make_distributed_step(
            geom, _cfg(p[name]), mesh, deterministic=True)(state, F)
        out[name] = dict(X=_np(s.X), Q=_np(s.Q), U=_np(aux.U),
                         iters=aux.iters)
    return out


# ------------------------------------------------------- distributed RAS
def ras_task(rank, world, p):
    """Distributed RAS on 4 ranks: the preconditioner's build (halo ids,
    the replicated coupled Ñ), a solve in float64 and float32, block_free's
    iterations beside it, and the deterministic and stochastic steps."""
    from rigid_body_light_tpu_torch import parallel
    from rigid_body_light_tpu_torch.ops import saddle, solvers
    from rigid_body_light_tpu_torch.state import BodyState

    group = dist.group.WORLD
    mesh = parallel.make_mesh(world)
    out = {}
    for dt, key in (("float64", "cfg64"), ("float32", "cfg32")):
        dtype = getattr(torch, dt)
        cfg = _cfg(dict(p[key], dtype=dt))
        geom, state = _system(p, dtype)
        s_l = BodyState(X=_shard(state.X, rank, world),
                        Q=_shard(state.Q, rank, world))
        ops_l = saddle.geometry_ops(geom, s_l)
        slip_l = _shard(_t(p["slip"]).reshape(state.X.shape[0], -1, 3),
                        rank, world).reshape(-1, 3).to(dtype)
        force_l = _shard(_t(p["solve_force"]), rank, world).to(dtype)
        mob = parallel.ring_mobility_apply_fn(cfg, group)
        res = solvers.solve_saddle(ops_l, cfg, slip_l, force_l,
                                   mob_apply=mob, group=group)
        bf = solvers.solve_saddle(ops_l, cfg.replace(pc_mode="block_free"),
                                  slip_l, force_l, mob_apply=mob,
                                  group=group)
        out[dt] = dict(U=_np(res.U), lam=_np(res.lam), iters=res.iters,
                       iters_block_free=bf.iters)
        if dt == "float64":
            pc = saddle.build_pc_ras(ops_l, cfg, group=group)
            out["halo_idx"] = _np(pc.halo_idx)
            out["n_full"] = _np(pc.n_full)
    geom, state = _system(p)
    F = _t(p["force"])
    cfg = _cfg(p["cfg"])
    s, aux = parallel.make_distributed_step(geom, cfg, mesh,
                                            deterministic=True)(state, F)
    out["det"] = dict(X=_np(s.X), Q=_np(s.Q), iters=aux.iters)
    s, aux = parallel.make_distributed_step(geom, _cfg(p["cfg_st"]), mesh)(
        state, F, draws=_draws(p["draws"][rank]))
    out["stoch"] = dict(X=_np(s.X), Q=_np(s.Q), iters=aux.iters)
    return out


# ------------------------------------------------- the distributed mixture
def _mixture(p, dtype=torch.float64):
    from rigid_body_light_tpu_torch import multi
    from rigid_body_light_tpu_torch.state import make_state

    mg = multi.MultiGeometry.create(p["refs"], dtype=dtype,
                                    radii=p["radii"], device="cpu")
    states = tuple(make_state(x, q, dtype=dtype, device="cpu")
                   for x, q in zip(p["Xs"], p["Qs"]))
    return mg, states, tuple(_t(f).to(dtype) for f in p["forces"])


def multi_task(rank, world, p):
    """The gather mesh's operator (mono and with a mixture's radii) and
    the distributed mixture on 4 ranks: deterministic steps through the
    polydisperse ring, the sliced far field and the distributed Ewald, a
    stochastic step from this rank's JAX draws, a 3-step run, and a group
    without its operator."""
    from rigid_body_light_tpu_torch import multi, parallel

    mesh = parallel.make_mesh(world)
    out = {}
    for name, c in p["gather"].items():
        cfg = _cfg(p["cfg"])
        radii = None if c["radii"] is None else _t(c["radii"])
        out[name] = _np(parallel.sharded_mobility_apply_fn(
            cfg, mesh, radii=radii)(_t(c["F"]), _t(c["r"])))
    mg, states, forces = _mixture(p)
    for name in ("ring", "far", "ewald"):
        m_, s_, f_ = (_mixture(p["ewald_mixture"]) if name == "ewald" else
                      (mg, states, forces))
        step = parallel.make_distributed_step_multi(m_, _cfg(p[name]), mesh)
        ss, res = step(s_, f_)
        out[name] = dict(X=[_np(s.X) for s in ss], Q=[_np(s.Q) for s in ss],
                         iters=res.iters)
    step = parallel.make_distributed_step_multi(mg, _cfg(p["stoch"]), mesh)
    ss, res = step(states, forces, draws=_draws(p["draws"][rank]))
    out["stoch"] = dict(X=[_np(s.X) for s in ss], iters=res.iters)

    def force_fn(ss_, i):
        return tuple(torch.zeros((s.X.shape[0], 6), dtype=torch.float64)
                     .index_fill_(1, torch.tensor([2]), v)
                     for s, v in zip(ss_, (-1.0, -2.0)))

    run = parallel.make_distributed_run_bd_multi(mg, _cfg(p["ring"]), mesh,
                                                 p["n_run"],
                                                 force_fn=force_fn)
    final, traj = run(states)
    out["run"] = dict(X=[_np(s.X) for s in final],
                      residual=_np(traj["residual"]),
                      tX=[_np(x) for x in traj["X"]])
    out["no_mob"] = _raises(lambda: multi.stochastic_step_multi(
        mg, _cfg(p["ring"]), states, forces,
        group=parallel.mesh_group(mesh)), ValueError)
    return out


# ------------------------------------------------------ the film's far field
def film_task(rank, world, p):
    """The film's far field over 4 ranks: the operator mono and with radii
    (float64; float32 through K3's box slice, whose CPU version is the
    plain slice), with a prepared ctx and a pinned geometry; the
    deterministic and stochastic film far-field steps."""
    from rigid_body_light_tpu_torch import parallel
    from rigid_body_light_tpu_torch.ops import farfield

    group = dist.group.WORLD
    out = {}
    for name, c in p["ops"].items():
        r_l = _shard(_t(c["r"]), rank, world)
        F_l = _shard(_t(c["F"]), rank, world)
        radii = c.get("radii")
        kw = dict(p["kw"], radii=None if radii is None
                  else _shard(_t(radii), rank, world))
        out[name] = _np(farfield.mobility_apply(F_l, r_l, group=group, **kw))
        ctx = farfield.prepare(r_l, group=group, **kw)
        out[name + "_ctx"] = _np(farfield.mobility_apply(
            F_l, r_l, ctx=ctx, group=group, **kw))
        geo = farfield.prepare_geometry(r_l, group=group, **kw)
        ctx_g = farfield.prepare(r_l, geo=geo, group=group, **kw)
        out[name + "_pinned"] = _np(farfield.mobility_apply(
            F_l, r_l, ctx=ctx_g, group=group, **kw))
        kw32 = dict(kw, radii=None if kw["radii"] is None
                    else kw["radii"].float())
        out[name + "_f32"] = _np(farfield.mobility_apply(
            F_l.float(), r_l.float(), group=group, use_pallas=True, **kw32))
    geom, state = _system(p)
    mesh = parallel.make_mesh(world)
    F = _t(p["force"])
    s, aux = parallel.make_distributed_step(
        geom, _cfg(p["cfg"]), mesh, deterministic=True)(state, F)
    out["det"] = dict(X=_np(s.X), Q=_np(s.Q), iters=aux.iters)
    s, aux = parallel.make_distributed_step(geom, _cfg(p["cfg_st"]), mesh)(
        state, F, draws=_draws(p["draws"][rank]))
    out["stoch"] = dict(X=_np(s.X), Q=_np(s.Q), iters=aux.iters)
    return out


# ----------------------------------------------------------------- ensemble
def ensemble_task(rank, world, p):
    """The ensemble runner on a (2, 2) hybrid mesh: its dimensions, the
    deterministic and the stochastic ensembles (each rank fed the JAX
    ensemble's draws of its walker and its bodies), and the refusals."""
    from rigid_body_light_tpu_torch import forces, parallel
    from rigid_body_light_tpu_torch.state import BodyState

    mesh = parallel.make_hybrid_mesh(dcn=2)
    out = {"dims": (mesh.mesh_dim_names, tuple(mesh.shape)),
           "dcn3": _raises(lambda: parallel.make_hybrid_mesh(dcn=3),
                           ValueError)}
    geom, _ = _system(dict(p, X=p["X"][0], Q=p["Q"][0]))
    states = BodyState(X=_t(p["X"]), Q=_t(p["Q"]))
    force_fn = forces.sum_forces(
        forces.gravity(np.array([0, 0, -1.0, 0, 0, 0])),
        forces.wall_repulsion(strength=2.0, debye_length=0.5, radius=1.0))
    chips = mesh.get_group("chips")
    c_rank = dist.get_rank(chips)
    for name in ("det", "stoch"):
        run = parallel.make_ensemble_run_bd(geom, _cfg(p[name]), mesh,
                                            p["n_steps"], force_fn=force_fn)
        draws = p["draws"] if name == "stoch" else None
        fin, traj = run(states, draws_fn=None if draws is None else
                        lambda w, i: _draws(draws[w][i][c_rank]))
        out[name] = dict(X=_np(fin.X), Q=_np(fin.Q), tX=_np(traj["X"]),
                         iters=_np(traj["iters"]))
    run = parallel.make_ensemble_run_bd(geom, _cfg(p["det"]), mesh, 1)
    out["walkers"] = _raises(lambda: run(BodyState(X=states.X[:1],
                                                   Q=states.Q[:1])),
                             ValueError)
    out["bodies"] = _raises(lambda: run(BodyState(X=states.X[:, :3],
                                                  Q=states.Q[:, :3])),
                            ValueError)
    return out
