"""Ensembles of distributed BD runs: walkers over one mesh dimension,
bodies over the other — the port of
``rigid_body_light_tpu/parallel/ensemble.py`` on ``torch.distributed``.

Hydrodynamic coupling is global (every Krylov iteration touches every
blob), so one suspension spread over hosts would put the ring's transfers
and the Krylov reductions on the slow inter-host links in the innermost
loop.  The decomposition keeps those on the fast links inside a host:

- the ``"chips"`` dimension (within a host): one suspension's bodies,
  sharded as :func:`.sharding.make_distributed_run_bd` shards them (the
  ring, or the far field's or the tile sweep's slices, and the
  all-reduced Krylov and Lanczos scalars);
- the ``"dcn"`` dimension (across hosts): independent walkers, separate
  noise realizations of the same or of per-walker initial states, which
  exchange nothing while they step; the results are gathered once at the
  end.

Where the JAX package vmaps a rank's walkers, a rank here runs them one
after another.
"""

from __future__ import annotations

import os

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from rigid_body_light_tpu_torch.config import SimulationConfig
from rigid_body_light_tpu_torch.parallel.sharding import (_device_type,
                                                          _run_local,
                                                          _world)
from rigid_body_light_tpu_torch.state import BodyState
from rigid_body_light_tpu_torch.utils import collectives

ENSEMBLE_AXES = ("dcn", "chips")


def make_hybrid_mesh(dcn: int = None, ici: int = None,
                     axis_names=ENSEMBLE_AXES) -> DeviceMesh:
    """A 2-D (hosts × ranks a host) mesh over the initialised process
    group, ``dcn`` outermost, so the ranks of one ``"chips"`` group are
    consecutive (one host's under ``torch.distributed.run``).  ``ici``
    defaults to ``LOCAL_WORLD_SIZE`` (set by ``torch.distributed.run``,
    else the whole group) and ``dcn`` to world / ici."""
    n = _world()
    if ici is None:
        if dcn is None:
            ici = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        elif n % dcn:
            raise ValueError(f"{n} devices do not split over dcn={dcn}")
        else:
            ici = n // dcn
    if dcn is None:
        dcn = n // ici
    if dcn * ici != n:
        raise ValueError(f"dcn*ici = {dcn}*{ici} != {n} devices")
    return init_device_mesh(_device_type(), (dcn, ici),
                            mesh_dim_names=tuple(axis_names))


def make_ensemble_run_bd(geom, cfg: SimulationConfig, mesh: DeviceMesh,
                         n_steps: int, force_fn=None, slip_fn=None,
                         save_every: int = 1):
    """An ensemble of independent distributed BD trajectories.

    Returns ``run(states, generators=None, draws_fn=None) →
    (final_states, traj)``: ``states`` a batched :class:`BodyState`, X
    (W, B, 3) and Q (W, B, 4), the same on every rank.  Walkers are split
    over the mesh's first dimension and each rank runs its walkers one
    after another; a walker's bodies are split over the second, each
    walker exactly as :func:`.sharding.make_distributed_run_bd` runs it.
    generators: W ``torch.Generator``s of this rank (walker w's draws for
    this rank's bodies, so ranks of one walker must differ, as the JAX
    package folds a walker's key with the device index); draws_fn:
    (walker, step) → this rank's draws of that walker.  The results are
    gathered on every rank: final X (W, B, 3), trajectories X (W, T, B,
    3), "residual" (W, T) and so on.

    W must divide by the first dimension's size and B by the second's
    (the JAX package's texts); force_fn / slip_fn see one walker's local
    bodies, as in the distributed run.
    """
    wa, ba = mesh.mesh_dim_names
    g_w, g_b = mesh.get_group(wa), mesh.get_group(ba)
    n_w, i_w = collectives.size(g_w), collectives.rank(g_w)
    n_b = collectives.size(g_b)
    run_one = _run_local(geom, cfg, g_b, n_steps, force_fn, slip_fn,
                         save_every)

    def run(states: BodyState, generators=None, draws_fn=None):
        W, B = states.X.shape[0], states.X.shape[1]
        if W % n_w:
            raise ValueError(
                f"ensemble run needs n_walkers divisible by the DCN mesh "
                f"extent: W={W}, dcn={n_w}")
        if B % n_b:
            raise ValueError(
                f"ensemble run needs n_bodies divisible by the ICI mesh "
                f"extent: B={B}, chips={n_b}")
        w_l = W // n_w
        finals, trajs = [], []
        for w in range(i_w * w_l, (i_w + 1) * w_l):
            final, traj = run_one(
                BodyState(X=states.X[w], Q=states.Q[w]),
                generator=None if generators is None else generators[w],
                draws_fn=(None if draws_fn is None else
                          lambda i, w=w: draws_fn(w, i)))
            finals.append(final)
            trajs.append(traj)
        dev = states.X.device

        def gather(xs):   # the walkers' results, stacked, over the group
            return collectives.all_gather(torch.stack(xs).to(dev), g_w)
        final = BodyState(X=gather([f.X for f in finals]),
                          Q=gather([f.Q for f in finals]))
        traj = {k: gather([t[k] for t in trajs]) for k in trajs[0]}
        return final, traj

    return run
