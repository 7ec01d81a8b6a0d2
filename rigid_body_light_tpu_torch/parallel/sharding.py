"""Distribution of the mobility product and the BD step on
``torch.distributed`` — the port of
``rigid_body_light_tpu/parallel/sharding.py``.

Where the JAX package runs one program over a device mesh under
``shard_map``, the port runs one process a device, each holding its
shard, joined by a process group:

- a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
  process group the caller initialised (:func:`make_mesh`,
  :func:`make_mesh_2d`), NCCL for CUDA tensors, gloo for CPU tensors; its
  size must be the group's;
- where the JAX code takes ``axis_name``, the port takes the
  ``ProcessGroup`` of that mesh dimension as ``group`` (``None``: one
  device), and each collective is one call of
  :mod:`rigid_body_light_tpu_torch.utils.collectives` on it;
- the entry points that the JAX package gives global arrays
  (:func:`sharded_pair_sum`, :func:`sharded_pair_sum_2d`,
  :func:`sharded_mobility_apply_fn`, :func:`make_distributed_step`,
  :func:`make_distributed_run_bd`, :func:`make_distributed_step_multi`,
  :func:`make_distributed_run_bd_multi`) take the global arrays on every
  rank and return them gathered; the local views
  (:func:`ring_pair_sum_local`, :func:`ring_mobility_apply_fn`,
  :func:`farfield_mobility_apply_local_fn`,
  :func:`ewald_mobility_apply_local_fn`) take and return this rank's
  shard.

Inside the distributed stepper every O(N) array (positions, λ, the GMRES
and Lanczos bases) stays on its rank; the ranks meet in the ring's
transfers (or the far field's and the tile sweep's gathers, or the RAS
preconditioner's halo gathers) and in the all-reduced scalars of the
Krylov recurrences.  Nothing here falls back to another backend or to the
single-device path.  Ensembles of such runs are
:mod:`rigid_body_light_tpu_torch.parallel.ensemble`.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from rigid_body_light_tpu_torch.config import SimulationConfig
from rigid_body_light_tpu_torch.dynamics import stepper as stepper_mod
from rigid_body_light_tpu_torch.ops import ewald, rpy, rpy_cuda, saddle
from rigid_body_light_tpu_torch.state import BodyState
from rigid_body_light_tpu_torch.utils import collectives

AXIS = "blobs"


def _device_type():
    """The mesh's device type: CUDA under NCCL, the CPU under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    return dist.get_world_size()


def _check_size(n_req: int):
    world = _world()
    if n_req != world:
        raise ValueError(f"a mesh of {n_req} devices over a process group "
                         f"of {world}: the sizes must be equal")


def make_mesh(n_devices: int = None, axis_name: str = AXIS) -> DeviceMesh:
    """1-D mesh over the initialised process group (``n_devices`` must be
    its size; None takes it)."""
    n = _world() if n_devices is None else int(n_devices)
    _check_size(n)
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis_name,))


def make_mesh_2d(shape, axis_names=("rows", "cols")) -> DeviceMesh:
    """2-D mesh, e.g. (2, 2) over 4 processes, for the SUMMA sweep."""
    shape = tuple(int(s) for s in shape)
    _check_size(shape[0] * shape[1])
    return init_device_mesh(_device_type(), shape,
                            mesh_dim_names=tuple(axis_names))


def mesh_group(mesh: DeviceMesh, axis_name: str = None):
    """The process group of one mesh dimension (the first by default)."""
    return mesh.get_group(axis_name or mesh.mesh_dim_names[0])


def _pad_rows(x, n_pad):
    if n_pad == x.shape[-2]:
        return x
    shape = list(x.shape)
    shape[-2] = n_pad - x.shape[-2]
    return torch.cat([x, x.new_zeros(shape)], dim=-2)


def _slab(r_rows, row0, r_cols, col0, F_cols, a, wall, row_tile, h_floor,
          box, image_shells, use_kernel, radii_rows=None, radii_cols=None,
          image_tail=True):
    """Pair terms of a rows × columns slab at global offsets: K2's slab on
    float32 with ``use_kernel`` (:func:`.rpy_cuda.pair_sum_slab`), else
    the plain sweep with global ids (``rpy.pair_sum``), as the JAX
    package's ``use_pallas`` branch."""
    if h_floor is None:
        h_floor = rpy.WALL_H_FLOOR
    if use_kernel and r_rows.dtype == torch.float32:
        inv_a = 1.0 / a
        boa = None if box is None else tuple(b * inv_a for b in box)
        return rpy_cuda.pair_sum_slab(
            r_rows * inv_a, row0, r_cols * inv_a, F_cols, wall,
            col_offset=col0, h_floor=h_floor, box_over_a=boa,
            ahat_rows=None if radii_rows is None else radii_rows * inv_a,
            ahat_cols=None if radii_cols is None else radii_cols * inv_a,
            image_shells=image_shells, image_tail=image_tail
        ).to(r_rows.dtype)
    dev = r_rows.device
    row_ids = row0 + torch.arange(r_rows.shape[0], device=dev)
    col_ids = col0 + torch.arange(r_cols.shape[0], device=dev)
    return rpy.pair_sum(r_rows, row_ids, r_cols, col_ids, F_cols, a=a,
                        wall=wall, row_tile=row_tile, h_floor=h_floor,
                        box=box, image_shells=image_shells,
                        image_tail=image_tail, radii_rows=radii_rows,
                        radii_cols=radii_cols)


def _pad_radii(radii, n_pad, a):
    """Per-blob radii padded to ``n_pad`` with ``a`` (the padded blobs
    carry F = 0; a zero radius would divide by zero in their fields)."""
    if radii is None or radii.shape[0] == n_pad:
        return radii
    return torch.cat([radii, radii.new_full((n_pad - radii.shape[0],), a)])


def sharded_pair_sum(r, F, mesh: DeviceMesh, a=1.0, wall=False,
                     row_tile=512, axis_name=AXIS, use_pallas=False,
                     h_floor=None, box=None, image_shells=0, radii=None):
    """Row-sharded Σ_j M_ij F_j (pair terms only) over a 1-D mesh.

    r (N, 3) and F (N, 3) or (k, N, 3): the global arrays, the same on
    every rank; radii: (N,) global per-blob radii or None.  N is padded to
    a multiple of the mesh size (padded columns carry F = 0, padded rows
    are dropped); each rank sweeps its row block against all the columns
    (K2's slab with ``use_pallas`` in float32, its POLY form with radii,
    else the plain sweep) and the blocks are gathered: every rank returns
    the global result."""
    group = mesh_group(mesh, axis_name)
    d, idx = collectives.size(group), collectives.rank(group)
    n = r.shape[0]
    n_pad = -(-n // d) * d
    n_loc = n_pad // d
    r_p, F_p = _pad_rows(r, n_pad), _pad_rows(F, n_pad)
    a_p = _pad_radii(radii, n_pad, a)
    rows = slice(idx * n_loc, (idx + 1) * n_loc)
    part = _slab(r_p[rows], idx * n_loc, r_p, 0, F_p, a, wall, row_tile,
                 h_floor, box, image_shells, use_pallas,
                 radii_rows=None if a_p is None else a_p[rows],
                 radii_cols=a_p)
    U = collectives.all_gather(part, group, dim=part.dim() - 2)
    return U[..., :n, :]


def sharded_pair_sum_2d(r, F, mesh: DeviceMesh, a=1.0, wall=False,
                        row_tile=512, axis_names=("rows", "cols"),
                        use_pallas=False, h_floor=None, box=None,
                        image_shells=0, radii=None):
    """2-D (SUMMA) Σ_j M_ij F_j over a (Dr, Dc) mesh: the rank at (i, j)
    sweeps row block i against column block j (K2's slab at both global
    offsets, or the plain sweep), the row sums close with one all-reduce
    over the column group, and the row blocks are gathered over the row
    group.  Global arrays in and out (radii too), as
    :func:`sharded_pair_sum`."""
    ax_r, ax_c = axis_names
    g_r, g_c = mesh.get_group(ax_r), mesh.get_group(ax_c)
    dr, dc = collectives.size(g_r), collectives.size(g_c)
    i, j = collectives.rank(g_r), collectives.rank(g_c)
    n = r.shape[0]
    lcm = dr * dc // math.gcd(dr, dc)
    n_pad = -(-n // lcm) * lcm
    n_r, n_c = n_pad // dr, n_pad // dc
    r_p, F_p = _pad_rows(r, n_pad), _pad_rows(F, n_pad)
    a_p = _pad_radii(radii, n_pad, a)
    rows = slice(i * n_r, (i + 1) * n_r)
    cols = slice(j * n_c, (j + 1) * n_c)
    part = _slab(r_p[rows], i * n_r, r_p[cols], j * n_c,
                 F_p[..., cols, :], a, wall, row_tile, h_floor, box,
                 image_shells, use_pallas,
                 radii_rows=None if a_p is None else a_p[rows],
                 radii_cols=None if a_p is None else a_p[cols])
    part = collectives.psum(part, g_c)
    U = collectives.all_gather(part, g_r, dim=part.dim() - 2)
    return U[..., :n, :]


def sharded_mobility_apply_fn(cfg: SimulationConfig, mesh: DeviceMesh,
                              axis_name: str = AXIS, radii=None) -> Callable:
    """A drop-in ``mob_apply(F, r) → U`` (global arrays, as
    :func:`.saddle.mobility_apply_fn`'s) whose pair sweep is sharded over
    ``mesh``: 1-D row blocks, or SUMMA on a 2-D mesh.  The damping, the
    self term and the scale are elementwise and stay on every rank.

    It is the all-pairs RPY sweep (open, wall, or the 2-D box's minimum
    image and image shells), never the Ewald operator of a 3-D box nor the
    far field (the run driver's gather mode refuses those).  radii: (N,)
    global per-blob radii closed in (a mixture: K2's POLY slab, the
    radius-aware damping and self term), as
    :func:`ring_mobility_apply_fn` takes its shard's."""
    two_d = mesh.ndim == 2

    def apply(F, r):
        r = r.reshape(-1, 3)
        F = F if F.dim() == 3 else F.reshape(-1, 3)
        Fd = F
        if cfg.wall:
            b = rpy.damping_factors(r, cfg.a, radii)
            Fd = F * b[:, None]
        kw = dict(a=cfg.a, wall=cfg.wall, row_tile=cfg.matvec_row_tile,
                  use_pallas=cfg.use_pallas, h_floor=cfg.wall_h_floor,
                  box=cfg.box, image_shells=cfg.image_shells, radii=radii)
        if two_d:
            U = sharded_pair_sum_2d(r, Fd, mesh,
                                    axis_names=mesh.mesh_dim_names, **kw)
        else:
            U = sharded_pair_sum(r, Fd, mesh, axis_name=axis_name, **kw)
        U = U + rpy._self_diag(r, cfg.a, cfg.wall, cfg.wall_h_floor,
                               radii) * Fd
        U = U * (1.0 / (8.0 * math.pi * cfg.eta * cfg.a))
        if cfg.wall:
            U = U * b[:, None]
        return U

    return apply


def ring_pair_sum_local(r_l, F_l, group, a=1.0, wall=False, row_tile=512,
                        h_floor=None, box=None, use_pallas=False,
                        radii_l=None, image_shells=0, image_tail=True):
    """Ring-pipelined Σ_j M_ij F_j for this rank's rows (local view).

    Each rank holds its (N_l, 3) shard and one block in flight: over D
    steps the (positions, forces, radii) blocks rotate around the ring, the
    next block's send and receive posted before the current slab's sweep,
    so the transfer overlaps it.  Step s sweeps the block from rank
    (idx − s) mod D, and the steps are summed in order, as the JAX
    package's.  r_l (N_l, 3); F_l (N_l, 3) or (k, N_l, 3), k ≤ 2 through
    the kernel; radii_l (N_l,) or None, rotating with the positions.  Each
    slab is K2's slab form with ``use_pallas`` in float32 (the plain sweep
    otherwise) at the global offsets of its rows and its block, so with a
    2-D ``box`` and ``image_shells`` every global ordered pair, a blob with
    itself included, adds its image sum at exactly one step.  Returns the
    pair terms in F_l's layout."""
    d, idx = collectives.size(group), collectives.rank(group)
    n_l = r_l.shape[0]
    acc = torch.zeros_like(F_l)
    blk = [r_l, F_l] + ([radii_l] if radii_l is not None else [])
    for s in range(d):
        wait = None
        if s < d - 1:
            nxt, wait = collectives.ring_shift(blk, group)
        src = (idx - s) % d
        acc = acc + _slab(r_l, idx * n_l, blk[0], src * n_l, blk[1], a, wall,
                          row_tile, h_floor, box, image_shells, use_pallas,
                          radii_rows=radii_l,
                          radii_cols=blk[2] if radii_l is not None else None,
                          image_tail=image_tail)
        if wait is not None:
            wait()
            blk = nxt
    return acc


def ring_mobility_apply_fn(cfg: SimulationConfig, group,
                           radii=None) -> Callable:
    """Local-view ``mob_apply(F_l, r_l) → U_l`` whose pair sweep rides the
    ring (:func:`ring_pair_sum_local`); the damping, the self term and the
    scale are per-blob.  Takes (N_l, 3) or (k, N_l, 3) forces (the fused
    two-draw noise).  radii: this rank's per-blob radii or None."""

    def apply(F, r):
        r = r.reshape(-1, 3)
        F = F if F.dim() == 3 else F.reshape(-1, 3)
        Fd = F
        if cfg.wall:
            b = rpy.damping_factors(r, cfg.a, radii)
            Fd = F * b[:, None]
        U = ring_pair_sum_local(
            r, Fd, group, a=cfg.a, wall=cfg.wall,
            row_tile=cfg.matvec_row_tile, h_floor=cfg.wall_h_floor,
            box=cfg.box, use_pallas=cfg.use_pallas, radii_l=radii,
            image_shells=cfg.image_shells)
        U = U + rpy._self_diag(r, cfg.a, cfg.wall, cfg.wall_h_floor,
                               radii) * Fd
        U = U * (1.0 / (8.0 * math.pi * cfg.eta * cfg.a))
        if cfg.wall:
            U = U * b[:, None]
        return U

    return apply


def farfield_mobility_apply_local_fn(cfg: SimulationConfig, group,
                                     radii=None) -> Callable:
    """Local-view proxy-grid ``mob_apply(F_l, r_l, ctx=None) → U_l``
    (``cfg.farfield_grid`` set, the band tier with it; with a 2-D ``box``
    the film's far field): the single-device
    :func:`.saddle._farfield_apply_fn` over ``group``, this rank's rows of
    :func:`.farfield.mobility_apply`, with the ``prepare`` /
    ``prepare_geometry`` attributes that :func:`.saddle.hoist_positions`
    and :func:`.saddle.pin_geometry` use, so a step builds the lattices
    once and each Krylov or Lanczos loop its position setup once.  radii:
    this rank's per-blob radii or None."""
    return saddle._farfield_apply_fn(cfg, radii, group=group)


def ewald_mobility_apply_local_fn(cfg: SimulationConfig, group,
                                  radii=None) -> Callable:
    """Local-view triply periodic ``mob_apply(F_l, r_l) → U_l`` (a 3-D
    ``cfg.box``) over ``group``: :func:`.ewald.mobility_apply_local` with
    the single-device operator's parameters — the classic split's ring of
    slabs (float32 with ``use_pallas``: K4 on the diagonal block, its slab
    form on the others), or with ``ewald_rc`` this rank's slice of the
    tile sweep (float32 with ``use_pallas``: K4 tiles on the slice); the
    wave part's moments summed over the group.

    radii: this rank's per-blob radii (needs ``ewald_rc``, as in the JAX
    package).  float32 evaluates species-pair fits built from the
    all-gathered global radii, right for any species pattern (the JAX
    package tiles the local radii over the mesh, right only where every
    rank holds the same pattern: ROADMAP.md queue 3, fault 3).

    ``ewald_grid_p`` raises: the gridded wave part is single-device (the
    JAX package's ``config.py:63``), and its distributed operator would
    run the dense wave part in its place."""
    if cfg.ewald_grid_p:
        raise ValueError(
            f"ewald_grid_p={cfg.ewald_grid_p} with a process group: the "
            f"gridded wave part is single-device, and the distributed Ewald "
            f"operator sums the dense wave part's moments over the group — "
            f"set ewald_grid_p=0 to run it distributed")
    key = saddle._ewald_params_key(cfg)
    params = saddle._ewald_params(*key)
    pt = None
    if (radii is not None and params.rc is not None
            and cfg.dtype == torch.float32):
        pt = saddle._poly_tables(key, saddle._radii_key(
            collectives.all_gather(radii, group)))
    use_kernel = (cfg.use_pallas and cfg.dtype == torch.float32
                  and (radii is None or params.rc is not None))
    max_nbr = cfg.ewald_nbr_tiles if cfg.ewald_nbr_tiles > 0 else None

    def apply(F, r):
        return ewald.mobility_apply_local(
            F, r, params, group, row_tile=cfg.matvec_row_tile,
            max_nbr=max_nbr, radii_l=radii, poly_tables=pt,
            use_kernel=use_kernel)

    return apply


def _local_mobility_fn(cfg: SimulationConfig, group, radii=None) -> Callable:
    """The distributed steppers' operator, routed as the single-device
    ``saddle.mobility_apply_fn``: the Ewald operator for a 3-D box, the far
    field when ``farfield_grid`` is set (the film's with a 2-D box), else
    the ring (open, wall, or the 2-D box with its image sum).  radii: this
    rank's per-blob radii (a mixture) or None."""
    if cfg.box is not None and len(cfg.box) == 3:
        return ewald_mobility_apply_local_fn(cfg, group, radii=radii)
    if cfg.farfield_grid is not None:
        return farfield_mobility_apply_local_fn(cfg, group, radii=radii)
    return ring_mobility_apply_fn(cfg, group, radii=radii)


def _shard(x, idx, d):
    """Rank ``idx``'s equal block of x along its first axis."""
    n = x.shape[0] // d
    return x[idx * n:(idx + 1) * n]


def _check_bodies(B, d, what):
    if B % d != 0:
        raise ValueError(f"distributed {what} needs n_bodies divisible by "
                         f"the mesh size: B={B}, D={d}")


def make_distributed_step(geom, cfg: SimulationConfig, mesh: DeviceMesh,
                          axis_name: str = None, deterministic: bool = False):
    """The fully distributed BD step over a 1-D mesh: bodies sharded, every
    O(N) object (positions, forces, λ, the GMRES and Lanczos bases) on its
    rank, the ranks coupled by the ring (or the far field's and the tile
    sweep's slices, or the RAS preconditioner's halo gathers) and the
    all-reduced Krylov scalars.  Needs B % D == 0 (whole bodies a rank:
    kinematics, the preconditioner's blocks and the commits stay local).

    Returns ``step(state, force, draws=None, generator=None) → (state',
    StepAux)``: the global state and force on every rank in, this rank's
    B/D bodies stepped, the global new state and StepAux (U and λ
    gathered) out.  draws: this rank's (W1, W2, W_rfd) in the local
    shapes of :mod:`.stepper`, else drawn from ``generator`` (where the
    JAX step folds its key with the device index, each rank draws its own
    bodies' noise).  ``deterministic`` runs the kBT = 0 step."""
    group = mesh_group(mesh, axis_name)
    d, idx = collectives.size(group), collectives.rank(group)
    mob_local = _local_mobility_fn(cfg, group)

    def step(state, force, draws=None, generator=None):
        B = state.X.shape[0]
        _check_bodies(B, d, "step")
        s_l = BodyState(X=_shard(state.X, idx, d), Q=_shard(state.Q, idx, d))
        f_l = _shard(force, idx, d)
        if deterministic:
            s2, aux = stepper_mod.deterministic_step(
                geom, cfg, s_l, f_l, mob_apply=mob_local, group=group)
        else:
            s2, aux = stepper_mod.stochastic_step(
                geom, cfg, s_l, f_l, mob_apply=mob_local, mob_multi=mob_local,
                draws=draws, generator=generator, group=group)
        gather = lambda x: collectives.all_gather(x, group)  # noqa: E731
        return BodyState(X=gather(s2.X), Q=gather(s2.Q)), stepper_mod.StepAux(
            U=gather(aux.U), lam=gather(aux.lam), residual=aux.residual,
            iters=aux.iters, noise_err=aux.noise_err)

    return step


def make_distributed_run_bd(geom, cfg: SimulationConfig, mesh: DeviceMesh,
                            n_steps: int, force_fn=None, slip_fn=None,
                            save_every: int = 1, axis_name: str = None):
    """A whole distributed trajectory (:func:`.stepper.run_bd` on every
    rank's bodies, the operator and the reductions as
    :func:`make_distributed_step`'s).

    force_fn / slip_fn see this rank's bodies: (local BodyState, step) →
    (B/D, 6) / (N/D, 3); pair forces between bodies of different ranks
    need a gather of the body centres inside force_fn.  Returns
    ``run(state, generator=None, draws_fn=None) → (final state, trajectory)``
    with the global state in and out and the trajectory's X and Q gathered
    (steps, B, ·); draws_fn: step → this rank's draws."""
    return _run_local(geom, cfg, mesh_group(mesh, axis_name), n_steps,
                      force_fn, slip_fn, save_every)


def _run_local(geom, cfg: SimulationConfig, group, n_steps, force_fn,
               slip_fn, save_every):
    """``run(state, generator, draws_fn)`` of :func:`make_distributed_run_bd`
    over ``group`` (also one walker of an ensemble)."""
    d, idx = collectives.size(group), collectives.rank(group)
    mob_local = _local_mobility_fn(cfg, group)

    def run(state, generator=None, draws_fn=None):
        _check_bodies(state.X.shape[0], d, "run")
        s_l = BodyState(X=_shard(state.X, idx, d), Q=_shard(state.Q, idx, d))
        final, traj = stepper_mod.run_bd(
            geom, cfg, s_l, n_steps, generator=generator, force_fn=force_fn,
            slip_fn=slip_fn, mob_apply=mob_local, save_every=save_every,
            mob_multi=mob_local, draws_fn=draws_fn, group=group)
        final = BodyState(X=collectives.all_gather(final.X, group),
                          Q=collectives.all_gather(final.Q, group))
        traj = dict(traj, X=collectives.all_gather(traj["X"], group, dim=1),
                    Q=collectives.all_gather(traj["Q"], group, dim=1))
        return final, traj

    return run


# --------------------------------------------------------------- mixtures
def _local_radii_multi(mgeom, cfg: SimulationConfig, sizes_l, dtype, device):
    """This rank's per-blob radii of a mixture, species-major (None if
    monodisperse)."""
    if not mgeom.is_poly():
        return None
    return torch.cat([
        torch.full((b * g.n_blobs,), a_s, dtype=dtype, device=device)
        for g, b, a_s in zip(mgeom.geoms, sizes_l, mgeom.species_a(cfg))])


def _check_species(states, d, what):
    for s in states:
        if s.X.shape[0] % d != 0:
            raise ValueError(
                f"distributed mixture {what} needs every species' body "
                f"count divisible by the mesh size: B={s.X.shape[0]}, D={d}")


def _local_species(states, idx, d):
    return tuple(BodyState(X=_shard(s.X, idx, d), Q=_shard(s.Q, idx, d))
                 for s in states)


def _mixture_operator(mgeom, cfg: SimulationConfig, group, states_l):
    """The local operator of a mixture with this rank's radii closed in
    (the polydisperse ring, the sliced far field or the distributed
    Ewald)."""
    x = states_l[0].X
    radii = _local_radii_multi(mgeom, cfg,
                               tuple(s.X.shape[0] for s in states_l),
                               x.dtype, x.device)
    return _local_mobility_fn(cfg, group, radii=radii)


def make_distributed_step_multi(mgeom, cfg: SimulationConfig,
                                mesh: DeviceMesh, axis_name: str = None):
    """The fully distributed mixture step: every species' bodies sharded
    over a 1-D mesh (each B_s divisible by its size), the concatenated
    blob space coupled by the local operator (the polydisperse ring, the
    sliced far field or the distributed Ewald, which needs ``ewald_rc``
    with radii), the Krylov and Lanczos recurrences all-reduced — the
    mixture form of :func:`make_distributed_step`.  ``pc_mode="ras"``
    keeps the static per-species PC (:mod:`..multi`).

    Returns ``step(states, forces, draws=None, generator=None) →
    (states', MultiSolveResult)``: the global per-species states and
    forces on every rank in, gathered out (λ in the ranks' order, each
    rank's blobs species-major, as the JAX package's).  draws: this rank's
    (W1, W2, W_rfd) in its own species-major layout, else drawn from
    ``generator``."""
    from rigid_body_light_tpu_torch import multi as multi_mod

    group = mesh_group(mesh, axis_name)
    d, idx = collectives.size(group), collectives.rank(group)

    def step(states, forces, draws=None, generator=None):
        _check_species(states, d, "step")
        states_l = _local_species(states, idx, d)
        mob = _mixture_operator(mgeom, cfg, group, states_l)
        ss, res = multi_mod.stochastic_step_multi(
            mgeom, cfg, states_l, tuple(_shard(f, idx, d) for f in forces),
            mob_apply=mob, mob_multi=mob, draws=draws, generator=generator,
            group=group)
        gather = lambda x: collectives.all_gather(x, group)  # noqa: E731
        return (tuple(BodyState(X=gather(s.X), Q=gather(s.Q)) for s in ss),
                res._replace(lam=gather(res.lam),
                             Us=tuple(gather(U) for U in res.Us)))

    return step


def make_distributed_run_bd_multi(mgeom, cfg: SimulationConfig,
                                  mesh: DeviceMesh, n_steps: int,
                                  force_fn=None, slip_fn=None,
                                  save_every: int = 1, axis_name: str = None):
    """A whole distributed mixture trajectory (:func:`.multi.run_bd_multi`
    on every rank's bodies, the operator as
    :func:`make_distributed_step_multi`'s).  force_fn / slip_fn see this
    rank's species shards.  Returns ``run(states, generator=None,
    draws_fn=None) → (final states, trajectory)``, the trajectory's
    per-species X and Q gathered (steps, B_s, ·)."""
    from rigid_body_light_tpu_torch import multi as multi_mod

    group = mesh_group(mesh, axis_name)
    d, idx = collectives.size(group), collectives.rank(group)

    def run(states, generator=None, draws_fn=None):
        _check_species(states, d, "run")
        states_l = _local_species(states, idx, d)
        mob = _mixture_operator(mgeom, cfg, group, states_l)
        final, traj = multi_mod.run_bd_multi(
            mgeom, cfg, states_l, n_steps, generator=generator,
            force_fn=force_fn, slip_fn=slip_fn, mob_apply=mob,
            save_every=save_every, mob_multi=mob, draws_fn=draws_fn,
            group=group)
        final = tuple(BodyState(X=collectives.all_gather(s.X, group),
                                Q=collectives.all_gather(s.Q, group))
                      for s in final)
        traj = dict(traj, X=tuple(collectives.all_gather(x, group, dim=1)
                                  for x in traj["X"]),
                    Q=tuple(collectives.all_gather(q, group, dim=1)
                            for q in traj["Q"]))
        return final, traj

    return run
