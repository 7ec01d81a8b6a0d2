"""Multi-species suspensions: mixtures of rigid body types — the port of
``rigid_body_light_tpu/multi.py`` (one device).

A species is a (RefGeometry, body batch) pair.  Hydrodynamics couples every
blob of every species through one mobility product over the concatenated
(N_total, 3) blob array; the kinematic projections, the preconditioner
blocks and the quaternion updates stay batched within each species.  A
species may have its own blob radius (``MultiGeometry.radii``): the coupled
product is then the polydisperse one (per-blob radii closed over the
apply-fns: K1/K2's POLY forms on the card, or with ``farfield_grid`` the
radius-split far field and K3's POLY form), and the species' PC and
noise factors are built at its radius.

    mgeom   = MultiGeometry.create([ref_a, ref_b], radii=[None, 0.065])
    states  = (make_state(Xa, Qa), make_state(Xb, Qb))
    res     = solve_saddle_multi(mgeom, cfg, states, slip, forces)
    states', res = stochastic_step_multi(mgeom, cfg, states, forces,
                                         draws=(W1, W2, W_rfd))

As in the single-species stepper, the Gaussian draws are inputs, or they
come from an explicit ``torch.Generator`` (:func:`make_draws_multi`):
W1 and W2 (3·N_total,) — in the species-major body-frame layout of
:func:`m_half_w_precond_multi` with ``lanczos_precond``, else in the blob
layout of ``lanczos.m_half_w`` — W2 None where the step takes one draw
(``split_rand`` off, or ``em_exact``); W_rfd (N_total, 3) for the
midpoint scheme, (B_total, 6) species-major for ``em_exact``'s
:func:`n_rfd_exact_multi`.

Distributed mode (``group``, a ``torch.distributed`` process group; the
JAX package's ``axis_name``): the states, forces, slip and draws are this
rank's bodies of every species (each rank's draws in its own
species-major layout), ``mob_apply`` is the local operator of
:mod:`rigid_body_light_tpu_torch.parallel` with this rank's radii closed
in (``parallel.make_distributed_step_multi`` builds it), and every Krylov
and Lanczos reduction is all-reduced over the group.  ``pc_mode="ras"``
keeps the static per-species preconditioner there, as the JAX package
does: the mixture's coupled Ñ is single-device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from rigid_body_light_tpu_torch.config import SimulationConfig
from rigid_body_light_tpu_torch.dynamics.stepper import _commit, uses_split
from rigid_body_light_tpu_torch.ops import gmres as gmres_mod
from rigid_body_light_tpu_torch.ops import kinematics as kin
from rigid_body_light_tpu_torch.ops import lanczos
from rigid_body_light_tpu_torch.ops import rfd
from rigid_body_light_tpu_torch.ops import rpy
from rigid_body_light_tpu_torch.ops import saddle as saddle_mod
from rigid_body_light_tpu_torch.state import BodyState
from rigid_body_light_tpu_torch.utils import profiling
from rigid_body_light_tpu_torch.utils.validation import check_box_geometry


class MultiGeometry(NamedTuple):
    """Static geometry of an S-species mixture.

    radii: per-species blob radius, None entries falling back to ``cfg.a``
    (a species with its own radius makes the coupled sweep polydisperse).
    """

    geoms: Tuple[kin.RefGeometry, ...]
    radii: Tuple = None

    @classmethod
    def create(cls, ref_cfgs: Sequence, dtype=torch.float32, radii=None,
               device="cuda") -> "MultiGeometry":
        geoms = tuple(kin.make_ref_geometry(c, dtype=dtype, device=device)
                      for c in ref_cfgs)
        if radii is None:
            radii = (None,) * len(geoms)
        else:
            if len(radii) != len(geoms):
                raise ValueError(
                    f"radii has {len(radii)} entries for {len(geoms)} species")
            radii = tuple(None if r is None else float(r) for r in radii)
        return cls(geoms=geoms, radii=radii)

    def species_a(self, cfg: SimulationConfig) -> Tuple[float, ...]:
        radii = self.radii if self.radii is not None else (None,) * len(self.geoms)
        return tuple(cfg.a if r is None else r for r in radii)

    def is_poly(self) -> bool:
        radii = self.radii if self.radii is not None else ()
        return any(r is not None for r in radii)


def _blob_counts(opses) -> Tuple[int, ...]:
    return tuple(o.offsets.shape[0] * o.offsets.shape[1] for o in opses)


def blob_radii_multi(mgeom: MultiGeometry, opses, cfg: SimulationConfig):
    """Concatenated (N_total,) per-blob radii, or None when monodisperse."""
    if not mgeom.is_poly():
        return None
    pos = opses[0].positions
    return torch.cat([
        torch.full((c,), a_s, dtype=pos.dtype, device=pos.device)
        for c, a_s in zip(_blob_counts(opses), mgeom.species_a(cfg))])


def _mob_fns(mgeom: MultiGeometry, opses, cfg: SimulationConfig):
    """(mob_apply, mob_apply_multi) with the mixture's blob radii closed in."""
    radii = blob_radii_multi(mgeom, opses, cfg)
    return (saddle_mod.mobility_apply_fn(cfg, radii=radii),
            saddle_mod.mobility_apply_multi_fn(cfg, radii=radii))


def geometry_ops_multi(mgeom: MultiGeometry, states: Sequence[BodyState]):
    return tuple(saddle_mod.geometry_ops(g, s)
                 for g, s in zip(mgeom.geoms, states))


def concat_positions(opses) -> torch.Tensor:
    return torch.cat([o.flat_positions for o in opses], dim=0)


def split_blobs(x, opses):
    """Split a concatenated (N_total, 3) blob array back per species."""
    return tuple(torch.split(x, list(_blob_counts(opses)), dim=0))


def K_dot_multi(Us, opses) -> torch.Tensor:
    """Concatenated K·U over species: (B_s, 6) each → (N_total, 3)."""
    return torch.cat([kin.K_dot(U, o.offsets).reshape(-1, 3)
                      for U, o in zip(Us, opses)], dim=0)


def KT_dot_multi(lam, opses):
    """Concatenated blob forces → per-species (B_s, 6)."""
    parts = split_blobs(lam.reshape(-1, 3), opses)
    return tuple(kin.KT_dot(p.reshape(o.offsets.shape), o.offsets)
                 for p, o in zip(parts, opses))


def apply_saddle_multi(lam, Us, opses, mob_apply: Callable):
    """[Mλ − KU; KᵀU] for the mixture; λ (N_total, 3), Us tuple of (B_s, 6);
    mob_apply the mixture's product (:func:`_mob_fns`, radii closed in)."""
    with profiling.span("mobility"):
        u = mob_apply(lam.reshape(-1, 3), concat_positions(opses))
    return u - K_dot_multi(Us, opses), KT_dot_multi(lam, opses)


def build_pc_multi(opses, cfg: SimulationConfig, species_a=None):
    """Per-species PCs; species_a (from ``MultiGeometry.species_a``) builds
    each species' factors at its own blob radius."""
    if species_a is None:
        return tuple(saddle_mod.build_pc(o, cfg) for o in opses)
    return tuple(
        saddle_mod.build_pc(o, cfg if a_s == cfg.a else cfg.replace(a=a_s))
        for o, a_s in zip(opses, species_a))


class RasMultiPC(NamedTuple):
    """The mixture's RAS halo-coupling preconditioner: per species the
    static ``block_free`` core and its bodies' halos, drawn from the blobs
    of every species (the polydisperse coupling blocks), and the coupled
    Ñ over every body of every species.  :func:`apply_pc_multi`
    dispatches on this type."""

    pcs: Tuple                 # per-species static PCData (block_free core)
    halo_idx: Tuple            # per-species (B_s, H_s) global blob ids
    halo_w: Tuple              # per-species (B_s, 3n_s, 3H_s) W = A⁻¹C
    halo_sinv: Tuple           # per-species (B_s, 3H_s, 3H_s) Schur⁻¹
    n_full: Optional[torch.Tensor]  # (6B_tot, 6B_tot) coupled (KᵀM̃⁻¹K)⁻¹


def build_pc_ras_multi(opses, cfg: SimulationConfig, static_pcs,
                       species_a) -> "RasMultiPC":
    """Attach RAS halo coupling across a mixture (``saddle.build_pc_ras``
    with three differences, as the JAX package's ``build_pc_ras_multi``):
    a body's halo candidates span the concatenated blobs of all species;
    the coupling and halo blocks are polydisperse
    (``rpy.cross_mobility_blocks`` with radii); Ñ couples all 6·B_tot body
    coordinates in the species-major order of :func:`_flatten`.  Returns
    ``static_pcs`` for one body in all or ``pc_halo_max`` ≤ 0.  The halos
    do not see a 2-D box, as in the JAX package (ROADMAP.md queue 3)."""
    Bs = [o.offsets.shape[0] for o in opses]
    ns = [o.offsets.shape[1] for o in opses]
    counts = _blob_counts(opses)
    B_tot, N_tot = sum(Bs), sum(counts)
    Hs = [min(cfg.pc_halo_max, N_tot - n) for n in ns]
    if B_tot == 1 or cfg.pc_halo_max <= 0 or min(Hs) <= 0:
        return static_pcs
    pos = concat_positions(opses)                          # (N_tot, 3)
    dtype, dev = pos.dtype, pos.device
    radii_all = torch.cat([torch.full((c,), a_s, dtype=dtype, device=dev)
                           for c, a_s in zip(counts, species_a)])
    boffs = [sum(Bs[:s]) for s in range(len(Bs))]
    coffs = [sum(counts[:s]) for s in range(len(counts))]
    body_of = torch.cat([
        boff + torch.arange(B, device=dev).repeat_interleave(n)
        for boff, B, n in zip(boffs, Bs, ns)])
    wall = cfg.wall
    b_all = rpy.damping_factors(pos, cfg.a, radii_all) if wall else None
    kw = dict(a=cfg.a, eta=cfg.eta, wall=wall, h_floor=cfg.wall_h_floor)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    halo_idx_t, halo_w_t, halo_sinv_t = [], [], []
    for s, o in enumerate(opses):
        B_l, n, H = Bs[s], ns[s], Hs[s]
        # halo selection: the 2H nearest blobs of other bodies by distance
        # to the body's tracking point, then the H of them nearest any of
        # its blobs, cut off at pc_halo·a
        X = o.positions[:, 0, :] - o.offsets[:, 0, :]      # (B_l, 3)
        d_c = torch.linalg.norm(pos[None, :, :] - X[:, None, :], dim=-1)
        own = body_of[None, :] == (boffs[s] + torch.arange(B_l, device=dev)
                                   )[:, None]
        d_c = torch.where(own, torch.full_like(d_c, float("inf")), d_c)
        K2 = min(2 * H, N_tot - n)
        cand = saddle_mod._nearest(d_c, K2)                # (B_l, K2)
        cand_pos = pos[cand.reshape(-1)].reshape(B_l, K2, 3)
        d_exact = torch.amin(torch.linalg.norm(
            o.positions[:, :, None, :] - cand_pos[:, None, :, :], dim=-1),
            dim=1)                                         # (B_l, K2)
        sel = saddle_mod._nearest(d_exact, H)
        halo_idx = torch.gather(cand, 1, sel)              # (B_l, H) global
        mask = torch.gather(d_exact, 1, sel) < cfg.pc_halo * cfg.a
        halo_pos = pos[halo_idx.reshape(-1)].reshape(B_l, H, 3)
        halo_rad = radii_all[halo_idx.reshape(-1)].reshape(B_l, H)
        body_rad = torch.full((B_l, n), species_a[s], dtype=dtype, device=dev)

        # polydisperse coupling C and halo block D; masked slots give zero
        # coupling, so an empty halo reduces to the static PC exactly
        mf = mask.to(dtype)
        Cb = rpy.cross_mobility_blocks(o.positions, halo_pos, radii_i=body_rad,
                                       radii_j=halo_rad, **kw)
        Db = rpy.cross_mobility_blocks(halo_pos, halo_pos, radii_i=halo_rad,
                                       radii_j=halo_rad, **kw)
        if wall:
            b_body = rpy.damping_factors(o.flat_positions, cfg.a,
                                         body_rad.reshape(-1)).reshape(B_l, n)
            b_halo = b_all[halo_idx.reshape(-1)].reshape(B_l, H)
            Cb = Cb * (b_body[:, :, None] * b_halo[:, None, :])[..., None, None]
            Db = Db * (b_halo[:, :, None] * b_halo[:, None, :])[..., None, None]
        Cb = Cb * mf[:, None, :, None, None]
        Db = Db * (mf[:, :, None] * mf[:, None, :])[..., None, None]
        selfb = rpy.self_mobility_blocks(
            halo_pos.reshape(-1, 3), cfg.a, cfg.eta, wall,
            h_floor=cfg.wall_h_floor,
            radii=halo_rad.reshape(-1)).reshape(B_l, H, 3, 3)
        if wall:
            selfb = selfb * (b_halo * b_halo)[:, :, None, None]
        hh = torch.arange(H, device=dev)
        Db[:, hh, hh] = torch.where(mask[:, :, None, None], selfb, eye3)
        C = Cb.permute(0, 1, 3, 2, 4).reshape(B_l, 3 * n, 3 * H)
        D = Db.permute(0, 1, 3, 2, 4).reshape(B_l, 3 * H, 3 * H)

        # Woodbury factors around this species' static core
        W = saddle_mod._ras_core_apply(
            static_pcs[s].minv_ref, o.rot,
            C.reshape(B_l, n, 3, 3 * H).permute(3, 0, 1, 2)
        ).permute(1, 2, 3, 0).reshape(B_l, 3 * n, 3 * H)
        S = D - torch.einsum("bph,bpg->bhg", C, W)
        halo_idx_t.append(halo_idx)
        halo_w_t.append(W)
        halo_sinv_t.append(saddle_mod._ns_inverse(S, saddle_mod._NS_ITERS_S))

    mpc = RasMultiPC(pcs=tuple(static_pcs), halo_idx=tuple(halo_idx_t),
                     halo_w=tuple(halo_w_t), halo_sinv=tuple(halo_sinv_t),
                     n_full=None)

    # the consistent coupled Ñ = (Kᵀ M̃⁻¹ K)⁻¹ over all bodies of all
    # species: one batched RAS apply to the 6·B_tot K columns
    cols = torch.zeros((B_tot, 6, N_tot, 3), dtype=dtype, device=dev)
    for s, o in enumerate(opses):
        B_l, n = Bs[s], ns[s]
        Kb = saddle_mod.body_K_blocks(o.offsets)           # (B_l, n, 3, 6)
        sub = torch.zeros((B_l, 6, B_l, n, 3), dtype=dtype, device=dev)
        idx = torch.arange(B_l, device=dev)
        sub[idx, :, idx] = Kb.permute(0, 3, 1, 2)
        cols[boffs[s]:boffs[s] + B_l, :, coffs[s]:coffs[s] + B_l * n] = \
            sub.reshape(B_l, 6, B_l * n, 3)
    y = _inv_m_ras_multi(mpc, cols.reshape(6 * B_tot, N_tot, 3), opses)
    rows = []
    for s, o in enumerate(opses):
        B_l, n = Bs[s], ns[s]
        y_s = y[:, coffs[s]:coffs[s] + B_l * n, :]
        Kb = saddle_mod.body_K_blocks(o.offsets)
        rows.append(torch.einsum(
            "bnif,cbni->cbf", Kb, y_s.reshape(-1, B_l, n, 3)
        ).reshape(6 * B_tot, 6 * B_l))
    ninv = torch.cat(rows, dim=1).T                        # [p,q]=KₚᵀM̃⁻¹K_q
    return mpc._replace(n_full=saddle_mod._ns_inverse(ninv,
                                                      saddle_mod._NS_ITERS_N))


def _inv_m_ras_multi(mpc: RasMultiPC, v, opses):
    """Mixture M̃⁻¹·v: per-species RAS Woodbury rows, the halo values read
    from the concatenated vector (clusters cross species).
    v (..., N_tot, 3) → (..., N_tot, 3)."""
    parts = []
    start = 0
    for s, o in enumerate(opses):
        c = o.offsets.shape[0] * o.offsets.shape[1]
        parts.append(saddle_mod._ras_apply(
            v[..., start:start + c, :], mpc.pcs[s].minv_ref, o.rot,
            mpc.halo_idx[s], mpc.halo_w[s], mpc.halo_sinv[s], v_full=v))
        start += c
    return torch.cat(parts, dim=-2)


def _apply_pc_ras_multi(mpc: RasMultiPC, slip, Fs, opses,
                        cfg: SimulationConfig):
    """Coupled mixture saddle PC (the algebra of ``saddle.apply_pc``):
    (slip, Fs) → (λ, Us) with the RAS M̃⁻¹ and the coupled Ñ."""
    slip = slip.reshape(-1, 3)
    im = _inv_m_ras_multi(mpc, slip, opses)
    rhs = torch.cat([
        (-F - kin.KT_dot(p.reshape(o.offsets.shape), o.offsets)).reshape(-1)
        for F, p, o in zip(Fs, split_blobs(im, opses), opses)])
    U_all = mpc.n_full @ rhs
    Us = tuple(torch.split(U_all, [6 * o.offsets.shape[0] for o in opses]))
    Us = tuple(U.reshape(-1, 6) for U in Us)
    lam = _inv_m_ras_multi(mpc, slip + K_dot_multi(Us, opses), opses)
    return (cfg.m_scale * lam).reshape(-1, 3), Us


def apply_pc_multi(pcs, slip, Fs, opses, cfg: SimulationConfig):
    if isinstance(pcs, RasMultiPC):
        return _apply_pc_ras_multi(pcs, slip, Fs, opses, cfg)
    lams, Us = [], []
    for pc, p, F, o in zip(pcs, split_blobs(slip.reshape(-1, 3), opses), Fs,
                           opses):
        lam_s, U_s = saddle_mod.apply_pc(pc, p, F, o, cfg)
        lams.append(lam_s.reshape(-1, 3))
        Us.append(U_s)
    return torch.cat(lams, dim=0), tuple(Us)


def make_noise_preconditioner_multi(mgeom: MultiGeometry, a, eta):
    """Per-species body-frame noise factors (L, L⁻¹), each at the species'
    own blob radius (``a`` where it has none)."""
    radii = mgeom.radii if mgeom.radii is not None else (None,) * len(mgeom.geoms)
    return tuple(
        lanczos.make_noise_preconditioner(g.ref_cfg, a if a_s is None else a_s,
                                          eta)
        for g, a_s in zip(mgeom.geoms, radii))


def m_half_w_precond_multi(mob_apply_multi: Callable, opses, npcs, W,
                           iters: int = 10, group=None):
    """Preconditioned M^{1/2}W draws on the mixture's blob space, from the
    Gaussian draws ``W`` (k, 3·N_total) (k = 1 or 2, species-major, each
    species' slice in its bodies' frames).  The per-species factors
    transform each species' slice; the G product couples every blob
    through one k-RHS mobility sweep over the concatenated array, k ≤ 2 as
    the kernels take it.  Returns a tuple of k (N_total, 3) draws.

    G·v = L⁻¹ R̃ᵀ · M · R̃ L⁻ᵀ v per species, noise = R̃ L · G^{1/2} W.
    group: distributed mode (the module docstring)."""
    pos = concat_positions(opses)
    mob_apply_multi = saddle_mod.hoist_positions(mob_apply_multi, pos)
    W = W.to(pos.dtype)
    k = W.shape[0]
    shapes = [(o.offsets.shape[0], o.offsets.shape[1]) for o in opses]

    def to_world(vk):  # (k, 3N) -> (k, N, 3): per species R̃ L^{-T} v
        parts, start = [], 0
        for o, (L, L_inv), (B, n) in zip(opses, npcs, shapes):
            vb = vk[:, start:start + 3 * B * n].reshape(k, B, 3 * n)
            u = torch.einsum("qp,kbq->kbp", L_inv, vb).reshape(k, B, n, 3)
            parts.append(torch.einsum("bij,kbnj->kbni", o.rot, u)
                         .reshape(k, B * n, 3))
            start += 3 * B * n
        return torch.cat(parts, dim=1)

    def from_world(xk):  # (k, N, 3) -> (k, 3N): per species L^{-1} R̃ᵀ x
        parts, start = [], 0
        for o, (L, L_inv), (B, n) in zip(opses, npcs, shapes):
            xb = xk[:, start:start + B * n].reshape(k, B, n, 3)
            u = torch.einsum("bji,kbnj->kbni", o.rot, xb).reshape(k, B, 3 * n)
            parts.append(torch.einsum("pq,kbq->kbp", L_inv, u).reshape(k, -1))
            start += B * n
        return torch.cat(parts, dim=1)

    def mv(vk):  # G v
        x = to_world(vk)
        with profiling.span("mobility"):
            mx = mob_apply_multi(x, pos)
        return from_world(mx)

    g = lanczos.sqrt_matvec_batched(mv, W, iters=iters, group=group)
    out, start = [], 0
    for o, (L, _), (B, n) in zip(opses, npcs, shapes):  # slice = R̃ L g_s
        gb = g[:, start:start + 3 * B * n].reshape(k, B, 3 * n)
        lg = torch.einsum("pq,kbq->kbp", L, gb).reshape(k, B, n, 3)
        out.append(torch.einsum("bij,kbnj->kbni", o.rot, lg)
                   .reshape(k, B * n, 3))
        start += 3 * B * n
    out = torch.cat(out, dim=1)
    return tuple(out[i] for i in range(k))


class MultiSolveResult(NamedTuple):
    lam: torch.Tensor            # (N_total, 3)
    Us: Tuple[torch.Tensor, ...]  # per-species (B_s, 6)
    residual: torch.Tensor
    iters: int = None            # inner GMRES iterations executed


def _flatten(lam, Us):
    return torch.cat([lam.reshape(-1)] + [U.reshape(-1) for U in Us])


def _unflatten(x, opses):
    nb = 3 * sum(_blob_counts(opses))
    sizes = [6 * o.ktkinv.shape[0] for o in opses]
    parts = torch.split(x[nb:], sizes)
    return x[:nb].reshape(-1, 3), tuple(p.reshape(-1, 6) for p in parts)


def solve_saddle_multi(mgeom: MultiGeometry, cfg: SimulationConfig,
                       states: Sequence[BodyState], slip, forces,
                       mob_apply: Callable = None, opses=None, x0=None,
                       pcs=None, group=None) -> MultiSolveResult:
    """Preconditioned GMRES solve of the mixed saddle system.

    slip: (N_total, 3) or None; forces: tuple of (B_s, 6).  x0: optional
    (λ, Us) Krylov warm start; pcs: optional prebuilt per-species PC tuple.
    With ``cfg.pc_mode == "ras"`` the mixture RAS coupling is attached at
    this solve's geometry, on one device; with a ``group`` (distributed
    mode, the module docstring) the static per-species PC stays.
    """
    if opses is None:
        opses = geometry_ops_multi(mgeom, states)
    if mob_apply is None:
        mob_apply = _mob_fns(mgeom, opses, cfg)[0]
    mob_apply = saddle_mod.hoist_positions(mob_apply, concat_positions(opses))
    dtype = opses[0].positions.dtype
    dev = opses[0].positions.device
    n_total = sum(_blob_counts(opses))
    if slip is None:
        slip = torch.zeros((n_total, 3), dtype=dtype, device=dev)
    with profiling.span("pc_build"):
        if pcs is None:
            pcs = build_pc_multi(opses, cfg, species_a=mgeom.species_a(cfg))
        if (cfg.pc_mode == "ras" and group is None
                and not isinstance(pcs, RasMultiPC)):
            pcs = build_pc_ras_multi(opses, cfg, static_pcs=pcs,
                                     species_a=mgeom.species_a(cfg))

    def pc_flat(s, fs):
        with profiling.span("pc_apply"):
            return _flatten(*apply_pc_multi(pcs, s, fs, opses, cfg))

    def matvec(x):
        lam, Us = _unflatten(x, opses)
        return pc_flat(*apply_saddle_multi(lam, Us, opses, mob_apply))

    b = pc_flat(torch.as_tensor(slip, dtype=dtype, device=dev).reshape(-1, 3),
                tuple(torch.as_tensor(f, dtype=dtype, device=dev)
                      for f in forces))
    if x0 is not None:
        x0 = _flatten(x0[0], x0[1])
    max_restarts = max(1, -(-cfg.gmres_maxiter // cfg.gmres_restart))
    with profiling.span("gmres"):
        result = gmres_mod.gmres(matvec, b, x0=x0, tol=cfg.gmres_tol,
                                 restart=cfg.gmres_restart,
                                 max_restarts=max_restarts, group=group)
    lam, Us = _unflatten(result.x, opses)
    return MultiSolveResult(lam=lam, Us=Us, residual=result.residual,
                            iters=result.iters)


def make_draws_multi(mgeom: MultiGeometry, states: Sequence[BodyState],
                     generator: torch.Generator,
                     cfg: SimulationConfig = None):
    """A mixture step's Gaussian draws (W1, W2, W_rfd) from ``generator``,
    on the states' device and in their dtype, in the shapes of ``cfg``'s
    mode (the module docstring; no cfg: the midpoint scheme's)."""
    n_total = sum(g.n_blobs * s.X.shape[0]
                  for g, s in zip(mgeom.geoms, states))
    kw = dict(generator=generator, dtype=states[0].X.dtype,
              device=states[0].X.device)
    if cfg is not None and cfg.drift_mode == "em_exact":
        b_total = sum(s.X.shape[0] for s in states)
        return (torch.randn(3 * n_total, **kw), None,
                torch.randn((b_total, 6), **kw))
    return (torch.randn(3 * n_total, **kw), torch.randn(3 * n_total, **kw),
            torch.randn((n_total, 3), **kw))


def n_rfd_exact_multi(mgeom: MultiGeometry, cfg: SimulationConfig,
                      states: Sequence[BodyState], w,
                      mob_apply: Callable = None, pcs=None, group=None):
    """The mixture's body-space divergence drift ∂·N per species by a
    centered RFD on the solved mixture body mobility (two extra mixture
    saddle solves), as :func:`rigid_body_light_tpu_torch.ops.rfd
    .n_rfd_exact`, for a Gaussian draw ``w`` (B_total, 6), species-major.
    Returns a tuple of per-species (B_s, 6); multiply by kBT at the call
    site.  δ is floored at 1e-2 in float32 (``rfd.rfd_delta``).  group:
    distributed mode (the module docstring)."""
    dtype = states[0].X.dtype
    ws = tuple(torch.split(w.reshape(-1, 6).to(dtype),
                           [s.X.shape[0] for s in states]))
    delta = rfd.rfd_delta(cfg, dtype)

    def n_dot_w(sign):
        displaced = tuple(
            BodyState(*kin.update_X_Q(s.X, s.Q, sign * (delta / 2.0) * w_s))
            for s, w_s in zip(states, ws))
        return solve_saddle_multi(mgeom, cfg, displaced, None, ws,
                                  mob_apply=mob_apply, pcs=pcs,
                                  group=group).Us

    up, um = n_dot_w(1.0), n_dot_w(-1.0)
    return tuple((p - m) / delta for p, m in zip(up, um))


def stochastic_step_multi(mgeom: MultiGeometry, cfg: SimulationConfig,
                          states: Sequence[BodyState], forces, slip=None,
                          mob_apply: Callable = None, x0=None, pcs=None,
                          noise_pcs=None, mob_multi: Callable = None,
                          draws=None, generator: torch.Generator = None,
                          group=None):
    """One fluctuating BD step of the mixture, the modes of
    :func:`rigid_body_light_tpu_torch.dynamics.stochastic_step`: fused
    2-RHS Lanczos noise with ``split_rand`` (preconditioned by per-species
    body-frame factors, ``noise_pcs``, with ``lanczos_precond``), the
    midpoint-slip RFD drift, a per-species predictor half-kick and the
    saddle solve at the half-kicked configuration; or ``em_exact``, one
    draw, the solve at q^n and :func:`n_rfd_exact_multi`; a guarded
    per-species commit.  draws: (W1, W2, W_rfd) in the shapes of the module
    docstring, or None to draw them from ``generator``.  group: distributed
    mode (the module docstring), which needs the local ``mob_apply``.
    Returns (new_states, MultiSolveResult), its Us the committed
    velocities."""
    with profiling.span("step"):
        return _stochastic_step_multi(mgeom, cfg, tuple(states), forces, slip,
                                      mob_apply, x0, pcs, noise_pcs,
                                      mob_multi, draws, generator, group)


def _stochastic_step_multi(mgeom, cfg, states, forces, slip, mob_apply, x0,
                           pcs, noise_pcs, mob_multi, draws, generator,
                           group):
    default_mob = mob_apply is None
    if default_mob and group is not None:
        raise ValueError(
            "distributed stochastic_step_multi needs an explicit local "
            "mob_apply (parallel.ring_mobility_apply_fn with the "
            "mixture's radii)")
    with profiling.span("kinematics"):
        opses = geometry_ops_multi(mgeom, states)
    if default_mob:
        mob_apply = _mob_fns(mgeom, opses, cfg)[0]
    # as the single-species step: one operator passed as both products (the
    # distributed steppers) shares its pinned lattices with the noise
    same_multi = mob_multi is not None and mob_multi is mob_apply
    mob_apply = saddle_mod.pin_geometry(mob_apply, concat_positions(opses))
    if same_multi:
        mob_multi = mob_apply
    dtype = states[0].X.dtype
    dev = states[0].X.device
    n_total = sum(_blob_counts(opses))
    if slip is None:
        slip = torch.zeros((n_total, 3), dtype=dtype, device=dev)

    kBT = cfg.kBT
    drift_Us = None
    if kBT > 0.0:
        if draws is None:
            if generator is None:
                raise ValueError("stochastic_step_multi needs draws or a "
                                 "generator")
            draws = make_draws_multi(mgeom, states, generator, cfg)
        W1, W2, W_rfd = (None if w is None else
                         torch.as_tensor(w, dtype=dtype, device=dev)
                         for w in draws)
        if cfg.lanczos_precond and noise_pcs is None:
            noise_pcs = make_noise_preconditioner_multi(mgeom, cfg.a, cfg.eta)
        if mob_multi is None:
            if hasattr(mob_apply, "prepare"):
                mob_multi = mob_apply
            elif default_mob:
                mob_multi = _mob_fns(mgeom, opses, cfg)[1]
            else:
                def mob_multi(xk, r):
                    return torch.stack([mob_apply(x, r) for x in xk])
        pos = concat_positions(opses)
        with profiling.span("noise"):
            if uses_split(cfg):
                if cfg.lanczos_precond:
                    mhw1, mhw2 = m_half_w_precond_multi(
                        mob_multi, opses, noise_pcs, torch.stack([W1, W2]),
                        iters=cfg.lanczos_iters, group=group)
                else:
                    mhw1, mhw2 = lanczos.m_half_w_pair(
                        mob_multi, pos, torch.stack([W1, W2]),
                        iters=cfg.lanczos_iters, group=group)
                c1 = 2.0 * math.sqrt(kBT / cfg.dt)
                bi = math.sqrt(kBT / cfg.dt) * (mhw1 - mhw2)
            else:
                if cfg.lanczos_precond:
                    (mhw1,) = m_half_w_precond_multi(
                        mob_multi, opses, noise_pcs, W1[None],
                        iters=cfg.lanczos_iters, group=group)
                else:
                    mhw1 = lanczos.m_half_w(mob_apply, pos, W1,
                                            iters=cfg.lanczos_iters,
                                            group=group)
                c1 = math.sqrt(2.0 * kBT / cfg.dt)
                bi = c1 * mhw1
    if kBT > 0.0 and cfg.drift_mode == "em_exact":
        # plain EM: solve at q^n, add the solved-mobility divergence drift
        # afterwards — no midpoint kick
        slip_eff = slip - bi
        opses_solve = opses
        with profiling.span("rfd"):
            drift_Us = tuple(kBT * d for d in n_rfd_exact_multi(
                mgeom, cfg, states, W_rfd, mob_apply=mob_apply, pcs=pcs,
                group=group))
    elif kBT > 0.0:
        with profiling.span("rfd"):
            # drift: centered RFD of M along the rigid direction u = K⁺W
            w_parts = split_blobs(W_rfd.reshape(-1, 3), opses)
            us = tuple(kin.Kinv_dot(p.reshape(o.offsets.shape), o.offsets,
                                    o.ktkinv)
                       for p, o in zip(w_parts, opses))
            delta = cfg.rfd_delta
            r_p = _displaced_concat(mgeom, states, us, delta / 2.0)
            r_m = _displaced_concat(mgeom, states, us, -delta / 2.0)
            w = W_rfd.reshape(-1, 3)
            with profiling.span("mobility"):
                drift = kBT * (mob_apply(w, r_p) - mob_apply(w, r_m)) / delta
        slip_eff = slip - (drift + bi)
        with profiling.span("kinematics"):
            # predictor half-kick per species, guarded like a commit
            half_states = []
            for g, st, p, o in zip(mgeom.geoms, states,
                                   split_blobs(c1 * mhw1, opses), opses):
                u_half = kin.Kinv_dot(p.reshape(o.offsets.shape), o.offsets,
                                      o.ktkinv)
                half_states.append(_commit_species(g, cfg, st,
                                                   (cfg.dt / 2.0) * u_half))
            opses_solve = geometry_ops_multi(mgeom, half_states)
    else:
        slip_eff = slip
        opses_solve = opses

    res = solve_saddle_multi(mgeom, cfg, states, slip_eff, forces,
                             mob_apply=mob_apply, opses=opses_solve, x0=x0,
                             pcs=pcs, group=group)
    if drift_Us is not None:
        res = res._replace(Us=tuple(U + d for U, d in zip(res.Us, drift_Us)))
    ok = res.residual < cfg.max_step_residual
    with profiling.span("kinematics"):
        new_states = tuple(
            _commit_species(g, cfg, st,
                            torch.where(ok, U, torch.zeros_like(U)) * cfg.dt)
            for g, st, U in zip(mgeom.geoms, states, res.Us))
    return new_states, res


def _commit_species(geom, cfg: SimulationConfig, state: BodyState, dU):
    """Advance one species with the single-species move-rejection guards."""
    return _commit(geom, cfg, state, dU)


def _displaced_concat(mgeom, states, us, scale):
    parts = []
    for g, st, u in zip(mgeom.geoms, states, us):
        X, Q = kin.update_X_Q(st.X, st.Q, scale * u)
        parts.append(kin.blob_positions(g, X, Q).reshape(-1, 3))
    return torch.cat(parts, dim=0)


def run_bd_multi(mgeom: MultiGeometry, cfg: SimulationConfig,
                 states: Sequence[BodyState], n_steps: int,
                 generator: torch.Generator = None, force_fn: Callable = None,
                 slip_fn: Callable = None, mob_apply: Callable = None,
                 save_every: int = 1, mob_multi: Callable = None,
                 draws_fn: Callable = None, group=None):
    """A mixture BD trajectory of ``n_steps`` stochastic steps, with the
    warm starts and PC tiers of the single-species ``run_bd``: the
    ``block_free`` PC (and the static tier of ``ras``, whose coupling each
    solve builds fresh) and the noise factors are built once, a lagged PC
    (``pc_refresh`` > 1) every ``pc_refresh`` steps; each solve is warm
    started from the previous step's (λ, Us), zeroed after a failed solve.

    force_fn: (states, step) → tuple of per-species (B_s, 6) (default 0).
    slip_fn: (states, step) → (N_total, 3).  draws_fn: step → (W1, W2,
    W_rfd) in the shapes of the module docstring, else the draws come from
    ``generator``.  group: distributed mode (the module docstring): the
    states, forces, slip and draws are this rank's bodies.  Returns
    (final_states, trajectory) with per-species stacked snapshots every
    ``save_every`` steps: trajectory["X"][s] has shape (n_saved, B_s, 3);
    "residual" and "iters" (n_saved,).
    """
    states = tuple(states)
    dtype, dev = states[0].X.dtype, states[0].X.device
    if cfg.box is not None:
        for g in mgeom.geoms:
            check_box_geometry(cfg.box, g.ref_cfg.cpu().numpy(), cfg.a)
    sizes = tuple(s.X.shape[0] for s in states)
    if force_fn is None:
        def force_fn(ss, i):
            return tuple(torch.zeros((b, 6), dtype=dtype, device=dev)
                         for b in sizes)
    pc_mode = cfg.pc_mode or ("block" if cfg.block_diag_pc else "diag")
    static_pc = pc_mode in ("block_free", "ras")
    lagged_pc = cfg.pc_refresh > 1 and not static_pc
    species_a = mgeom.species_a(cfg)
    noise_pcs = (make_noise_preconditioner_multi(mgeom, cfg.a, cfg.eta)
                 if (cfg.lanczos_precond and cfg.kBT > 0.0) else None)
    pcs = (build_pc_multi(geometry_ops_multi(mgeom, states), cfg,
                          species_a=species_a)
           if (lagged_pc or static_pc) else None)
    n_total = sum(g.n_blobs * b for g, b in zip(mgeom.geoms, sizes))
    x_prev = (torch.zeros((n_total, 3), dtype=dtype, device=dev),
              tuple(torch.zeros((b, 6), dtype=dtype, device=dev)
                    for b in sizes))
    Xs, Qs, residuals, iters = [], [], [], []
    ss = states
    for i in range(n_steps):
        if lagged_pc and i % cfg.pc_refresh == 0:
            pcs = build_pc_multi(geometry_ops_multi(mgeom, ss), cfg,
                                 species_a=species_a)
        ss, res = stochastic_step_multi(
            mgeom, cfg, ss, force_fn(ss, i),
            slip=slip_fn(ss, i) if slip_fn is not None else None,
            mob_apply=mob_apply, x0=x_prev, pcs=pcs, noise_pcs=noise_pcs,
            mob_multi=mob_multi,
            draws=draws_fn(i) if draws_fn is not None else None,
            generator=generator, group=group)
        Xs.append(tuple(s.X for s in ss))
        Qs.append(tuple(s.Q for s in ss))
        residuals.append(res.residual)
        iters.append(torch.tensor(res.iters))
        # a failed solve's (λ, Us) would poison the next warm start
        ok = res.residual < cfg.max_step_residual
        x_prev = (torch.where(ok, res.lam, torch.zeros_like(res.lam)),
                  tuple(torch.where(ok, U, torch.zeros_like(U))
                        for U in res.Us))
    keep = slice(save_every - 1, None, save_every)
    n_s = len(states)
    return ss, {
        "X": tuple(torch.stack([x[s] for x in Xs])[keep] for s in range(n_s)),
        "Q": tuple(torch.stack([q[s] for q in Qs])[keep] for s in range(n_s)),
        "residual": torch.stack(residuals)[keep],
        "iters": torch.stack(iters)[keep],
    }
