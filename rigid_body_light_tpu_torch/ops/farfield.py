"""Proxy-grid far field for the open-domain RPY matvec — the port of
``rigid_body_light_tpu/ops/farfield.py`` on one device: the open domain
with or without a wall, and the pseudo-2D film (a doubly periodic (Lx, Ly)
box above the wall).

    M ≈ M_near (exact pairs, adjacent cells)  +  Pᵀ · K · P  (far)

  - P (anterpolation): each blob spreads onto the p³ tensor-Chebyshev nodes
    of its cell with separable Lagrange weights.
  - K (M2L): node→node RPY blocks between non-adjacent cells.  On a uniform
    grid K depends only on the cell offset, so the far field is a 3-D
    convolution over the cell grid, evaluated by FFT: Û(q) = K̂(q)·Q̂(q), a
    batched (3p³ × 3p³) complex matmul per frequency.  The wall images are
    translation invariant in x/y only, so their lattices couple every
    (target, source) pair of z cells: one (Gz·3p³ × Gz·3p³) matmul per x/y
    frequency.  In the film the x/y convolution is cyclic at box size (no
    padding: the wrap is the periodicity) over one combined free + wall
    lattice summed over the in-plane images (:func:`_kernel_hat_2p`).
  - M_near: blob pairs in adjacent cells (∞-norm cell offset ≤ 1, cyclic in
    x/y in the film), swept exactly over cell-snake tiles of ``TILE`` blobs
    against per-tile neighbor-tile lists, masked pairwise by cell adjacency
    so near and far partition every pair exactly once.  On a CUDA tensor
    the sweep is the hand-written kernel K3 (:mod:`.farfield_cuda`), which
    visits each unordered pair of neighbor tiles once
    (:func:`.tiles.tile_pairs`);
    :func:`_near_sweep` is its plain version.

The grid is anchored to the dynamic bounding box (in the film: x/y at 0
with h·G = box, z to the bounding box).  The neighbor-tile list width is
the only static bound: overflow NaN-poisons the apply, as does a reused
geometry tier (:func:`prepare` with ``geo=``) that the positions have left
by more than half a cell.

Per-blob radii (the polydisperse operator) keep the far field translation
invariant by splitting the pair kernel over its radius dependence, which is
a low-order polynomial (the JAX module's split):

  - free space (far branch): M = K₀(r) + (âᵢ² + âⱼ²)·K₂(r), two lattices
    (:func:`_free_split_coeffs`); the â²-weighted forces ride the same
    spread and FFTs as extra right-hand sides;
  - wall images (the √(aᵢaⱼ) convention of the pair sweeps): the
    Swan–Brady coefficients split by image-distance power, G₀ + âᵢâⱼ·G₁ +
    (âᵢâⱼ)²·G₂, three lattices (:func:`_wall_coeffs_split`);
  - the film: four lattices [K₀ + G₀, G₁, G₂, K₂].

Moments go in as [F, â²F] (free) or [F, âF, â²F] (wall, film); outputs
come back with weights [1, âᵢ²] or [1, âᵢ², âᵢ] (:func:`_far_part`).  The
near sweep takes the polydisperse pair fields (K3's POLY form).  As in the
JAX package, cells no smaller than the largest contact distance max(âᵢ +
âⱼ) are required and not checked: every far pair is then in the
non-overlapping branch.

The band tier (``band_p``, the configuration's ``farfield_band_p``; open
domain only) re-evaluates the cell offsets of ∞-norm 2.._BAND_MAX at a
higher Chebyshev order as a direct block convolution (batched matmuls over
the offsets, :func:`_band_apply_free` / :func:`_band_apply_wall`, the
span ``far_band``) and masks the FFT lattices to the offsets beyond; it
takes the same moment and output channels, with or without radii.

With a ``group`` (a ``torch.distributed`` process group; the JAX
package's ``mobility_apply_local``, ``prepare_local`` and
``prepare_geometry_local``, which keep those names here) the same
functions run the operator over the group's ranks, each holding its
blobs: the bounding box closes with MIN / MAX all-reduces, the node
moments with a sum, the lattices are built on every rank alike, and the
near part sweeps each rank's slice of the gathered sorted tiles (K3's
row-tile slice).  The film over a group takes its z bounds the same way,
builds the same image-summed lattices on every rank and sweeps the
cyclic neighbor lists of the gathered tiles through K3's box slice.  The
TPU layout workarounds of the JAX module (the ``_flat_outer``
selector matmuls, the packed real/imaginary lattices, ``fftsafe``) are not
ported: plain outer products, complex tensors and ``torch.fft`` compute
the same thing.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from rigid_body_light_tpu_torch.ops import farfield_cuda, rpy, tiles
from rigid_body_light_tpu_torch.utils import collectives, profiling

# near-sweep tile: cell-snake runs of TILE blobs (the JAX module's TILE),
# the row and column tile of kernel K3
TILE = farfield_cuda.TILE
# byte budget of the resident kernel lattices that auto_grid sizes the grid
# to — the JAX package's value, so both packages pick the same grid
KHAT_BUDGET = 2 * 2**30
CELL_TARGET = 32  # blobs per supercell auto_grid aims for


# ----------------------------------------------------------------- basis
def _cheb_nodes(p: int) -> np.ndarray:
    """p Chebyshev points mapped to (0, 1)."""
    k = np.arange(p)
    return (np.cos(np.pi * (k + 0.5) / p)[::-1] + 1.0) / 2.0


def _lagrange_weights(t, nodes):
    """(..., p) Lagrange basis values at t ∈ [0, 1] (product form)."""
    p = len(nodes)
    nd = np.asarray(nodes)
    denom = np.array([np.prod(nd[k] - np.delete(nd, k)) for k in range(p)])
    diff = t[..., None] - torch.as_tensor(nd, dtype=t.dtype, device=t.device)
    full = torch.prod(diff, dim=-1, keepdim=True)           # Π (t - t_j)
    # Π_{j≠k} (t−t_j) = full / (t−t_k), guarded at the nodes
    tiny = 1e-30
    exact = diff.abs() < tiny                                # t on a node
    terms = full / torch.where(exact, torch.full_like(diff, tiny), diff)
    any_exact = exact.any(dim=-1, keepdim=True)
    return torch.where(any_exact, exact.to(t.dtype),
                       terms / torch.as_tensor(denom, dtype=t.dtype,
                                               device=t.device))


def _blob_weights(t3, nodes):
    """(N, 3) fractional coordinates → (N, p³) separable tensor weights,
    node index (i·p + j)·p + l for x, y, z nodes i, j, l."""
    wx, wy, wz = (_lagrange_weights(t3[:, d], nodes) for d in range(3))
    w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    return w.reshape(t3.shape[0], -1)


def _node_grid(p, dtype, device):
    """(p³, 3) Chebyshev node coordinates in a unit cell."""
    nodes = _cheb_nodes(p)
    return torch.as_tensor(
        np.stack(np.meshgrid(nodes, nodes, nodes, indexing="ij"),
                 axis=-1).reshape(-1, 3), dtype=dtype, device=device)


# ----------------------------------------------------------- grid/binning
def _grid_geometry(x, grid, group=None):
    """Dynamic bounding box → (lo, h), h the per-axis cell sizes (units
    of a).  group: the distributed apply's, over whose ranks the box
    closes (MIN / MAX all-reduces of the local bounds)."""
    lo = collectives.pmin(x.min(dim=0).values, group)
    hi = collectives.pmax(x.max(dim=0).values, group)
    span = torch.clamp(hi - lo, min=1e-6) * (1.0 + 1e-5)
    return lo, span / torch.as_tensor(grid, dtype=x.dtype, device=x.device)


def _cell_indices(x, lo, h, grid):
    """(N, 3) int32 cell indices, clipped into the grid, and (N,) int64
    flat cell ids."""
    gx, gy, gz = grid
    g = torch.as_tensor(grid, dtype=torch.int32, device=x.device)
    ci = torch.minimum(torch.clamp(((x - lo) / h).to(torch.int32), min=0),
                       g - 1)
    cid = (ci[:, 0].long() * gy + ci[:, 1]) * gz + ci[:, 2]
    return ci, cid


def _signed_offsets(g: int) -> np.ndarray:
    """Signed cell offsets Δ = c_target − c_source on the 2g cyclic pad."""
    o = np.arange(2 * g)
    return np.where(o < g, o, o - 2 * g).astype(np.int64)


def _signed_offsets_cyclic(g: int) -> np.ndarray:
    """Minimum-imaged cell offsets on a g-cyclic (unpadded) axis."""
    o = np.arange(g)
    return np.where(o <= g // 2, o, o - g).astype(np.int64)


# -------------------------------------------------------- kernel lattices
def _free_split_coeffs(r2):
    """The far-branch free-space RPY split by radius dependence: α = 1/r +
    (âᵢ² + âⱼ²)/(3r³), β = 1/r³ − (âᵢ² + âⱼ²)/r⁵ (the far branch of
    :func:`.rpy._free_coeffs_poly`) is K₀ + (âᵢ² + âⱼ²)·K₂ with K₀: (α, β)
    = (1/r, 1/r³) and K₂: (1/(3r³), −1/r⁵), both translation invariant.
    Returns ((α₀, β₀), (α₂, β₂)).  r² is floored at 1e-2 (far node pairs
    are a cell apart; the floor only keeps the masked near offsets
    finite)."""
    r2s = torch.clamp(r2, min=1e-2)
    invr2 = 1.0 / r2s
    invr = torch.sqrt(invr2)
    invr3 = invr * invr2
    invr5 = invr3 * invr2
    return (invr, invr3), (invr3 / 3.0, -invr5)


def _far_kernel_hat(h, grid, p, poly=False, near_excl=1):
    """K̂: half-spectrum FFT over the offset grid of the free-space RPY node
    blocks between non-adjacent cells, (2gx·2gy·(gz+1), B, B) complex with
    B = 3p³ (row = target node·3 + component, column = source); ``poly``:
    the two lattices [K₀, K₂] of :func:`_free_split_coeffs`, stacked as
    (2, 2gx·2gy·(gz+1), B, B).  near_excl: the cell offsets zeroed are
    those with ∞-norm ≤ near_excl (1, the near pairs; _BAND_MAX with the
    band tier, which takes offsets 2.._BAND_MAX).

    Built one x-offset slab at a time, so the temporaries stay a 2gx-th of
    the lattice."""
    gx, gy, gz = grid
    dtype, dev = h.dtype, h.device
    B = 3 * p ** 3
    nk = 2 if poly else 1
    tn = _node_grid(p, dtype, dev)
    dn = tn[:, None, :] - tn[None, :, :]                     # (p³, p³, 3)
    oyz = np.stack(np.meshgrid(_signed_offsets(gy), _signed_offsets(gz),
                               indexing="ij"), axis=-1).reshape(-1, 2)
    far_yz = np.any(np.abs(oyz) > near_excl, axis=-1)        # (2gy·2gz,)
    eye = torch.eye(3, dtype=dtype, device=dev)
    Kh = torch.empty((nk, 2 * gx, 2 * gy, gz + 1, B, B),
                     dtype=torch.promote_types(dtype, torch.complex64),
                     device=dev)
    for ix, ox in enumerate(_signed_offsets(gx)):
        off = torch.as_tensor(
            np.concatenate([np.full((len(oyz), 1), float(ox)), oyz], axis=1),
            dtype=dtype, device=dev)                         # (m, 3)
        # d = node_n(target) − node_m(source) = (t_n − t_m + Δ)·h
        d = (dn[None] + off[:, None, None, :]) * h           # (m, p³, p³, 3)
        r2 = torch.sum(d * d, dim=-1)
        coeffs = _free_split_coeffs(r2) if poly else (rpy._free_coeffs(r2),)
        far = torch.as_tensor(far_yz | (abs(ox) > near_excl),
                              device=dev)[:, None, None]
        for c, (alpha, beta) in enumerate(coeffs):
            alpha = torch.where(far, alpha, torch.zeros_like(alpha))
            beta = torch.where(far, beta, torch.zeros_like(beta))
            K = (alpha[..., None, None] * eye
                 + beta[..., None, None] * d[..., :, None] * d[..., None, :])
            K = K.permute(0, 1, 3, 2, 4).reshape(2 * gy, 2 * gz, B, B)
            Kh[c, ix] = torch.fft.fft(torch.fft.rfft(K, dim=1), dim=0)
    Kh = torch.fft.fft(Kh, dim=1).reshape(nk, -1, B, B)
    return Kh if poly else Kh[0]


def _wall_coeffs_split(d_img, hj):
    """Swan–Brady wall coefficients split by image-distance power: three
    channels (f1..f5) of the 1/R, 1/R³ and 1/R⁵ terms, whose sum is the
    equal-radius correction (f = f1·I + f2·e⊗e + f3·e⊗ẑ + f4·ẑ⊗e + f5·ẑ⊗ẑ),
    and 1/R.  In the √(aᵢaⱼ) convention of the polydisperse pair sweeps the
    correction is parts[0] + âᵢâⱼ·parts[1] + (âᵢâⱼ)²·parts[2]: ĥ and e are
    scale invariant, and the 1/a_eff prefactor times (a_eff/R)^m leaves
    (âᵢâⱼ)^((m−1)/2) for m = 1, 3, 5.  R² is floored at 1e-2: far node
    pairs are at least a cell apart."""
    rz = d_img[..., 2]
    h_hat = hj / torch.clamp(rz, min=1e-12)
    r2 = torch.sum(d_img * d_img, dim=-1)
    invR = torch.rsqrt(torch.clamp(r2, min=1e-2))
    ez = rz * invR
    ez2 = ez * ez
    invR3 = invR * invR * invR
    invR5 = invR3 * invR * invR
    hh = h_hat * (1.0 - h_hat)
    p0 = (-(1.0 + 2.0 * hh * ez2) * invR,
          -(1.0 - 6.0 * hh * ez2) * invR,
          2.0 * ez * h_hat * (1.0 - 6.0 * (1.0 - h_hat) * ez2) * invR,
          2.0 * ez * h_hat * invR,
          -4.0 * h_hat * h_hat * ez2 * invR)
    p1 = (-(2.0 / 3.0) * (1.0 - 3.0 * ez2) * invR3,
          2.0 * (1.0 - 5.0 * ez2) * invR3,
          -4.0 * ez * (1.0 - 5.0 * ez2) * invR3,
          torch.zeros_like(invR3),
          -4.0 * ez2 * invR3)
    p2 = ((2.0 / 3.0) * (1.0 - 5.0 * ez2) * invR5,
          -(10.0 / 3.0) * (1.0 - 7.0 * ez2) * invR5,
          (20.0 / 3.0) * ez * (2.0 - 7.0 * ez2) * invR5,
          -(20.0 / 3.0) * ez * invR5,
          -(4.0 / 3.0) * (2.0 - 15.0 * ez2) * invR5)
    return (p0, p1, p2), invR


def _wall_kernel_hat(lo_z, h, grid, p, h_floor, poly=False, near_excl=1):
    """K̂_wall: the Swan–Brady image node blocks, translation invariant in
    x/y only, so the z cells pair explicitly; 2-D FFT'd over the padded x/y
    offsets.  Returns (2gx·(gy+1), gz·B, gz·B) complex: per x/y frequency,
    rows (target z cell, target node·3 + component), columns (source z
    cell, source node·3 + component).  Offsets that can hold a near pair
    (every cell-offset component within 1) are zeroed, matching the near
    sweep's partition; with the band tier, every offset whose components
    are all within near_excl = _BAND_MAX.  ``poly``: the three power
    channels [G₀, G₁, G₂] of :func:`_wall_coeffs_split` apart, (3,
    2gx·(gy+1), gz·B, gz·B).  Built one target z cell at a time."""
    gx, gy, gz = grid
    dtype, dev = h.dtype, h.device
    B = 3 * p ** 3
    nk = 3 if poly else 1
    ox = _signed_offsets(gx)
    oy = _signed_offsets(gy)
    near_xy = torch.as_tensor((np.abs(ox) <= near_excl)[:, None]
                              & (np.abs(oy) <= near_excl)[None, :],
                              device=dev)
    tn = _node_grid(p, dtype, dev)
    dx = ((torch.as_tensor(ox, dtype=dtype, device=dev)[:, None, None]
           + tn[None, :, None, 0] - tn[None, None, :, 0]) * h[0])  # (2gx,p³,p³)
    dy = ((torch.as_tensor(oy, dtype=dtype, device=dev)[:, None, None]
           + tn[None, :, None, 1] - tn[None, None, :, 1]) * h[1])  # (2gy,p³,p³)
    # node heights per z cell, floored like every wall evaluation
    cz = torch.arange(gz, dtype=dtype, device=dev)
    zn = lo_z + (cz[:, None] + tn[None, :, 2]) * h[2]        # (gz, p³)
    znf = torch.clamp(zn, min=h_floor) if h_floor > 0 else zn
    eye = torch.eye(3, dtype=dtype, device=dev)
    zhat = eye[2]
    shape = (2 * gx, gz, 2 * gy, p ** 3, p ** 3)
    Kh = torch.empty((nk, gz, 2 * gx, gz, gy + 1, B, B),
                     dtype=torch.promote_types(dtype, torch.complex64),
                     device=dev)
    for ci in range(gz):
        zj = znf[None, :, None, None, :].expand(shape)       # source nodes
        rz = znf[ci][None, None, None, :, None] + zj
        d_img = torch.stack([dx[:, None, None].expand(shape),
                             dy[None, None].expand(shape), rz], dim=-1)
        parts, invR = _wall_coeffs_split(d_img, zj)
        if not poly:
            parts = (tuple(a + b + c for a, b, c in zip(*parts)),)
        near_z = (torch.arange(gz, device=dev) - ci).abs() <= near_excl
        far = ~(near_xy[:, None, :] & near_z[None, :, None])[..., None, None]
        e = d_img * invR[..., None]
        for c, fs in enumerate(parts):
            f1, f2, f3, f4, f5 = (torch.where(far, f, torch.zeros_like(f))
                                  for f in fs)
            W = (f1[..., None, None] * eye
                 + f2[..., None, None] * e[..., :, None] * e[..., None, :]
                 + f3[..., None, None] * e[..., :, None] * zhat[None, :]
                 + f4[..., None, None] * zhat[:, None] * e[..., None, :]
                 + f5[..., None, None] * zhat[:, None] * zhat[None, :])
            # (2gx, gz_s, 2gy, p³, p³, 3, 3) → (2gx, gz_s, 2gy, B, B)
            W = W.permute(0, 1, 2, 3, 5, 4, 6).reshape(2 * gx, gz, 2 * gy,
                                                        B, B)
            Kh[c, ci] = torch.fft.fft(torch.fft.rfft(W, dim=2), dim=0)
    # (nk, gz_t, 2gx, gz_s, gy+1, B, B) → (nk, 2gx·(gy+1), gz_t·B, gz_s·B)
    Kh = Kh.permute(0, 2, 4, 1, 5, 3, 6).reshape(
        nk, 2 * gx * (gy + 1), gz * B, gz * B)
    return Kh if poly else Kh[0]


# -------------------------------------------------------------- band tier
# The p = 4 operator's error comes mostly from the closest non-adjacent
# cells (the JAX package's measured interpolation error by cell offset:
# p = 4 → 6e-3 at offset 2, 1e-3 at 3, 2.3e-4 at ≥ 4; p = 6 → 1.7e-4 at
# 2).  With ``band_p`` the cell offsets of ∞-norm 2.._BAND_MAX are
# evaluated at that order as a direct block convolution over the cells
# (batched matmuls; storage ∝ the band offsets, no spectrum), and the FFT
# tier is masked to the offsets beyond (``near_excl=_BAND_MAX``): p = 6-class
# operator error at the p = 4 lattices' memory.
_BAND_MAX = 3
# scalar entries of one field of a band-block batch at build time, and of
# one gathered operand at apply time (float32: 256 MiB)
BAND_BATCH_ELEMS = 2 ** 26


def _band_offsets_free() -> np.ndarray:
    """All 3-D cell offsets with ∞-norm in [2, _BAND_MAX]: (316, 3)."""
    rng_ = np.arange(-_BAND_MAX, _BAND_MAX + 1)
    O = np.stack(np.meshgrid(rng_, rng_, rng_, indexing="ij"),
                 axis=-1).reshape(-1, 3)
    m = np.abs(O).max(axis=1)
    return O[(m >= 2) & (m <= _BAND_MAX)].astype(np.int64)


def _band_offsets_xy() -> np.ndarray:
    """All x/y cell offsets with ∞-norm ≤ _BAND_MAX: (49, 2).  The wall
    band pairs the z cells explicitly; its blocks carry the band test."""
    rng_ = np.arange(-_BAND_MAX, _BAND_MAX + 1)
    OX, OY = np.meshgrid(rng_, rng_, indexing="ij")
    return np.stack([OX, OY], axis=-1).reshape(-1, 2).astype(np.int64)


def _band_sources(grid, off):
    """For cell offsets ``off`` (n, d) on the first d axes of ``grid``:
    the (n, ncell_d) flat source cell c − o of every target cell c (0 where
    out of range) and the in-range mask, as numpy."""
    g = np.asarray(grid[:off.shape[1]])
    cells = np.stack(np.meshgrid(*[np.arange(v) for v in g],
                                 indexing="ij"), axis=-1).reshape(-1, len(g))
    src = cells[None, :, :] - off[:, None, :]
    ok = np.all((src >= 0) & (src < g), axis=-1)
    flat = src[..., 0]
    for ax in range(1, len(g)):
        flat = flat * g[ax] + src[..., ax]
    return np.where(ok, flat, 0), ok


@functools.lru_cache(maxsize=16)
def _band_plan(grid, device):
    """The band offsets that reach some target cell of ``grid`` (the
    others add only zeros: |oz| = 3 with gz = 3, say), with their source
    cells and masks on ``device``: ((off_free, idx, ok), (off_xy, idx,
    ok)), idx int64 and ok bool tensors of (n_live, ncell) and (n_live,
    gx·gy)."""
    plans = []
    for off in (_band_offsets_free(), _band_offsets_xy()):
        idx, ok = _band_sources(grid, off)
        live = ok.any(axis=1)
        plans.append((off[live],
                      torch.as_tensor(idx[live], device=device),
                      torch.as_tensor(ok[live], device=device)))
    return tuple(plans)


def _band_blocks_free(h, bp, poly=False, offsets=None):
    """Free-space node blocks K_o at the band offsets: (nk, n_off, B6, B6)
    with B6 = 3·bp³, row = target node·3 + component, column = source (the
    lattices' convention); nk = 2 with ``poly`` ([K₀, K₂] of
    :func:`_free_split_coeffs`).  offsets: (n_off, 3) cell offsets, by
    default all of :func:`_band_offsets_free`."""
    off = _band_offsets_free() if offsets is None else offsets
    dtype, dev = h.dtype, h.device
    p3 = bp ** 3
    B6 = 3 * p3
    tn = _node_grid(bp, dtype, dev)
    dn = tn[:, None, :] - tn[None, :, :]                     # (p³, p³, 3)
    eye = torch.eye(3, dtype=dtype, device=dev)
    Kb = torch.empty((2 if poly else 1, len(off), B6, B6), dtype=dtype,
                     device=dev)
    nb = max(1, BAND_BATCH_ELEMS // (9 * p3 * p3))
    for o0 in range(0, len(off), nb):
        o = torch.as_tensor(off[o0:o0 + nb], dtype=dtype, device=dev)
        # d = node_n(target) − node_m(source) = (t_n − t_m + o)·h
        d = (dn[None] + o[:, None, None, :]) * h             # (b, p³, p³, 3)
        r2 = torch.sum(d * d, dim=-1)
        coeffs = _free_split_coeffs(r2) if poly else (rpy._free_coeffs(r2),)
        for c, (alpha, beta) in enumerate(coeffs):
            K = (alpha[..., None, None] * eye
                 + beta[..., None, None] * d[..., :, None] * d[..., None, :])
            Kb[c, o0:o0 + len(o)] = K.permute(0, 1, 3, 2, 4).reshape(
                -1, B6, B6)
    return Kb


def _band_blocks_wall(lo_z, h, grid, bp, h_floor, poly=False, offsets=None):
    """Wall-image band blocks: (nk, n_oxy, gz·B6, gz·B6) per x/y offset,
    rows (target z cell, target node·3 + component) and columns (source z
    cell, ...), as :func:`_wall_kernel_hat` lays out a frequency; zero
    outside the band 2 ≤ max(|o_xy|∞, |cz_t − cz_s|) ≤ _BAND_MAX.  nk = 3
    with ``poly`` (the power channels of :func:`_wall_coeffs_split`).
    offsets: (n_oxy, 2), by default all of :func:`_band_offsets_xy`.
    Built one target z cell at a time."""
    gz = grid[2]
    oxy = _band_offsets_xy() if offsets is None else offsets
    m = len(oxy)
    dtype, dev = h.dtype, h.device
    p3 = bp ** 3
    B6 = 3 * p3
    tn = _node_grid(bp, dtype, dev)
    oxy_t = torch.as_tensor(oxy, dtype=dtype, device=dev)
    dx = (oxy_t[:, None, None, 0] + tn[None, :, None, 0]
          - tn[None, None, :, 0]) * h[0]                     # (m, p³, p³)
    dy = (oxy_t[:, None, None, 1] + tn[None, :, None, 1]
          - tn[None, None, :, 1]) * h[1]
    cz = torch.arange(gz, dtype=dtype, device=dev)
    zn = lo_z + (cz[:, None] + tn[None, :, 2]) * h[2]        # (gz, p³)
    znf = torch.clamp(zn, min=h_floor) if h_floor > 0 else zn
    eye = torch.eye(3, dtype=dtype, device=dev)
    zhat = eye[2]
    oxy_norm = np.abs(oxy).max(axis=1)
    nk = 3 if poly else 1
    Kw = torch.empty((nk, m, gz, B6, gz, B6), dtype=dtype, device=dev)
    shape = (gz, m, p3, p3)                    # (source z cell, offset, n_t, n_s)
    for ci in range(gz):
        zj = znf[:, None, None, :].expand(shape)
        rz = znf[ci][None, None, :, None] + zj
        d_img = torch.stack([dx[None].expand(shape), dy[None].expand(shape),
                             rz], dim=-1)
        parts, invR = _wall_coeffs_split(d_img, zj)
        if not poly:
            parts = (tuple(a + b + c for a, b, c in zip(*parts)),)
        mnorm = np.maximum(np.abs(np.arange(gz) - ci)[:, None],
                           oxy_norm[None, :])
        band = torch.as_tensor((mnorm >= 2) & (mnorm <= _BAND_MAX),
                               device=dev)[..., None, None]  # (gz, m, 1, 1)
        e = d_img * invR[..., None]
        for c, fs in enumerate(parts):
            f1, f2, f3, f4, f5 = (torch.where(band, f, torch.zeros_like(f))
                                  for f in fs)
            W = (f1[..., None, None] * eye
                 + f2[..., None, None] * e[..., :, None] * e[..., None, :]
                 + f3[..., None, None] * e[..., :, None] * zhat[None, :]
                 + f4[..., None, None] * zhat[:, None] * e[..., None, :]
                 + f5[..., None, None] * zhat[:, None] * zhat[None, :])
            # (gz_s, m, p³_t, p³_s, 3, 3) → (m, p³_t·3, gz_s, p³_s·3)
            Kw[c, :, ci] = W.permute(1, 2, 4, 0, 3, 5).reshape(m, B6, gz, B6)
    return Kw.reshape(nk, m, gz * B6, gz * B6)


def _band_conv(K, Qs, okf, idx, chans):
    """Σ_o K_o·Q[source_o(c)] over offset chunks.  K (nk, n_off, R, R);
    Qs (nm, nc, rows, R) the moments with cells on axis 1; idx / okf
    (n_off, ncell) source cells and masks (each gathered source is scaled
    by its mask, so a masked one adds an exact 0); chans: per output
    channel the (kernel, moment) pairs it sums → (nout, ncell, rows, R)."""
    nm, _, rows, R = Qs.shape
    n_off, ncell = idx.shape
    out = torch.zeros((len(chans), ncell, rows, R), dtype=Qs.dtype,
                      device=Qs.device)
    nb = max(1, BAND_BATCH_ELEMS // (nm * ncell * rows * R))
    for o0 in range(0, n_off, nb):
        sl = slice(o0, o0 + nb)
        G = Qs[:, idx[sl]] * okf[None, sl, :, None, None]    # (nm, b, nc, rows, R)
        G = G.reshape(nm, -1, ncell * rows, R)
        for u, terms in enumerate(chans):
            for c, mo in terms:
                out[u] += torch.matmul(G[mo], K[c, sl].transpose(1, 2)).sum(
                    0).reshape(ncell, rows, R)
    return out


def _band_apply_free(Kb, Q, grid, idx=None, ok=None):
    """Direct banded block convolution of the free kernel: Q (nm, k, ncell,
    B6) moment channels ([F], or [F, â²F] with Kb [K₀, K₂]) × Kb (nk,
    n_off, B6, B6) → (nout, k, ncell, B6) with :func:`_far_free`'s channel
    conventions (U₀ = K₀*F + K₂*(â²F), U₂ = K₂*F).  idx / ok: the source
    cells and masks of Kb's offsets (:func:`_band_sources`); by default
    those of all of :func:`_band_offsets_free`."""
    if idx is None:
        idx, ok = (torch.as_tensor(a, device=Q.device) for a in
                   _band_sources(grid, _band_offsets_free()))
    nm, k = Q.shape[:2]
    chans = ([((0, 0), (1, 1)), ((1, 0),)] if nm == 2 else [((0, 0),)])
    U = _band_conv(Kb, Q.transpose(1, 2), ok.to(Q.dtype), idx, chans)
    return U.transpose(1, 2)


def _band_apply_wall(Kw, Q, grid, idx=None, ok=None):
    """Direct banded block convolution of the wall images: Q (nm, k, ncell,
    B6) moment channels ([F], or [F, âF, â²F], each against its own power
    channel of Kw) × Kw (nk, n_oxy, gz·B6, gz·B6) → (nm, k, ncell, B6)
    output channels of weight [1] or [1, âᵢ, âᵢ²] (:func:`_far_wall`'s).
    idx / ok: the x/y source cells and masks of Kw's offsets; by default
    those of all of :func:`_band_offsets_xy`."""
    gx, gy, gz = grid
    if idx is None:
        idx, ok = (torch.as_tensor(a, device=Q.device) for a in
                   _band_sources(grid, _band_offsets_xy()))
    nm, k, ncell, B6 = Q.shape
    Qz = Q.reshape(nm, k, gx * gy, gz * B6).transpose(1, 2)  # (nm, nxy, k, gz·B6)
    U = _band_conv(Kw, Qz, ok.to(Q.dtype), idx,
                   [((c, c),) for c in range(nm)])
    return U.transpose(1, 2).reshape(nm, k, ncell, B6)


# scalar entries of one field of a shift batch in the pseudo-2D lattice
# build (the batch's temporaries are a few dozen such fields)
SHIFT_BATCH_ELEMS = 2 ** 25


def _add_blocks(acc, w, d, e, free=None, wall=None):
    """acc (3, 3, ...) += the node blocks α·I + β·d⊗d + f1·I + f2·e⊗e +
    f3·e⊗ẑ + f4·ẑ⊗e + f5·ẑ⊗ẑ weighted by w, summed over the shift batch
    (dim 0), one entry at a time.  d, e: the (x, y, z) components of the
    free displacement and of the unit image direction; free: (α, β) or
    None; wall: (f1, ..., f5) or None."""
    if free is not None:
        a_, b_ = (f * w for f in free)
    if wall is not None:
        g1, g2, g3, g4, g5 = (f * w for f in wall)
    for i in range(3):
        for j in range(3):
            t = 0.0
            if free is not None:
                t = b_ * d[i] * d[j] + (a_ if i == j else 0.0)
            if wall is not None:
                t = t + g2 * e[i] * e[j]
                if i == j:
                    t = t + g1
                if j == 2:
                    t = t + g3 * e[i]
                if i == 2:
                    t = t + g4 * e[j]
                if i == j == 2:
                    t = t + g5
            acc[i, j] += t.sum(0)


def _kernel_hat_2p(lo_z, h, grid, p, h_floor, shells, poly=False):
    """K̂ of the pseudo-2D film (x/y periodic, wall at z = 0): the combined
    free + wall-image node blocks per (target, source) z-cell pair and
    cyclic x/y cell offset, summed over the (2S+1)² in-plane images
    n·(Lx, Ly), then 2-D FFT'd at box size.  Returns (gx·(gy//2+1), gz·B,
    gz·B) complex, laid out as :func:`_wall_kernel_hat`'s lattice;
    ``poly``: four lattices [K₀ + G₀, G₁, G₂, K₂] (the free split of
    :func:`_free_split_coeffs`, the wall powers of
    :func:`_wall_coeffs_split`), stacked as (4, gx·(gy//2+1), gz·B, gz·B).

    Only the combined sum converges (the free 1/ρ Stokeslet alone diverges
    over a 2-D lattice; its wall images cancel it to 1/ρ³; each poly
    channel decays as fast, so the same tail weights apply).  Each shift
    weighs 1 + the two-ring Richardson tail weight of its ring
    (:func:`.rpy.tail_coeffs`: α on ring S, β on ring S − 1).  The near
    exclusion zeroes only the n = 0 term of wrapped-adjacent offsets: a
    pair's other images, a blob's own included, stay in the far tier.
    Requires h·(gx, gy) = box (the caller anchors x/y at 0 and wraps the
    positions).  The shifts are evaluated in batches whose fields hold at
    most SHIFT_BATCH_ELEMS entries a lattice, so the four poly lattices
    take batches a quarter the size."""
    gx, gy, gz = grid
    dtype, dev = h.dtype, h.device
    p3 = p ** 3
    B = 3 * p3
    nk = 4 if poly else 1
    ox, oy = np.meshgrid(_signed_offsets_cyclic(gx),
                         _signed_offsets_cyclic(gy), indexing="ij")
    oxy = np.stack([ox, oy], axis=-1).reshape(-1, 2)         # (m, 2)
    m = oxy.shape[0]
    near_xy = torch.as_tensor(np.all(np.abs(oxy) <= 1, axis=-1), device=dev)
    tn = _node_grid(p, dtype, dev)
    oxy_t = torch.as_tensor(oxy, dtype=dtype, device=dev)
    dx0 = (oxy_t[:, None, None, 0] + tn[None, :, None, 0]
           - tn[None, None, :, 0]) * h[0]                    # (m, p³, p³)
    dy0 = (oxy_t[:, None, None, 1] + tn[None, :, None, 1]
           - tn[None, None, :, 1]) * h[1]
    cz = torch.arange(gz, dtype=dtype, device=dev)
    zn = lo_z + (cz[:, None] + tn[None, :, 2]) * h[2]        # (gz, p³) raw
    znf = torch.clamp(zn, min=h_floor) if h_floor > 0 else zn
    # (batch, z target, z source, offset, target node, source node): the
    # free part on the raw node heights, the wall part on the floored ones
    dz = (zn[:, None, None, :, None] - zn[None, :, None, None, :])[None]
    rz = (znf[:, None, None, :, None] + znf[None, :, None, None, :])[None]
    zj = znf[None, None, :, None, None, :]
    iz = torch.arange(gz, device=dev)
    near0 = (((iz[:, None] - iz[None, :]).abs() <= 1)[:, :, None]
             & near_xy[None, None, :])                       # (gz, gz, m)
    # image shifts n·(gx, gy) cells with their tail weights, ix major
    s_rng = np.arange(-shells, shells + 1)
    NX, NY = np.meshgrid(s_rng, s_rng, indexing="ij")
    ring = np.maximum(np.abs(NX), np.abs(NY)).reshape(-1)
    alpha_t, beta_t = rpy.tail_coeffs(shells)
    ring_w = np.where(ring == shells, alpha_t,
                      np.where(ring == shells - 1, beta_t, 0.0))
    shift = torch.as_tensor(np.stack([NX * gx * 1.0, NY * gy * 1.0],
                                     axis=-1).reshape(-1, 2),
                            dtype=dtype, device=dev)
    wts = 1.0 + torch.as_tensor(ring_w, dtype=dtype, device=dev)
    zero = torch.as_tensor(ring == 0, device=dev)
    acc = torch.zeros((nk, 3, 3, gz, gz, m, p3, p3), dtype=dtype, device=dev)
    nb = max(1, SHIFT_BATCH_ELEMS // (nk * gz * gz * m * p3 * p3))
    for s0 in range(0, len(ring), nb):
        sl = slice(s0, s0 + nb)
        dx = (dx0[None] + shift[sl, 0, None, None, None] * h[0])[:, None,
                                                                  None]
        dy = (dy0[None] + shift[sl, 1, None, None, None] * h[1])[:, None,
                                                                  None]
        keep = ~(zero[sl, None, None, None] & near0[None])
        w = (wts[sl, None, None, None] * keep.to(dtype))[..., None, None]
        r2 = dx * dx + dy * dy + dz * dz
        shape = r2.shape
        d_img = torch.stack([dx.expand(shape), dy.expand(shape),
                             rz.expand(shape)], dim=-1)
        if poly:
            parts, invR = _wall_coeffs_split(d_img, zj.expand(shape))
            k0, k2 = _free_split_coeffs(r2)
            chans = ((k0, parts[0]), (None, parts[1]), (None, parts[2]),
                     (k2, None))
        else:
            f1, f2, f3, f4, f5, invR = rpy._wall_coeffs(d_img,
                                                        zj.expand(shape))
            chans = ((rpy._free_coeffs(torch.clamp(r2, min=1e-2)),
                      (f1, f2, f3, f4, f5)),)
        e = (d_img * invR[..., None]).unbind(-1)
        del d_img
        for c, (free, wall) in enumerate(chans):
            _add_blocks(acc[c], w, (dx, dy, dz), e, free, wall)
    # (nk, 3_i, 3_j, gz_t, gz_s, gx, gy, n_t, n_s)
    #   → (nk, gz_t, gz_s, gx, gy, B, B)
    W = acc.reshape(nk, 3, 3, gz, gz, gx, gy, p3, p3).permute(
        0, 3, 4, 5, 6, 7, 1, 8, 2).reshape(nk, gz, gz, gx, gy, B, B)
    Kh = torch.fft.fft(torch.fft.rfft(W, dim=4), dim=3)
    # (nk, gz_t, gz_s, gx, gy//2+1, B, B) → (nk, gx·(gy//2+1), gz_t·B, gz_s·B)
    Kh = Kh.permute(0, 3, 4, 1, 5, 2, 6).reshape(
        nk, gx * (gy // 2 + 1), gz * B, gz * B)
    return Kh if poly else Kh[0]


# --------------------------------------------------------------- far part
def _p2m(W3, cid, Fs, ncell):
    """Anterpolate forces onto the cell nodes: Q (k, ncell, 3p³), column
    node·3 + component.

    Each cell's blobs are summed in blob order by a segmented reduction
    (as the JAX package's ``segment_sum``), not by atomic adds: on the card
    an ``index_add_`` sums in a varying order, and the RFD drift's 1/δ
    turned that roundoff into step differences of ~2e-3·max|ΔX| between
    runs; this way the far field repeats bitwise, like the kernels.  Q is
    returned contiguous: the film's FFTs read it through a view, and the
    FFT's rounding follows the strides it is given (a group's all-reduce
    returns a contiguous Q, so the distributed film at one rank would not
    be bitwise the single-device film otherwise)."""
    k, n = Fs.shape[0], Fs.shape[1]
    order = torch.argsort(cid, stable=True)
    prod = (W3[order, None, :, None]
            * Fs[:, order].transpose(0, 1)[:, :, None, :]).reshape(n, -1)
    Q = torch.segment_reduce(prod, "sum", axis=0, unsafe=True,
                             lengths=torch.bincount(cid, minlength=ncell))
    return Q.reshape(ncell, k, -1).transpose(0, 1).contiguous()


def _l2p(W3, cid, Unodes):
    """Interpolate node velocities (k, ncell, 3p³) back to the blobs with
    the spreading basis → (k, N, 3)."""
    k, n = Unodes.shape[0], W3.shape[0]
    local = Unodes[:, cid].reshape(k, n, W3.shape[1], 3)
    return torch.einsum("nq,knqx->knx", W3, local)


def _far_free(Qm, grid, khat):
    """Free-space far field on the nodes: 3-D FFT convolution over the
    cells, zero-padded to 2G per axis (half spectrum: K and Q are real).
    Qm (nm, k, ncell, B) moment channels: [F] with khat (nf, B, B), or
    (poly) [F, â²F] with khat [K₀, K₂] → (nout, k, ncell, B) output
    channels of weight [1] or [1, âᵢ²]:  U₀ = K₀*F + K₂*(â²F), U₂ = K₂*F."""
    gx, gy, gz = grid
    nm, k, _, B = Qm.shape
    Qg = torch.zeros((nm * k, 2 * gx, 2 * gy, 2 * gz, B), dtype=Qm.dtype,
                     device=Qm.device)
    Qg[:, :gx, :gy, :gz] = Qm.reshape(nm * k, gx, gy, gz, B)
    Qf = torch.fft.rfftn(Qg, dim=(1, 2, 3)).reshape(nm, k, -1, B).permute(
        0, 2, 3, 1)                                          # (nm, nf, B, k)
    if nm == 1:
        Uf = torch.matmul(khat, Qf[0])[None]
    else:
        K0, K2 = khat
        Uf = torch.stack([torch.matmul(K0, Qf[0]) + torch.matmul(K2, Qf[1]),
                          torch.matmul(K2, Qf[0])])
    nout = Uf.shape[0]
    Uhat = Uf.permute(0, 3, 1, 2).reshape(nout * k, 2 * gx, 2 * gy, gz + 1,
                                          B)
    Ug = torch.fft.irfftn(Uhat, s=(2 * gx, 2 * gy, 2 * gz), dim=(1, 2, 3))
    return Ug[:, :gx, :gy, :gz].reshape(nout, k, -1, B)


def _far_wall(Qm, grid, khat):
    """Wall-image far field on the nodes: gz² coupled 2-D x/y convolutions
    (y half spectrum).  Qm (nm, k, ncell, B) moment channels: [F] with
    khat (nf, gz·B, gz·B), or (poly) [F, âF, â²F], each against its own
    power lattice [G₀, G₁, G₂] → (nm, k, ncell, B) output channels of
    weight [1] or [1, âᵢ, âᵢ²]."""
    gx, gy, gz = grid
    nm, k, _, B = Qm.shape
    khat = khat if nm > 1 else khat[None]
    Qp = torch.zeros((nm * k, gz, 2 * gx, 2 * gy, B), dtype=Qm.dtype,
                     device=Qm.device)
    Qp[:, :, :gx, :gy] = Qm.reshape(nm * k, gx, gy, gz, B).permute(
        0, 3, 1, 2, 4)
    Qhat = torch.fft.rfftn(Qp, dim=(2, 3))      # (nm·k, gz, 2gx, gy+1, B)
    Qf = Qhat.reshape(nm, k, gz, -1, B).permute(0, 3, 2, 4, 1).reshape(
        nm, -1, gz * B, k)                                   # (nm, nf, gz·B, k)
    Uf = torch.matmul(khat, Qf)                              # (nm, nf, gz·B, k)
    Uhat = Uf.reshape(nm, 2 * gx, gy + 1, gz, B, k).permute(
        0, 5, 3, 1, 2, 4).reshape(nm * k, gz, 2 * gx, gy + 1, B)
    Ug = torch.fft.irfftn(Uhat, s=(2 * gx, 2 * gy), dim=(2, 3))
    return Ug[:, :, :gx, :gy].permute(0, 2, 3, 1, 4).reshape(nm, k, -1, B)


def _far_2p(Qm, grid, khat):
    """Pseudo-2D far field on the nodes: gz² coupled cyclic x/y
    convolutions at box size (no padding: the wrap is the periodicity; y
    half spectrum).  Qm (nm, k, ncell, B) moment channels: [F] with khat
    (nf, gz·B, gz·B), or (poly) [F, âF, â²F] with khat [A, G₁, G₂, K₂]
    (:func:`_kernel_hat_2p`) → (nout, k, ncell, B) output channels of
    weight [1] or [1, âᵢ², âᵢ]:  U₀ = A*F + K₂*(â²F), U₂ = G₂*(â²F) + K₂*F,
    U₁ = G₁*(âF)."""
    gx, gy, gz = grid
    nm, k, _, B = Qm.shape
    Qg = Qm.reshape(nm * k, gx, gy, gz, B).permute(0, 3, 1, 2, 4)
    Qhat = torch.fft.rfftn(Qg, dim=(2, 3))      # (nm·k, gz, gx, gy//2+1, B)
    Qf = Qhat.reshape(nm, k, gz, -1, B).permute(0, 3, 2, 4, 1).reshape(
        nm, -1, gz * B, k)                                   # (nm, nf, gz·B, k)
    if nm == 1:
        Uf = torch.matmul(khat, Qf[0])[None]
    else:
        A, G1, G2, K2 = khat
        Uf = torch.stack([
            torch.matmul(A, Qf[0]) + torch.matmul(K2, Qf[2]),
            torch.matmul(G2, Qf[2]) + torch.matmul(K2, Qf[0]),
            torch.matmul(G1, Qf[1])])
    nout = Uf.shape[0]
    Uhat = Uf.reshape(nout, gx, gy // 2 + 1, gz, B, k).permute(
        0, 5, 3, 1, 2, 4).reshape(nout * k, gz, gx, gy // 2 + 1, B)
    Ug = torch.fft.irfftn(Uhat, s=(gx, gy), dim=(2, 3))
    return Ug.permute(0, 2, 3, 1, 4).reshape(nout, k, -1, B)


def _interpolate(chans, W, cid, ahat):
    """Output channels (nout, k, ncell, B) on the nodes → (k, N, 3) blob
    velocities with the weights [1] (mono) or [1, âᵢ², âᵢ] (poly), shared
    by the FFT and band tiers."""
    nout, k, ncell = chans.shape[:3]
    n = W.shape[0]
    L = _l2p(W, cid, chans.reshape(nout * k, ncell, -1)).reshape(
        nout, k, n, 3)
    if ahat is None:
        return L[0]
    U = L[0] + (ahat * ahat)[None, :, None] * L[1]
    if nout == 3:
        U = U + ahat[None, :, None] * L[2]
    return U


def _open_channels(Un, Uw, poly):
    """The open domain's output channels from the free tier's [1, âᵢ²] and
    the wall tier's [1, âᵢ, âᵢ²] (or None): [1] mono, [1, âᵢ²(, âᵢ)]
    poly."""
    if Uw is None:
        return Un
    return torch.stack([Un[0] + Uw[0], Un[1] + Uw[2], Uw[1]]) if poly \
        else Un + Uw


def _far_part(Fs, W3, cid, grid, wall, khat_free, khat_wall, per=False,
              ahat=None, band=None, group=None):
    """Spread → kernel-lattice convolutions → interpolate: the far-tier
    velocities (k, N, 3) of the (damped) forces Fs (k, N, 3).  per: the
    pseudo-2D film, whose one combined lattice is ``khat_wall``.  ahat:
    None, or the (N,) radii in units of a: the â^m-weighted forces ride
    the spread and the FFTs as extra channels, [F, â²F] in the open domain
    without a wall, [F, âF, â²F] with the wall or in the film, and the
    output channels come back with weights [1, âᵢ², âᵢ].  band: None, or
    (W6, band_free, band_wall, plan) of the band tier (open domain only):
    the same moment channels spread at the band order and convolved over
    the band offsets (:func:`_band_apply_free`, :func:`_band_apply_wall`),
    ``plan`` the grid's :func:`_band_plan`.  group: the distributed
    apply's, over whose ranks the node moments (the FFT tier's and the
    band's) are summed, each rank spreading its own blobs."""
    k, n = Fs.shape[0], Fs.shape[1]
    poly = ahat is not None
    if not poly:
        scales = [None]
    elif wall or per:
        scales = [None, ahat, ahat * ahat]
    else:
        scales = [None, ahat * ahat]
    nm = len(scales)
    ncell = grid[0] * grid[1] * grid[2]
    Fm = torch.cat([Fs if c is None else Fs * c[None, :, None]
                    for c in scales])                        # (nm·k, N, 3)
    Q = _p2m(W3, cid, Fm, ncell)
    Q = collectives.psum(Q, group)
    Q = Q.reshape(nm, k, ncell, Q.shape[-1])
    if per:
        return _interpolate(_far_2p(Q, grid, khat_wall), W3, cid, ahat)
    free = [0, nm - 1] if poly else [0]
    Un = _far_free(Q[free], grid, khat_free)
    Uw = _far_wall(Q, grid, khat_wall) if wall else None
    U = _interpolate(_open_channels(Un, Uw, poly), W3, cid, ahat)
    if band is not None:
        W6, band_free, band_wall, plan = band
        (_, idx_f, ok_f), (_, idx_w, ok_w) = plan
        with profiling.span("far_band"):
            Qb = _p2m(W6, cid, Fm, ncell)
            Qb = collectives.psum(Qb, group)
            Qb = Qb.reshape(nm, k, ncell, Qb.shape[-1])
            Unb = _band_apply_free(band_free, Qb[free], grid, idx_f, ok_f)
            Uwb = (_band_apply_wall(band_wall, Qb, grid, idx_w, ok_w)
                   if wall else None)
            U = U + _interpolate(_open_channels(Unb, Uwb, poly), W6, cid,
                                 ahat)
    return U


# ------------------------------------------------------------- near part
def _near_neighbor_lists(ci_sorted, t, max_nbr, wrap_xy=None):
    """Tile adjacency from per-tile cell-index ranges (gap ≤ 1 on every
    axis), packed live-first: (t, max_nbr) int32 tile ids, −1 = empty, and
    a () bool tensor, True when some tile has more than max_nbr neighbors.

    wrap_xy: None, or the film's (gx, gy): tiles that touch across a box
    seam are neighbors too (the range gap tested at shifts −G, 0, +G; the
    ranges lie in [0, G), so one period each way covers every wrap).  The
    relation stays symmetric, and a tile pair adjacent both directly and
    across a seam is listed once."""
    ct = ci_sorted.reshape(t, TILE, 3)
    lo = ct.min(dim=1).values                                # (t, 3)
    hi = ct.max(dim=1).values

    def axis_ok(ax, g=None):
        l, h = lo[:, ax], hi[:, ax]
        ok = (l[:, None] - h[None, :] <= 1) & (l[None, :] - h[:, None] <= 1)
        for s in ((-g, g) if g is not None else ()):
            ok = ok | ((l[:, None] - (h[None, :] + s) <= 1)
                       & ((l[None, :] + s) - h[:, None] <= 1))
        return ok

    gx, gy = wrap_xy if wrap_xy is not None else (None, None)
    ok = axis_ok(0, gx) & axis_ok(1, gy) & axis_ok(2)
    cols = torch.arange(t, device=ci_sorted.device)
    key = torch.where(ok, cols, t + cols)
    packed = torch.sort(key, dim=1).values[:, :max_nbr]
    overflow = torch.any(ok.sum(dim=1) > max_nbr)
    return torch.where(packed < t, packed, -1).to(torch.int32), overflow


def auto_grid(n: int, p: int, wall: bool, poly: bool = False) -> int:
    """Density-targeted supercell count (cells of ~CELL_TARGET blobs),
    capped so the kernel lattices stay under KHAT_BUDGET bytes; ``poly``
    counts the radius-split lattices (two free, three wall)."""
    g = max(2, int(round((n / CELL_TARGET) ** (1.0 / 3.0))))
    b2 = (3 * p ** 3) ** 2
    while g > 2:
        # free-space half spectrum, z pairs × x/y half spectrum
        freqs = (2 if poly else 1) * 4 * g * g * (g + 1)
        if wall:
            freqs += (3 if poly else 1) * 2 * g ** 3 * (g + 1)
        if 8 * freqs * b2 <= KHAT_BUDGET:
            break
        g -= 1
    return g


def default_max_nbr(n: int, grid, p: int) -> int:
    """Neighbor-tile list width for the cell-snake order: a tile spans
    m ≈ TILE/per_cell + 1 snake cells, so its candidates live in a
    3×3×(m+3)-cell window, ≈ 9 + 36·per_cell/TILE tiles; 1.6× that + 8,
    at most t."""
    t = -(-n // TILE)
    per_cell = n / float(np.prod(grid))
    est = 9.0 + 36.0 * per_cell / TILE
    return int(min(t, np.ceil(1.6 * est) + 8))


def _chunk_rows(t: int, max_nbr: int, nrhs: int) -> int:
    """Row tiles per chunk of the plain near sweep: the largest divisor of
    t whose pair temporaries fit a 96 MiB budget."""
    budget = 96 * 2**20
    per_tile = max_nbr * TILE * TILE * 4 * (8 + 3 * nrhs)
    best = 1
    for d in range(1, t + 1):
        if t % d == 0 and d * per_tile <= budget:
            best = d
    return best


def _near_sweep(x_s, ci_s, id_s, F_s, nbr, wall, h_floor, box_n=None,
                wrap_xy=None, ah_s=None, t0=0, nt=None):
    """Exact adjacent-cell pair sweep — the plain PyTorch version of K3
    and, with ``t0`` / ``nt``, of its row-tile slice.

    x_s/ci_s/id_s (t·TILE, …) sorted padded positions (units of a), cell
    indices and blob ids (−1 = pad); F_s (k, t·TILE, 3); nbr (t, max_nbr)
    neighbor-tile lists (−1 = empty).  Returns (k, t·TILE, 3) pair
    velocities in sorted order: no self term, scaling or damping.  Only
    the slot columns that some tile uses are swept (an empty slot adds
    nothing).  box_n / wrap_xy: the film's (Lx, Ly) in units of a and (gx,
    gy): displacements wrapped by :func:`.rpy.wrapped_difference` (the
    image K3's box form takes), cell offsets wrapped cyclically before the
    adjacency test, the wall images on the wrapped dx, dy.  ah_s: None, or
    the (t·TILE,) sorted radii in units of a (pads 1): the polydisperse
    fields (:func:`.rpy._free_coeffs_poly`), the wall terms in units of
    √(aᵢaⱼ) with the scaled heights floored per pair (K3's POLY form).
    t0 / nt: the rows of tiles [t0, t0 + nt) alone (default all t), the
    distributed apply's slice; returns (k, nt·TILE, 3).
    """
    t = nbr.shape[0]
    k = F_s.shape[0]
    nt = t - t0 if nt is None else nt
    used = torch.nonzero((nbr >= 0).any(dim=0))
    width = int(used.max()) + 1 if used.numel() else 0
    nbr = nbr[:, :width].long()
    nbr_ix = torch.clamp(nbr, min=0)
    ch = _chunk_rows(nt, max(width, 1), k)
    xt = x_s.reshape(t, TILE, 3)
    ct = ci_s.reshape(t, TILE, 3)
    it = id_s.reshape(t, TILE)
    Ft = F_s.reshape(k, t, TILE, 3)
    at = None if ah_s is None else ah_s.to(x_s.dtype).reshape(t, TILE)
    outs = []
    for c0 in range(t0, t0 + nt, ch):
        rows_x, rows_c = xt[c0:c0 + ch], ct[c0:c0 + ch]
        rows_id = it[c0:c0 + ch]
        nb = nbr_ix[c0:c0 + ch]
        cols_x = xt[nb].reshape(ch, width * TILE, 3)
        cols_c = ct[nb].reshape(ch, width * TILE, 3)
        cols_id = torch.where((nbr[c0:c0 + ch] >= 0)[..., None], it[nb],
                              -1).reshape(ch, width * TILE)
        cols_F = Ft[:, nb].permute(1, 0, 2, 3, 4).reshape(
            ch, k, width * TILE, 3)

        d = rpy.wrapped_difference(rows_x[:, :, None, :],
                                   cols_x[:, None, :, :], box_n)
        dc = rows_c[:, :, None, :] - cols_c[:, None, :, :]
        for ax, g in enumerate(wrap_xy or ()):
            dc[..., ax] = torch.remainder(dc[..., ax] + g // 2, g) - g // 2
        r2 = torch.sum(d * d, dim=-1)
        keep = (torch.all(dc.abs() <= 1, dim=-1)
                & (cols_id[:, None, :] >= 0)
                & (rows_id[:, :, None] != cols_id[:, None, :]))
        r2 = torch.where(keep, r2, torch.full_like(r2, 16.0))
        if at is None:
            alpha, beta = rpy._free_coeffs(r2)
        else:
            rows_a = at[c0:c0 + ch][:, :, None]
            cols_a = at[nb].reshape(ch, 1, width * TILE)
            alpha, beta = rpy._free_coeffs_poly(r2, rows_a, cols_a)
        zero = torch.zeros_like(alpha)
        alpha = torch.where(keep, alpha, zero)
        beta = torch.where(keep, beta, zero)
        dF = torch.einsum("cpnx,cknx->ckpn", d, cols_F)
        out = (torch.einsum("cpn,cknx->ckpx", alpha, cols_F)
               + torch.einsum("ckpn,cpn,cpnx->ckpx", dF, beta, d))
        if wall:
            zi, zj = rows_x[:, :, 2, None], cols_x[:, None, :, 2]
            dxy = d[..., :2]
            if at is not None:
                # in units of a_eff = √(aᵢaⱼ), the fields scaled by 1/a_eff
                inv_ae = 1.0 / torch.sqrt(rows_a * cols_a)
                zi, zj, dxy = zi * inv_ae, zj * inv_ae, dxy * inv_ae[..., None]
            if h_floor > 0:
                zi = torch.clamp(zi, min=h_floor)
                zj = torch.clamp(zj, min=h_floor)
            rz = zi + zj
            d_img = torch.cat([dxy, rz[..., None]], dim=-1)
            f1, f2, f3, f4, f5, invR = rpy._wall_coeffs(d_img,
                                                        zj.expand(rz.shape))
            if at is not None:
                f1, f2, f3, f4, f5 = (f * inv_ae for f in (f1, f2, f3, f4, f5))
            f1, f2, f3, f4, f5 = (torch.where(keep, f, zero)
                                  for f in (f1, f2, f3, f4, f5))
            e = d_img * invR[..., None]
            eF = torch.einsum("cpnx,cknx->ckpn", e, cols_F)
            Fz = cols_F[:, :, :, 2]
            out = out + torch.einsum("cpn,cknx->ckpx", f1, cols_F)
            out = out + torch.einsum("ckpn,cpn,cpnx->ckpx", eF, f2, e)
            out = out + torch.einsum("cpn,ckn,cpnx->ckpx", f3, Fz, e)
            z_part = (torch.einsum("cpn,ckpn->ckp", f4, eF)
                      + torch.einsum("cpn,ckn->ckp", f5, Fz))
            out = out + torch.stack([torch.zeros_like(z_part),
                                     torch.zeros_like(z_part), z_part],
                                    dim=-1)
        outs.append(out)                                     # (ch, k, TILE, 3)
    return torch.cat(outs).permute(1, 0, 2, 3).reshape(k, nt * TILE, 3)


# --------------------------------------------------------------- top level
class FarCtx(NamedTuple):
    """Position-dependent setup of the proxy-grid operator, built once per
    Krylov or Lanczos loop (:func:`rigid_body_light_tpu_torch.ops.saddle.
    hoist_positions`).

    Two tiers:
      geometry (lo, h, khat_*): depends on the positions only through the
        bounding box, so nearby position sets (RFD displacements, the
        midpoint half-kick) share it through ``prepare(r, geo=...)``.
      position structures (the rest): exact for the ``r`` that built them;
        one argsort, an O(t²) tile adjacency and K3's tile-pair list.
    In the film (a 2-D ``box``) the positions are wrapped into the box
    before binning, ``khat_free`` is None and ``khat_wall`` holds the
    combined lattice.  With per-blob radii the lattices carry a leading
    channel axis (2 free, 3 wall, 4 film) and ``ahat`` / ``ah_s`` hold the
    radii; the geometry tier depends on whether there are radii, not on
    their values.  With the band tier (``band_p``), ``band_free`` /
    ``band_wall`` hold its blocks (geometry tier) and ``W6`` its spread
    weights; else all three are None.
    """
    lo: torch.Tensor                  # (3,) grid origin, units of a
    h: torch.Tensor                   # (3,) cell sizes, units of a
    khat_free: Optional[torch.Tensor]  # ([nk,] nf, B, B) free-space lattice
    khat_wall: Optional[torch.Tensor]  # ([nk,] nf_xy, gz·B, gz·B), or None
    b: Optional[torch.Tensor]         # (N,) damping factors, or None
    cid: torch.Tensor                 # (N,) flat cell ids
    W3: torch.Tensor                  # (N, p³) spread/interp weights
    self_diag: torch.Tensor           # (N, 3) self-mobility diagonal
    order: torch.Tensor               # (N,) cell-snake sort permutation
    x_s: torch.Tensor                 # (t·TILE, 3) sorted padded positions
    ci_s: torch.Tensor                # (t·TILE, 3) sorted padded cells
    id_s: torch.Tensor                # (t·TILE,) sorted blob ids (−1 pad)
    nbr: torch.Tensor                 # (t, max_nbr) neighbor-tile lists
    pairs: torch.Tensor               # (t·max_nbr, 4) K3's tile-pair list
    n_pairs: torch.Tensor             # (1,) int32: its used length
    overflow: torch.Tensor            # () bool: poison the apply
    ahat: Optional[torch.Tensor] = None  # (N,) radii / a, or None (mono)
    ah_s: Optional[torch.Tensor] = None  # (t·TILE,) sorted, pads 1, or None
    W6: Optional[torch.Tensor] = None    # (N, band_p³) band spread weights
    band_free: Optional[torch.Tensor] = None  # (nk, n_off, B6, B6)
    band_wall: Optional[torch.Tensor] = None  # (nk, n_oxy, gz·B6, gz·B6)
    n_boundary: Optional[torch.Tensor] = None  # (1,) int32: the slice's
    #   pairs with one tile outside it (distributed context only)


class FarGeo(NamedTuple):
    """The geometry tier of a :class:`FarCtx` alone: what
    :func:`rigid_body_light_tpu_torch.ops.saddle.pin_geometry` shares
    across a step's position sets."""
    lo: torch.Tensor
    h: torch.Tensor
    khat_free: Optional[torch.Tensor]
    khat_wall: Optional[torch.Tensor]
    band_free: Optional[torch.Tensor] = None
    band_wall: Optional[torch.Tensor] = None


def _check_band(band_p, per):
    """The band tier's order (the JAX package's rules and messages): 0 is
    off, otherwise at least 3; the film's image-summed cyclic lattices
    take no band."""
    band_p = int(band_p)
    if band_p == 0:
        return 0
    if band_p < 3:
        raise ValueError(f"farfield_band_p must be 0 (off) or >= 3, got "
                         f"{band_p}")
    if per:
        raise ValueError(
            "farfield_band_p does not compose with the pseudo-2D (2-D "
            "box) far field yet — its lattices are cyclic/image-summed; "
            "use image_shells for accuracy there")
    return band_p


def _check_2p(wall, box, grid, shells):
    """Validate a pseudo-2D far-field request (the JAX package's rules and
    messages): a positive (Lx, Ly) box, image_shells ≥ 1, the wall, and at
    least 4 cells on each periodic axis."""
    try:
        if len(box) != 2:
            raise ValueError
        lx, ly = (float(box[0]), float(box[1]))
    except (TypeError, ValueError, IndexError) as e:
        raise ValueError(
            f"box must be a (Lx, Ly) pair of in-plane periods, got {box!r}"
        ) from e
    if not (lx > 0 and ly > 0):
        raise ValueError(f"box periods must be positive, got {box!r}")
    if shells < 1:
        raise ValueError(
            "the pseudo-2D far field needs image_shells ≥ 1: the cyclic "
            "kernel lattice picks one signed representative per cell "
            "offset, so with no image sum pairs near the half-box seam are "
            "evaluated at the wrong-side image (use farfield_grid=None for "
            "the minimum image, or S ≥ 1 for the exact doubly-periodic "
            "operator; S=6 ≈ 1e-4 with the tail extrapolation)")
    if not wall:
        raise ValueError(
            "the doubly-periodic far field needs wall=True — the free-space "
            "Stokeslet's in-plane lattice sum diverges; only the wall-"
            "screened (1/ρ³) combined kernel is summable")
    if grid[0] < 4 or grid[1] < 4:
        # a correctness bound: adjacent-cell pairs span node displacements
        # up to 2h; the near sweep takes the per-pair minimum image and the
        # lattice excludes the n = 0 term of the signed representative, and
        # the two agree only while 2h ≤ box/2
        raise ValueError(
            f"pseudo-2D far field needs ≥ 4 cells per periodic axis "
            f"(minimum-image/representative agreement for adjacent-cell "
            f"pairs), got {grid}")


def _geometry_2p(x, grid, box_n, group=None):
    """Pseudo-2D grid geometry: x/y anchored at 0 with h·G = box (the cyclic
    convolution is the periodicity), z from the positions' bounds (over the
    ranks of ``group``: MIN / MAX all-reduces)."""
    z_lo = collectives.pmin(x[:, 2].min(), group)
    z_hi = collectives.pmax(x[:, 2].max(), group)
    span = torch.clamp(z_hi - z_lo, min=1e-6) * (1.0 + 1e-5)
    lo = torch.zeros(3, dtype=x.dtype, device=x.device)
    lo[2] = z_lo
    h = torch.tensor([box_n[0] / grid[0], box_n[1] / grid[1], 0.0],
                     dtype=x.dtype, device=x.device)
    h[2] = span / grid[2]
    return lo, h


def _wrap_box(x, box_n):
    """Wrap positions (units of a) into the 2-D box, x − L·⌊x/L⌋ in x and
    y: trajectories keep unwrapped coordinates, the grid and the pairs see
    box coordinates (z stays open: the wall geometry)."""
    L = torch.tensor(box_n, dtype=x.dtype, device=x.device)
    xy = x[:, :2]
    return torch.cat([xy - L * torch.floor(xy / L), x[:, 2:]], dim=1)


def _resolve(n, wall, grid, p, max_nbr, poly=False):
    if grid is None:
        grid = auto_grid(n, p, wall, poly)
    if np.isscalar(grid):
        grid = (int(grid),) * 3
    grid = tuple(int(g) for g in grid)
    if max_nbr is None:
        max_nbr = default_max_nbr(n, grid, p)
    return grid, max_nbr



def _resolve_local(n, wall, grid, p, max_nbr, poly, n_ranks):
    """The shapes of the apply over ``n_ranks`` ranks (1: one device):
    grid, the neighbor-list width (widened so the isolated pad tiles
    cannot overflow it), the real and the rank-padded tile counts (the JAX
    package's ``_resolve_local``).  At one rank the width is
    :func:`_resolve`'s, capped at the tile count, which the lists never
    exceed."""
    grid, max_nbr = _resolve(n, wall, grid, p, max_nbr, poly)
    t = -(-n // TILE)
    t_pad = -(-t // n_ranks) * n_ranks
    # the whole pad tiles share one isolated cell, so each neighbors all of
    # them: widen the list to cover them (their rows are masked, but an
    # overflow there would poison the whole apply)
    max_nbr = min(t_pad, max(max_nbr, t_pad - t + 1))
    return grid, max_nbr, t, t_pad


def sorted_tiles(x, ci, grid, t_pad, max_nbr, ahat=None, wrap_xy=None):
    """The sorted tiles of all the blobs, padded to ``t_pad`` tiles (the
    tile count, or its multiple of the ranks): (order, x_s, ci_s, id_s,
    ah_s, nbr, overflow) of :class:`FarCtx`.  The partial last tile is
    padded with the last sorted entry: its cell is the tile's final real
    cell, so the tile's cell range (and the neighbor lists) stay as tight
    as without padding.  The whole pad tiles sit at an isolated cell
    outside the grid, so they neighbor only each other (the list width
    must cover them: :func:`_resolve_local`).  x (N, 3) in units of a, ci
    (N, 3) their cells, ahat (N,) radii or None; wrap_xy: the film's
    cyclic neighbor lists."""
    n, dev = x.shape[0], x.device
    t = -(-n // TILE)
    order = tiles.cell_snake_order(ci, grid)
    pad = t_pad * TILE - n
    pad_part = min(pad, t * TILE - n)
    last = order[-1:]
    iso = torch.as_tensor(grid, dtype=ci.dtype, device=dev) + 2
    x_s = torch.cat([x[order], x[last].expand(pad, 3)])
    ci_s = torch.cat([ci[order], ci[last].expand(pad_part, 3),
                      iso.expand(pad - pad_part, 3)])
    id_s = torch.cat([order.to(torch.int32),
                      torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    # pad radii 1: the pads are masked, but a 0 would divide by zero in the
    # pair fields before the select
    ah_s = (None if ahat is None else
            torch.cat([ahat[order], torch.ones(pad, dtype=ahat.dtype,
                                               device=dev)]))
    nbr, overflow = _near_neighbor_lists(ci_s, t_pad, max_nbr,
                                         wrap_xy=wrap_xy)
    return order, x_s, ci_s, id_s, ah_s, nbr, overflow


def _build_geometry(x, grid, p, wall, h_floor, box_n, image_shells, poly,
                    band_p=0, group=None):
    if box_n is not None:
        lo, h = _geometry_2p(x, grid, box_n, group)
        return FarGeo(lo=lo, h=h, khat_free=None, khat_wall=_kernel_hat_2p(
            lo[2], h, grid, p, h_floor, int(image_shells), poly=poly))
    ne = _BAND_MAX if band_p else 1
    lo, h = _grid_geometry(x, grid, group)
    khat_free = _far_kernel_hat(h, grid, p, poly=poly, near_excl=ne)
    khat_wall = (_wall_kernel_hat(lo[2], h, grid, p, h_floor, poly=poly,
                                  near_excl=ne)
                 if wall else None)
    band_free = band_wall = None
    if band_p:
        (off_f, _, _), (off_w, _, _) = _band_plan(grid, x.device)
        band_free = _band_blocks_free(h, band_p, poly=poly, offsets=off_f)
        band_wall = (_band_blocks_wall(lo[2], h, grid, band_p, h_floor,
                                       poly=poly, offsets=off_w)
                     if wall else None)
    return FarGeo(lo=lo, h=h, khat_free=khat_free, khat_wall=khat_wall,
                  band_free=band_free, band_wall=band_wall)


def prepare_geometry(r, a=1.0, eta=1.0, wall=False, grid=None, p=4,
                     max_nbr=None, h_floor=rpy.WALL_H_FLOOR, box=None,
                     image_shells=8, radii=None, band_p=0, group=None):
    """Build only the geometry tier (:class:`FarGeo`) for positions ``r``;
    pass it as ``geo=`` to :func:`prepare` to share one kernel-lattice
    build across several nearby position sets.

    box: None (open domain) or the film's (Lx, Ly): the cyclic x/y
    convolution with the combined lattice summed over the in-plane images
    to ``image_shells`` with the two-ring tail (:func:`_kernel_hat_2p`).
    radii: None, or per-blob radii: the radius-split lattices (their
    values do not enter the geometry tier).  band_p: the band tier's order
    (0: off), whose blocks belong to this tier.  group: as
    :func:`prepare`'s; the bounding box closes over it (MIN / MAX
    all-reduces), and every rank builds the same lattices and blocks."""
    r = r.reshape(-1, 3)
    poly = radii is not None
    grid, _ = _resolve(r.shape[0] * collectives.size(group), wall, grid, p,
                       max_nbr, poly)
    if box is not None:
        _check_2p(wall, box, grid, int(image_shells))
    band_p = _check_band(band_p, box is not None)
    return _build_geometry(r * (1.0 / a), grid, p, wall, h_floor,
                           rpy._box_n(box, a), image_shells, poly, band_p,
                           group=group)


def prepare(r, a=1.0, eta=1.0, wall=False, grid=None, p=4, max_nbr=None,
            h_floor=rpy.WALL_H_FLOOR, geo: FarGeo = None, box=None,
            image_shells=8, radii=None, band_p=0, group=None):
    """Build the :class:`FarCtx` for positions ``r`` (same keywords as
    :func:`mobility_apply`).

    geo: reuse a geometry tier (lo, h, kernel lattices) built for nearby
    positions.  It stays valid while the positions stay within about a cell
    fraction of the box that built it; past half a cell the apply is
    NaN-poisoned, like a neighbor-list overflow, so the stepper's rejection
    path sees it instead of a silently extrapolated basis.  In the film the
    positions wrap in x/y and never leave the grid there: z alone is
    guarded.

    group: None (one device), or the process group of a distributed apply
    (the JAX package's ``prepare_local``): ``r`` and ``radii`` are this
    rank's blobs, every rank holding as many, in rank order.  The
    bounding box and the excursion guard close over the group; the sorted
    tiles come from one gather of the positions and cells, their count
    rounded up to a multiple of the group's size by whole pad tiles
    (:func:`sorted_tiles`); K3's work list is this rank's equal slice's
    (:func:`.tiles.slice_pairs`), ``n_boundary`` its pairs that cross the
    slice's edge.
    """
    r = r.reshape(-1, 3)
    n_l = r.shape[0]
    D, rank = collectives.size(group), collectives.rank(group)
    dtype = r.dtype
    poly = radii is not None
    grid, max_nbr, _, t_pad = _resolve_local(n_l * D, wall, grid, p, max_nbr,
                                             poly, D)
    box_n = rpy._box_n(box, a)
    if box is not None:
        _check_2p(wall, box, grid, int(image_shells))
    band_p = _check_band(band_p, box is not None)
    if poly:
        radii = radii.reshape(-1).to(dtype)
    ahat = radii * (1.0 / a) if poly else None
    b = rpy.damping_factors(r, a, radii) if wall else None
    x = r * (1.0 / a)                                        # units of a
    if box_n is not None:
        x = _wrap_box(x, box_n)
    geo_bad = None
    if geo is not None:
        u = (x - geo.lo) / geo.h
        hi = torch.as_tensor(grid, dtype=dtype, device=r.device)
        if box_n is not None:
            u, hi = u[:, 2], hi[2]
        excursion = torch.maximum(torch.max(-u), torch.max(u - hi))
        geo_bad = collectives.pmax(excursion, group) > 0.5
    else:
        geo = _build_geometry(x, grid, p, wall, h_floor, box_n, image_shells,
                              poly, band_p, group=group)
    lo, h = geo.lo, geo.h
    ci, cid = _cell_indices(x, lo, h, grid)
    t3 = (x - lo) / h - ci.to(dtype)
    W3 = _blob_weights(t3, _cheb_nodes(p))
    W6 = _blob_weights(t3, _cheb_nodes(band_p)) if band_p else None

    order, x_s, ci_s, id_s, ah_s, nbr, overflow = sorted_tiles(
        collectives.all_gather(x, group), collectives.all_gather(ci, group),
        grid, t_pad, max_nbr,
        ahat=None if ahat is None else collectives.all_gather(ahat, group),
        wrap_xy=grid[:2] if box_n is not None else None)
    pairs, n_pairs = tiles.tile_pairs(nbr)
    n_boundary = None
    if group is not None:
        nt = t_pad // D
        pairs, n_pairs, n_boundary = tiles.slice_pairs(pairs, n_pairs,
                                                       rank * nt, nt)
    if geo_bad is not None:
        overflow = overflow | geo_bad
    return FarCtx(lo=lo, h=h, khat_free=geo.khat_free,
                  khat_wall=geo.khat_wall, b=b, cid=cid, W3=W3,
                  self_diag=rpy._self_diag(r, a, wall, h_floor, radii),
                  order=order, x_s=x_s, ci_s=ci_s, id_s=id_s, nbr=nbr,
                  pairs=pairs, n_pairs=n_pairs, overflow=overflow,
                  ahat=ahat, ah_s=ah_s, W6=W6, band_free=geo.band_free,
                  band_wall=geo.band_wall, n_boundary=n_boundary)


def mobility_apply(F, r, a=1.0, eta=1.0, wall=False, grid=None, p=4,
                   max_nbr=None, h_floor=rpy.WALL_H_FLOOR,
                   ctx: FarCtx = None, use_pallas=True, box=None,
                   image_shells=8, radii=None, band_p=0, group=None):
    """U = M(r)·F by the exact near part plus the proxy-grid far field.

    F: (N, 3) or (k, N, 3); r: (N, 3).  grid: int or (gx, gy, gz)
    supercells (None: :func:`auto_grid`; flat wall slabs want a small gz);
    p: Chebyshev nodes per axis.  Same normalization as
    :func:`rigid_body_light_tpu_torch.ops.rpy.mobility_apply`: self term
    included; ``wall`` adds the Swan–Brady correction (near pairs exact,
    far pairs through the image lattices) and the B·M·B damping.

    box: None, or the film's (Lx, Ly): the pseudo-2D doubly periodic wall
    operator, O(N) an apply at Chebyshev-p and image-tail accuracy (the
    exact image sum, ``rpy.mobility_apply(image_shells=...)``, is
    O((2S+1)²·N²)); needs wall=True, image_shells ≥ 1 and ≥ 4 cells on x
    and y.

    radii: None, or (N,) per-blob physical radii: the polydisperse
    operator (the radius-split lattices, K3's POLY form for the near
    pairs, the self term (4/3)·a/aᵢ plus the wall's at aᵢ, damping at
    z/aᵢ), the convention of ``rpy.mobility_apply(radii=...)``.

    band_p: 0, or the band tier's order (≥ 3; open domain only): cell
    offsets of ∞-norm 2.._BAND_MAX at that order through the band blocks,
    the FFT tier beyond.

    ctx: a :func:`prepare` result for this ``r`` (same keywords), so
    repeated applies at fixed positions build the lattices and the tile
    structures once.  use_pallas (the configuration's name for the
    hand-written kernels): float32 with k ≤ 2 sweeps the near part through
    K3 (:func:`.farfield_cuda.near_sweep`, its plain version on a CPU
    tensor); otherwise the plain :func:`_near_sweep`.

    group: None (one device), or the process group of a distributed apply
    (the JAX package's ``mobility_apply_local``): ``F``, ``r`` and
    ``radii`` are this rank's blobs and U this rank's rows.  The far tier
    spreads this rank's blobs, sums the node moments (the band tier's too)
    over the group and convolves on every rank alike; the near part
    gathers the forces once, sweeps this rank's slice of the sorted tiles
    (K3's row-tile slice, ``t0`` / ``nt``; the film's box form with its
    cyclic lists) and gathers the slices back.
    """
    r = r.reshape(-1, 3)
    multi = F.dim() == 3
    Fs = F.to(r.dtype)
    Fs = Fs if multi else Fs[None]
    k, n_l = Fs.shape[0], r.shape[0]
    D, rank = collectives.size(group), collectives.rank(group)
    n = n_l * D
    dtype = r.dtype
    grid, max_nbr, _, t_pad = _resolve_local(n, wall, grid, p, max_nbr,
                                             radii is not None, D)
    per = box is not None
    if per:
        _check_2p(wall, box, grid, int(image_shells))
    band_p = _check_band(band_p, per)
    if ctx is None:
        ctx = prepare(r, a=a, eta=eta, wall=wall, grid=grid, p=p,
                      max_nbr=max_nbr, h_floor=h_floor, box=box,
                      image_shells=image_shells, radii=radii, band_p=band_p,
                      group=group)
    band = None
    if band_p:
        if ctx.W6 is None or ctx.W6.shape[1] != band_p ** 3:
            raise ValueError(f"ctx was not prepared with band_p={band_p}")
        band = (ctx.W6, ctx.band_free, ctx.band_wall,
                _band_plan(grid, r.device))
    if wall:
        Fs = Fs * ctx.b[None, :, None]
    U_far = _far_part(Fs, ctx.W3, ctx.cid, grid, wall, ctx.khat_free,
                      ctx.khat_wall, per=per, ahat=ctx.ahat, band=band,
                      group=group)

    F_s = torch.cat([collectives.all_gather(Fs, group, dim=1)[:, ctx.order],
                     torch.zeros((k, t_pad * TILE - n, 3), dtype=dtype,
                                 device=r.device)], dim=1)
    box_n = rpy._box_n(box, a)
    wrap_xy = grid[:2] if per else None
    # this rank's slice of the sorted tiles; one device sweeps them all
    sl = ({} if group is None else
          dict(t0=rank * (t_pad // D), nt=t_pad // D))
    if use_pallas and dtype == torch.float32 and k <= 2:
        U_near_s = farfield_cuda.near_sweep(
            ctx.x_s, ctx.ci_s, ctx.id_s >= 0, F_s, ctx.nbr, wall, h_floor,
            pairs=(ctx.pairs, ctx.n_pairs), box_over_a=box_n,
            wrap_cells=wrap_xy, ahat_s=ctx.ah_s, **sl)
    else:
        U_near_s = _near_sweep(ctx.x_s, ctx.ci_s, ctx.id_s, F_s, ctx.nbr,
                               wall, h_floor, box_n=box_n, wrap_xy=wrap_xy,
                               ah_s=ctx.ah_s, **sl)
    U_sorted = collectives.all_gather(U_near_s.to(dtype), group, dim=1)
    U_near = torch.zeros((k, n, 3), dtype=dtype, device=r.device)
    U_near[:, ctx.order] = U_sorted[:, :n]
    U_near = U_near[:, rank * n_l:(rank + 1) * n_l]
    U_near = torch.where(ctx.overflow, torch.full_like(U_near, math.nan),
                         U_near)

    U = U_near + U_far + ctx.self_diag * Fs
    if wall:
        U = U * ctx.b[None, :, None]
    U = U * (1.0 / (8.0 * math.pi * eta * a))
    return U if multi else U[0]


# ------------------------------------------------------------- distributed
# the JAX package's names of the distributed apply: the functions above
# over a process group
def prepare_geometry_local(r_l, group, radii_l=None, **kw):
    """:func:`prepare_geometry` over ``group`` (``radii_l``: this rank's
    radii)."""
    return prepare_geometry(r_l, radii=radii_l, group=group, **kw)


def prepare_local(r_l, group, radii_l=None, **kw):
    """:func:`prepare` over ``group`` (``radii_l``: this rank's radii)."""
    return prepare(r_l, radii=radii_l, group=group, **kw)


def mobility_apply_local(F_l, r_l, group, radii_l=None, **kw):
    """:func:`mobility_apply` over ``group``: this rank's rows
    (``radii_l``: this rank's radii)."""
    return mobility_apply(F_l, r_l, radii=radii_l, group=group, **kw)
