"""Wrapper of the hand-written CUDA Ewald real-space sweep K4 — the port
of ``rigid_body_light_tpu/ops/ewald_pallas.py`` (its ``real_pair_sum``,
``mobility_apply`` and ``mobility_apply_multi`` contract).

Kernel (``csrc/ewald_real_sweep.cu``, built for sm_90a at first use by
:mod:`.cuda_build`):

  K4 ``ewald_real_sweep``  replaces ``ewald_pallas._kernel_ewald_sym``:
                           Σ_{j≠i} [A(r)·I + B(r)·r̂r̂]·F_j under 3-D
                           minimum image, each unordered pair's A, B once
                           (Clenshaw on the host-fitted Chebyshev
                           representation, never the closed forms), applied
                           forward and transposed.  1 or 2 RHS.
  its slab form            ``ewald_real_slab``: the same pair terms as an
                           ordered rows × columns sweep at global offsets,
                           the pair of equal global ids left out — the
                           distributed ring's off-diagonal blocks
                           (:func:`real_pair_sum_slab`; the JAX package
                           sweeps them in plain XLA, ``ewald.py:788``).

  K4 tiles ``ewald_real_tiles``  the balanced split's cutoff sweep over
                           sorted neighbor tiles (:func:`tile_pair_sum`,
                           ``ewald_cells._cell_sweep``'s contract, mono
                           and POLY): it replaces no Pallas kernel but the
                           JAX package's plain-XLA ``_cell_sweep``
                           (``ewald_cells.py:122``).  A symmetric sweep
                           over the unordered neighbor-tile pairs that
                           :func:`tile_list` lists on the card (K3's list,
                           :func:`.tiles.tile_pairs`): each kept pair's
                           fields once, applied to both blobs.

K4 and its slab form are monodisperse float32, classic split only: the
balanced split (``rc``) takes K4 tiles, and per-blob radii without ``rc``
the plain PyTorch operator (:mod:`.ewald`), as the JAX package's dispatch
skips its Pallas kernel for them.  :func:`real_pair_sum` takes the
plain PyTorch sweep (:func:`rigid_body_light_tpu_torch.ops.ewald.
real_space_apply`) for a tensor on the CPU, and launches the kernel or
raises for a CUDA tensor — there is no fallback.  Like the Pallas wrapper,
inputs are cast to float32; the kernel itself refuses anything else.

The kernel sweeps 128 × 128 tile pairs of the upper triangle
(:func:`sweep_items` lists them), a block walking the items of one pair
of tile groups (:func:`.tiles.group_items`; one item a block up to 65,536
blobs) into O(n) partials (:func:`.tiles.partial_shape`); it replaced a
grid of 128-row × 512-column blocks that at the periodic slice formed one
uneven wave of blocks (4.5–5.2× its bound, PERF.md §6).  The slab form
runs blocks of 128 rows (four a lane, their Clenshaw chains side by side)
× 32 columns into one partial a column chunk (:func:`slab_partial_shape`),
summed in order by a second pass; it replaced 64 × 256 blocks that gave
the D = 4 ring's block 451 blocks for 132 SMs.

Every launch carries its own constants and coefficient table, so
operators with different boxes can be alive at once.  Both are built once
per operator (``params``) and kept: the table on the device, the constants
on the host as the launch's by-value argument (:func:`operator_tables`),
so a launch does no host arithmetic and no host→device copy.  Not
differentiable (neither is the Pallas kernel): a CUDA tensor that requires
grad raises (:func:`.cuda_build.refuse_grad`).

``sweep_launches``, ``slab_launches`` and ``tile_launches`` count kernel
launches (incremented where a kernel is launched, nowhere else) so a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from rigid_body_light_tpu_torch.ops import cuda_build, ewald, tiles
from rigid_body_light_tpu_torch.utils import profiling

TILE = 128  # rows and columns of a work item; build() checks the kernel's
SLAB_ROWS, SLAB_CHUNK = 128, 32  # the slab form's block; build() checks
TILE_ROWS = tiles.TILE  # K4 tiles' tile; build() checks the kernel's
TILE_TABLE_BYTES = 196608  # K4 tiles' shared fit table; build() checks
sweep_launches = 0
slab_launches = 0
tile_launches = 0

_lib = None
_F32_MAX = float(np.finfo(np.float32).max)


def reset_launch_counts():
    global sweep_launches, slab_launches, tile_launches
    sweep_launches = slab_launches = tile_launches = 0


def launch_counts():
    return {"ewald_real_sweep": sweep_launches,
            "ewald_real_slab": slab_launches,
            "ewald_real_tiles": tile_launches}


def build():
    """Compile ``csrc/ewald_real_sweep.cu`` (if its build is not current)
    and load it.  Returns the ``ctypes`` library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load("ewald_real_sweep")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ewald_sweep_tile, lib.ewald_sweep_max_degree,
               lib.ewald_sweep_max_groups, lib.ewald_slab_rows,
               lib.ewald_slab_chunk, lib.ewald_tile_rows,
               lib.ewald_tile_table_capacity):
        fn.restype = i
        fn.argtypes = []
    if lib.ewald_sweep_tile() != TILE:
        raise RuntimeError(f"ewald_real_sweep.cu tiles {lib.ewald_sweep_tile()}"
                           f" blobs, the wrapper {TILE}")
    if lib.ewald_sweep_max_groups() != tiles.MAX_GROUPS:
        raise RuntimeError(f"ewald_real_sweep.cu groups at most "
                           f"{lib.ewald_sweep_max_groups()} tile groups, the "
                           f"wrapper {tiles.MAX_GROUPS}")
    if (lib.ewald_slab_rows(), lib.ewald_slab_chunk()) != (SLAB_ROWS,
                                                             SLAB_CHUNK):
        raise RuntimeError(f"ewald_real_sweep.cu's slab blocks are "
                           f"{lib.ewald_slab_rows()} x "
                           f"{lib.ewald_slab_chunk()}, the wrapper's "
                           f"{SLAB_ROWS} x {SLAB_CHUNK}")
    if (lib.ewald_tile_rows(), lib.ewald_tile_table_capacity()) != (
            TILE_ROWS, TILE_TABLE_BYTES):
        raise RuntimeError(f"ewald_real_sweep.cu's K4 tiles hold "
                           f"{lib.ewald_tile_rows()}-blob tiles and "
                           f"{lib.ewald_tile_table_capacity()} table bytes, "
                           f"the wrapper {TILE_ROWS} and {TILE_TABLE_BYTES}")
    cf = ctypes.POINTER(ctypes.c_float)
    lib.ewald_real_tiles.restype = i
    lib.ewald_real_tiles.argtypes = [p, p, p, p, p, p, i, p, i, i, i, i, cf,
                                     p, p, i, i, p, i, p, p, p]
    lib.ewald_real_sweep.restype = i
    lib.ewald_real_sweep.argtypes = [p, p, i, i, cf, p, i, p, p, p, p]
    lib.ewald_real_slab.restype = i
    lib.ewald_real_slab.argtypes = [p, i, i, p, p, i, i, i, cf, p, i, p, p, p]
    _lib = lib
    return lib


def sweep_constants(params):
    """The kernel's 14 per-launch scalars from ``params``, computed in
    float64: box[3], 1/box[3], the two inner segment edges, each segment's
    left edge and 2/width (a zero-width segment's is capped at the float32
    maximum: its x clips to −1 either way)."""
    box = [float(v) for v in params.box]
    return np.asarray(box + [1.0 / v for v in box]
                      + _segment_constants(params.cheb_bounds), np.float32)


def _segment_constants(bounds):
    """A fit's 8 segment constants from its (4,) edges, in float64: the two
    inner edges, each segment's left edge and 2/width."""
    b = [float(v) for v in bounds]
    two_inv_w = [min(2.0 / max(b[s + 1] - b[s], 1e-300), _F32_MAX)
                 for s in range(3)]
    return [b[1], b[2]] + b[:3] + two_inv_w


def coefficient_table(params):
    """The kernel's Chebyshev table, (D+1, 4, 2) float32: [j, segment] =
    (A_j, B_j), slot 3 unused."""
    cA = np.asarray(params.cheb_A, np.float64)
    cB = np.asarray(params.cheb_B, np.float64)
    table = np.zeros((cA.shape[1], 4, 2), np.float32)
    table[:, :3, 0] = cA.T
    table[:, :3, 1] = cB.T
    return table


def sweep_items(n):
    """The kernel's work items for n blobs in launch order
    (:func:`.tiles.upper_tile_items` of 128-blob tiles)."""
    return tiles.upper_tile_items(n, TILE)


def operator_tables(params, dev):
    """(coefficient table on ``dev``, the 14 constants as a ctypes array,
    degree) of one operator, built at its first launch and kept
    (:func:`.ewald.per_operator`)."""
    lib = build()
    coef = ewald.per_operator(
        params, ("K4 table", dev),
        lambda: torch.from_numpy(coefficient_table(params)).to(dev))
    deg = coef.shape[0] - 1
    if deg > lib.ewald_sweep_max_degree():
        raise ValueError(
            f"the Chebyshev fit has degree {deg}; the kernel's table holds "
            f"at most {lib.ewald_sweep_max_degree()} (a long anisotropic "
            "box: raise kMaxDeg in csrc/ewald_real_sweep.cu)")
    consts = ewald.per_operator(
        params, "K4 constants",
        lambda: (ctypes.c_float * 14)(*sweep_constants(params).tolist()))
    return coef, consts, deg


def real_sweep_kernel(r, Fs, params):
    """K4 on the card.  r (n, 3), Fs (k, n, 3) float32 contiguous CUDA
    tensors, k ∈ {1, 2} → (k, n, 3) pair terms."""
    global sweep_launches
    n, k = r.shape[0], Fs.shape[0]
    if k not in (1, 2):
        raise ValueError(f"ewald_real_sweep takes 1 or 2 RHS, got {k}")
    cuda_build.check_tensor(r, "r", (n, 3))
    cuda_build.check_tensor(Fs, "Fs", (k, n, 3))
    lib = build()
    dev = r.device
    coef, consts, deg = operator_tables(params, dev)
    row_part = torch.empty(tiles.partial_shape(n, k, TILE),
                           dtype=torch.float32, device=dev)
    col_part = torch.empty_like(row_part)
    out = torch.empty((k, n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), profiling.span("ewald_real_sweep"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.ewald_real_sweep(
            r.data_ptr(), Fs.data_ptr(), n, k, consts, coef.data_ptr(), deg,
            row_part.data_ptr(), col_part.data_ptr(), out.data_ptr(), stream)
    cuda_build.raise_on_error(code, "ewald_real_sweep")
    sweep_launches += 1
    return out


def slab_partial_shape(n_rows, n_cols, k):
    """K4's slab form's scratch: one (k, n_rows, 3) partial a column chunk
    of SLAB_CHUNK (at least one, so the buffer is never empty)."""
    return (max(1, -(-n_cols // SLAB_CHUNK)), k, n_rows, 3)


def real_slab_kernel(r_rows, row0, r_cols, col0, Fs, params):
    """K4's slab form on the card.  r_rows (n_r, 3), r_cols (n_c, 3), Fs
    (k, n_c, 3) float32 contiguous CUDA tensors, k ∈ {1, 2}, at global
    offsets row0 and col0 → (k, n_r, 3) pair terms."""
    global slab_launches
    n_r, n_c, k = r_rows.shape[0], r_cols.shape[0], Fs.shape[0]
    if k not in (1, 2):
        raise ValueError(f"ewald_real_slab takes 1 or 2 RHS, got {k}")
    cuda_build.check_tensor(r_rows, "r_rows", (n_r, 3))
    cuda_build.check_tensor(r_cols, "r_cols", (n_c, 3))
    cuda_build.check_tensor(Fs, "Fs", (k, n_c, 3))
    lib = build()
    dev = r_rows.device
    coef, consts, deg = operator_tables(params, dev)
    part = torch.empty(slab_partial_shape(n_r, n_c, k),
                       dtype=torch.float32, device=dev)
    out = torch.empty((k, n_r, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), profiling.span("ewald_real_slab"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.ewald_real_slab(
            r_rows.data_ptr(), n_r, int(row0), r_cols.data_ptr(),
            Fs.data_ptr(), n_c, int(col0), k, consts, coef.data_ptr(), deg,
            part.data_ptr(), out.data_ptr(), stream)
    cuda_build.raise_on_error(code, "ewald_real_slab")
    slab_launches += 1
    return out


def _tile_table_size(params, pt):
    """(fits, degree, species, shared bytes) of K4 tiles' table for the
    monodisperse fit (``pt`` None, no species) or the species-pair fits
    ``pt``: (deg + 1) × 4 coefficient pairs and 8 segment constants a fit,
    the (S, S) species-pair map (the kernel's ``tile_table_bytes``)."""
    if pt is None:
        n_fits, deg, n_sp = 1, np.shape(params.cheb_A)[1] - 1, 0
    else:
        n_fits, deg, n_sp = pt.bounds.shape[0], pt.coefA.shape[2] - 1, \
            pt.n_species
    return n_fits, deg, n_sp, (n_fits * (deg + 1) * 32 + n_fits * 32
                               + n_sp * n_sp * 4)


def tile_tables(params, pt=None):
    """K4 tiles' host tables: coefficients (F, D+1, 4, 2) float32 ([fit, j,
    segment] = (A_j, B_j), slot 3 unused), the fits' segment constants (F,
    8) float32 and the species-pair map (S, S) int32 (None monodisperse):
    the monodisperse fit (F = 1) or the species-pair fits ``pt``."""
    if pt is None:
        return (coefficient_table(params)[None],
                np.asarray([_segment_constants(params.cheb_bounds)],
                           np.float32), None)
    P, _, d1 = pt.coefA.shape
    coef = np.zeros((P, d1, 4, 2), np.float32)
    coef[:, :, :3, 0] = np.transpose(pt.coefA, (0, 2, 1))
    coef[:, :, :3, 1] = np.transpose(pt.coefB, (0, 2, 1))
    fits = np.asarray([_segment_constants(b) for b in pt.bounds], np.float32)
    return coef, fits, pt.pair_map.astype(np.int32)


class TileList(NamedTuple):
    """K4 tiles' work list of one row-tile slice (:func:`tile_list`)."""
    pairs: torch.Tensor      # (≥ cap, 4) int32: a, b ≥ a, slot of b in a's
    #                          list, slot of a in b's list; the first used
    n_pairs: torch.Tensor    # (1,) int32: the used rows
    row_start: torch.Tensor  # (t + 1,) int32: live list entries before a row
    cap: int                 # the slice's live list entries: its partials


def tile_list(nbr, t0, nt):
    """K4 tiles' work list for the row tiles [t0, t0 + nt) of the neighbor
    lists ``nbr`` (t, M) (live tiles first, ascending, then −1): the
    unordered tile pairs with a tile in the slice, in list order, as K3
    lists them (:func:`.tiles.tile_pairs`, :func:`.tiles.slice_pairs` for
    a slice), on nbr's device, and the prefix sum of the live entries.  One
    host sync reads the widest live row W and the slice's live entries:
    the lists are cut to W columns before the pairs are built (M = t at
    the balanced-split slice, W ≈ M/7 there), and the live entries count
    the partials, one a slot (a pair's two sides at its two tiles' slots),
    and bound the pairs, each of which holds a slot of the slice."""
    per_row = (nbr >= 0).sum(dim=1, dtype=torch.int32)
    row_start = torch.nn.functional.pad(
        torch.cumsum(per_row, 0, dtype=torch.int32), (1, 0))
    width, live = torch.stack([per_row.max(), row_start[t0 + nt]
                               - row_start[t0]]).tolist()
    pairs, n_pairs = tiles.tile_pairs(nbr[:, :max(width, 1)].to(
        torch.int32, memory_format=torch.contiguous_format))
    if (t0, nt) != (0, nbr.shape[0]):
        pairs, n_pairs, _ = tiles.slice_pairs(pairs, n_pairs, t0, nt)
    return TileList(pairs, n_pairs, row_start, live)


def tile_operator_tables(params, pt, dev):
    """K4 tiles' tables on ``dev`` (coefficients, segment constants, pair
    map or None) and the launch's 7 constants (box, 1/box, rc) as a ctypes
    array, built once per operator or species-pair table set and kept
    (:func:`.ewald.per_operator`)."""
    def upload():
        return tuple(None if v is None else torch.from_numpy(v).to(dev)
                     for v in tile_tables(params, pt))
    tabs = ewald.per_operator(params if pt is None else pt,
                              ("K4 tiles tables", dev), upload)
    consts = ewald.per_operator(params, "K4 tiles constants", lambda: (
        ctypes.c_float * 7)(*[float(v) for v in params.box],
                            *[1.0 / float(v) for v in params.box],
                            float(params.rc)))
    return tabs, consts


def tile_sweep_launch(r_pad, ids32, F_pad, sp32, lst, params, pt, t0, nt):
    """K4 tiles' launch over a built work list ``lst`` (:func:`tile_list`):
    r_pad, F_pad float32, ids32 and sp32 (None monodisperse) int32, all
    contiguous CUDA tensors, pt the species-pair fits or None → (k, nt·32,
    3).  Counted as ``ewald_real_tiles``."""
    global tile_launches
    n_pad, k = r_pad.shape[0], F_pad.shape[0]
    lib = build()
    dev = r_pad.device
    n_fits, deg, n_sp, _ = _tile_table_size(params, pt)
    (coef, fits, pmap), consts = tile_operator_tables(params, pt, dev)
    part = torch.empty((lst.cap, k, TILE_ROWS, 3), dtype=torch.float32,
                       device=dev)
    out = torch.empty((k, nt * TILE_ROWS, 3), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev), profiling.span("ewald_real_tiles"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.ewald_real_tiles(
            r_pad.data_ptr(), ids32.data_ptr(), F_pad.data_ptr(),
            None if sp32 is None else sp32.data_ptr(), lst.pairs.data_ptr(),
            lst.n_pairs.data_ptr(), lst.cap, lst.row_start.data_ptr(), n_pad,
            int(t0), int(nt), k, consts, coef.data_ptr(), fits.data_ptr(),
            n_fits, deg, None if pmap is None else pmap.data_ptr(), n_sp,
            part.data_ptr(), out.data_ptr(), stream)
    cuda_build.raise_on_error(code, "ewald_real_tiles")
    tile_launches += 1
    return out


def tile_sweep_kernel(r_pad, ids_pad, F_pad, nbr, params, poly, t0, nt):
    """K4 tiles on the card: :func:`tile_pair_sum`'s arguments, r_pad and
    F_pad float32 contiguous CUDA tensors → (k, nt·32, 3): the work list
    (timed as ``ewald_tiles``, with the sorted tiles), then the launch."""
    t = nbr.shape[0]
    cuda_build.check_tensor(r_pad, "r_pad", (t * TILE_ROWS, 3))
    cuda_build.check_tensor(F_pad, "F_pad", (F_pad.shape[0],
                                             r_pad.shape[0], 3))
    pt = None if poly is None else poly[2]
    with torch.cuda.device(r_pad.device), profiling.span("ewald_tiles"):
        lst = tile_list(nbr, t0, nt)
        ids32 = ids_pad.to(torch.int32).contiguous()
        sp32 = None if pt is None else poly[1].to(torch.int32).contiguous()
    return tile_sweep_launch(r_pad, ids32, F_pad, sp32, lst, params, pt, t0,
                             nt)


def tile_pair_sum(r_pad, ids_pad, F_pad, nbr, params, poly=None, t0=0,
                  nt=None, chunk_tiles=None):
    """K4 tiles: the balanced split's cutoff sweep of the sorted row tiles
    [t0, t0 + nt) against their neighbor tiles, float32, with exactly
    :func:`.ewald_cells._cell_sweep`'s contract and arguments (r_pad,
    ids_pad, F_pad (k, t·32, 3) with k ∈ {1, 2}, nbr (t, M), poly from
    :func:`.ewald_cells._poly_pad` with its species-pair fits) → (k,
    nt·32, 3) pair terms in sorted order.

    CPU tensors take the plain twin ``_cell_sweep`` (``chunk_tiles``
    groups its rows; the kernel has no chunks), CUDA tensors the kernel
    (its work list costs one host sync, :func:`tile_list`); there is no
    fallback.  Rows of pad blobs hold garbage (the twin's) or 0 (the
    kernel's); the caller drops them.  Raises on anything else than
    float32, a non-contiguous r_pad or F_pad, k ∉ {1, 2}, params without
    rc, or a fit table larger than the kernel's shared memory holds (never
    truncated)."""
    if params.rc is None:
        raise ValueError("K4 tiles sweep the balanced split's real part: "
                         "params built with rc=")
    k = F_pad.shape[0]
    if k not in (1, 2):
        raise ValueError(f"ewald_real_tiles takes 1 or 2 RHS, got {k}")
    for name, x in (("r_pad", r_pad), ("F_pad", F_pad)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if poly is not None and poly[1] is None:
        raise ValueError("the float32 tile sweep with radii evaluates "
                         "species-pair fits: build poly with poly_tables")
    _, deg, _, nbytes = _tile_table_size(params,
                                         None if poly is None else poly[2])
    if nbytes > TILE_TABLE_BYTES:
        raise ValueError(
            f"the Chebyshev fits of degree {deg} need {nbytes} bytes of "
            f"shared table; K4 tiles hold at most {TILE_TABLE_BYTES} (raise "
            "kTileTableBytes in csrc/ewald_real_sweep.cu)")
    if nt is None:
        nt = nbr.shape[0] - t0
    if r_pad.device.type == "cuda":
        cuda_build.refuse_grad("K4 tiles ewald_real_tiles", F_pad, r_pad)
        return tile_sweep_kernel(r_pad, ids_pad, F_pad, nbr, params, poly,
                                 t0, nt)
    if r_pad.device.type == "cpu":
        from rigid_body_light_tpu_torch.ops import ewald_cells

        return ewald_cells._cell_sweep(r_pad, ids_pad, F_pad, nbr, params,
                                       poly=poly, chunk_tiles=chunk_tiles,
                                       t0=t0, nt=nt)
    raise ValueError(f"no tile sweep for device {r_pad.device}")


def _check(params, k):
    if params.rc is not None:
        raise ValueError(
            "K4 sweeps the classic split's real part; the balanced split "
            "(params built with rc=) sweeps its real part over sorted tiles "
            "(ewald.mobility_apply routes it to ewald_cells)")
    if k > 2:
        raise NotImplementedError(
            f"a {k}-RHS sweep is not in the CUDA Ewald sweep (K4 takes "
            "k ≤ 2, as the Pallas kernel does)")


def real_pair_sum(Fs, r, params):
    """Σ_{j≠i} [A·I + B·r̂r̂]·F_j in float32.

    Fs: (k, N, 3) with k ∈ {1, 2}; r: (N, 3) physical positions.  CPU
    tensors take the plain sweep, CUDA tensors K4.  Returns (k, N, 3).
    """
    _check(params, Fs.shape[0])
    if r.device.type == "cuda":
        cuda_build.refuse_grad("K4 ewald_real_sweep", Fs, r)
    r = r.to(torch.float32).contiguous()
    Fs = Fs.to(torch.float32).contiguous()
    if r.device.type == "cpu":
        return ewald.real_space_apply(Fs, r, params)
    if r.device.type == "cuda":
        return real_sweep_kernel(r, Fs, params)
    raise ValueError(f"no Ewald sweep for device {r.device}")


def real_pair_sum_slab(Fs, r_rows, row0, r_cols, col0, params):
    """Σ_j [A·I + B·r̂r̂]·F_j in float32 for the rows ``r_rows`` (global
    ids row0, row0 + 1, …) against the columns ``r_cols`` (global ids
    col0, …), the pair of equal ids left out: the distributed ring's
    slabs (:func:`.ewald.mobility_apply_local`).

    Fs: (k, N_c, 3) column forces, k ∈ {1, 2}.  CPU tensors take the plain
    block (:func:`.ewald.real_space_block`), CUDA tensors K4's slab form.
    Returns (k, N_r, 3)."""
    _check(params, Fs.shape[0])
    if r_rows.device.type == "cuda":
        cuda_build.refuse_grad("K4 ewald_real_slab", Fs, r_rows, r_cols)
    r_rows = r_rows.to(torch.float32).contiguous()
    r_cols = r_cols.to(torch.float32).contiguous()
    Fs = Fs.to(torch.float32).contiguous()
    if r_rows.device.type == "cpu":
        dev = r_rows.device
        return ewald.real_space_block(
            r_rows, row0 + torch.arange(r_rows.shape[0], device=dev),
            r_cols, col0 + torch.arange(r_cols.shape[0], device=dev), Fs,
            params)
    if r_rows.device.type == "cuda":
        return real_slab_kernel(r_rows, row0, r_cols, col0, Fs, params)
    raise ValueError(f"no Ewald slab for device {r_rows.device}")


def mobility_apply_multi(Fs, r, params):
    """Multi-RHS periodic product (k, N, 3) → (k, N, 3), float32, shared
    pair fields: K4's real-space pairs, the closed-form self term and the
    wave-space matmuls."""
    r = r.to(torch.float32).reshape(-1, 3)
    Fs = Fs.to(torch.float32)
    Fs = Fs.reshape(Fs.shape[0], -1, 3)
    U = real_pair_sum(Fs, r, params)
    U = U + ewald.self_coeff(params.a, params.xi, params.eta) * Fs
    return U + ewald.wave_space_apply(Fs, r, params)


def mobility_apply(F, r, params):
    """Drop-in for :func:`rigid_body_light_tpu_torch.ops.ewald.
    mobility_apply` (monodisperse float32): (N, 3) → (N, 3)."""
    return mobility_apply_multi(F.reshape(1, -1, 3), r, params)[0]
