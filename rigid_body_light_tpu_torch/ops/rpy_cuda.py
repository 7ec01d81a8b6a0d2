"""Wrappers of the hand-written CUDA pair sweeps — the port of
``rigid_body_light_tpu/ops/rpy_pallas.py`` (its ``pair_sum``,
``mobility_apply`` and ``mobility_apply_multi`` contract).

Kernels (``csrc/rpy_pair_sweep.cu``, built for sm_90a at first use by
:mod:`.cuda_build`):

  K1 ``pair_sweep_sym``      replaces ``rpy_pallas._kernel_sym``: symmetric
                             unordered-pair sweep over 128 × 128 work items
                             of the upper triangle, a block walking one
                             pair of tile groups (:func:`.tiles.group_items`)
                             with O(n) partials, 1 or 2 RHS.
  K2 ``pair_sweep_ordered``  replaces ``rpy_pallas._kernel``: ordered slab
                             with global row/column offsets, 1 or 2 RHS, in
                             blocks of 64 rows × 256 columns
                             (:func:`ordered_grid`).

Both have a POLY form (per-blob radii in units of a, ``ahat``: the
polydisperse fields of ``rpy_pallas._poly_coeffs`` and the wall terms at
the pair's √(aᵢaⱼ), heights floored per pair), with or without the box
below (the POLY × box forms).

Both take the pseudo-2D (Lx, Ly) box: the minimum-image wrap of a pair's
in-plane displacement and, with ``image_shells`` S ≥ 1, the exact
doubly-periodic sum over the (2S+1)² − 1 nonzero lattice offsets of the
wrapped displacement with the two-ring tail weights (``image_tail``).  K1
never visits i == i, so :func:`pair_sum` adds the self-image diagonal
(:func:`.rpy.self_image_sum`, plain PyTorch on the device, with the
blob's radius in the POLY form) as ``rpy_pallas.pair_sum`` does; K2 keeps
a blob's own images.

Dispatch in :func:`pair_sum` follows the JAX package's rule
(``rpy_pallas.py:59-66``, ``:623``), with or without a box: k=1 → K1; k=2
→ K1 once n padded to 512 reaches 65,536 blobs, else K2
(:func:`uses_sym`), with or without radii.  k > 2 raises
NotImplementedError naming the ROADMAP item.  A tensor on the CPU takes
the plain PyTorch version (:mod:`rigid_body_light_tpu_torch.ops.rpy`); a
CUDA tensor launches the kernel or raises — there is no fallback.  Like the Pallas wrapper,
inputs are cast to float32.

The kernels compute pair terms only; the wrappers here apply the self
term, the 1/(8πηa) scale and the B·M·B damping.  :func:`mobility_apply`
(one RHS) is differentiable through :class:`MobilityApply`, the port of
``rpy_pallas._mobility_apply_diff``: the force cotangent is one more K1
sweep (B·M·B is symmetric, the image sums too), the position cotangent
autograd of the plain sweep at the same arguments.  Any other launch on a
tensor that requires grad raises (:func:`.cuda_build.refuse_grad`): the
kernels' outputs carry no ``grad_fn``, and a gradient through them would
miss the pair terms.

The sharded paths reach K2 through :func:`pair_sum_slab`, the port of
``rpy_pallas.pair_sum_slab`` (``rpy_pallas.py:648``): a rectangular slab
of local rows at a global ``row_offset`` against a block of columns at a
global ``col_offset`` (:mod:`rigid_body_light_tpu_torch.parallel`).
:func:`mobility_apply_rows` streams rows of the exact product through it,
the comparator for sizes where the full exact sweep and a far-field
context do not fit on the card together.

``sym_launches`` / ``ordered_launches`` (``sym_poly_launches`` /
``ordered_poly_launches`` for the POLY forms, ``sym_poly_box_launches`` /
``ordered_poly_box_launches`` for the POLY × box forms; ``slab_launches``,
``slab_poly_launches`` and ``slab_poly_box_launches`` for K2 launched
through :func:`pair_sum_slab`) count kernel launches (incremented where
each kernel is launched, nowhere else) so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rigid_body_light_tpu_torch.ops import cuda_build, rpy, tiles
from rigid_body_light_tpu_torch.utils import profiling

# K1's work-item edge and K2's rows and columns a block; build() checks
# them against the kernels'
TILE = 128
ORD_ROWS = 64
ORD_CHUNK = 256
# the JAX package's k-routing (rpy_pallas.TC, rpy_pallas._SYM_K2_MIN_NPAD):
# a 2-RHS square sweep takes the symmetric kernel once n, padded to 512,
# reaches 65,536
_PAD = 512
SYM_K2_MIN_NPAD = 65536

sym_launches = 0
ordered_launches = 0
sym_poly_launches = 0
ordered_poly_launches = 0
sym_poly_box_launches = 0
ordered_poly_box_launches = 0
slab_launches = 0
slab_poly_launches = 0
slab_poly_box_launches = 0

_lib = None


def reset_launch_counts():
    global sym_launches, ordered_launches, sym_poly_launches
    global ordered_poly_launches, sym_poly_box_launches
    global ordered_poly_box_launches
    global slab_launches, slab_poly_launches, slab_poly_box_launches
    sym_launches = ordered_launches = 0
    sym_poly_launches = ordered_poly_launches = 0
    sym_poly_box_launches = ordered_poly_box_launches = 0
    slab_launches = slab_poly_launches = slab_poly_box_launches = 0


def launch_counts():
    return {"pair_sweep_sym": sym_launches,
            "pair_sweep_ordered": ordered_launches,
            "pair_sweep_sym_poly": sym_poly_launches,
            "pair_sweep_ordered_poly": ordered_poly_launches,
            "pair_sweep_sym_poly_box": sym_poly_box_launches,
            "pair_sweep_ordered_poly_box": ordered_poly_box_launches,
            "pair_sweep_slab": slab_launches,
            "pair_sweep_slab_poly": slab_poly_launches,
            "pair_sweep_slab_poly_box": slab_poly_box_launches}


def uses_sym(k, n):
    """Whether a square k-RHS sweep of n blobs takes K1 (else K2)."""
    return k == 1 or -(-n // _PAD) * _PAD >= SYM_K2_MIN_NPAD


def ordered_grid(n_rows, n_cols):
    """K2's grid: (row blocks of 64, column chunks of 256)."""
    return -(-n_rows // ORD_ROWS), -(-n_cols // ORD_CHUNK)


def build():
    """Compile ``csrc/rpy_pair_sweep.cu`` (if its build is not current; see
    :mod:`.cuda_build`) and load it.  Returns the ``ctypes`` library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load("rpy_pair_sweep")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shapes = {"rpy_sym_tile": TILE, "rpy_sym_max_groups": tiles.MAX_GROUPS,
              "rpy_ordered_rows": ORD_ROWS, "rpy_ordered_chunk": ORD_CHUNK}
    for name, want in shapes.items():
        fn = getattr(lib, name)
        fn.restype = i
        fn.argtypes = []
        if fn() != want:
            raise RuntimeError(f"rpy_pair_sweep.cu: {name} is {fn()}, the "
                               f"wrapper's {want}")
    box = [f, f, i, f, f]
    lib.rpy_pair_sweep_sym.restype = i
    lib.rpy_pair_sweep_sym.argtypes = [p, p, p, i, i, i, f, *box, p, p, p, p]
    lib.rpy_pair_sweep_ordered.restype = i
    lib.rpy_pair_sweep_ordered.argtypes = [p, p, i, i, p, p, p, i, i, i, i, f,
                                           *box, p, p, p]
    _lib = lib
    return lib


def box_args(box_over_a=None, image_shells=0, image_tail=True):
    """The kernels' box arguments (Lx, Ly, S, α, β): lengths in units of a
    (0 = no box), the shells and the tail coefficients, as the Pallas
    wrapper passes them (``rpy_pallas.py:614-621``)."""
    if box_over_a is None:
        if image_shells:
            raise ValueError("image_shells needs a 2-D box_over_a")
        return 0.0, 0.0, 0, 0.0, 0.0
    if len(box_over_a) != 2 or min(box_over_a) <= 0:
        raise ValueError(f"the pair sweeps' box is a positive (Lx, Ly) pair, "
                         f"got {box_over_a}")
    bx, by = float(box_over_a[0]), float(box_over_a[1])
    S = int(image_shells)
    if S < 0:
        raise ValueError(f"image_shells must be ≥ 0, got {S}")
    alpha, beta = rpy.tail_coeffs(S) if (S and image_tail) else (0.0, 0.0)
    return bx, by, S, alpha, beta


def _check_poly(ahat, n, name):
    """The POLY form's radii: a float32 CUDA vector of n."""
    if ahat is None:
        return None
    cuda_build.check_tensor(ahat, name, (n,))
    return ahat.data_ptr()


def _boxed(box):
    return box is not None and box[0] > 0


def pair_sweep_sym(r_over_a, F, wall: bool, h_floor: float, box=None,
                   ahat=None):
    """K1: Σ_{j≠i} M_ij F_j over unordered pairs, on the card.
    r_over_a (n, 3) and F (n, 3), or (k, n, 3) with k ∈ {1, 2}, float32
    CUDA tensors → F's shape.  box: :func:`box_args` (None: no box); the
    self images are not included.  ahat: (n,) radii in units of a, the
    POLY form (with a box the POLY × box form)."""
    global sym_launches, sym_poly_launches, sym_poly_box_launches
    n = r_over_a.shape[0]
    Fk = F[None] if F.dim() == 2 else F
    k = Fk.shape[0]
    if k not in (1, 2):
        raise ValueError(f"pair_sweep_sym takes 1 or 2 RHS, got {k}")
    cuda_build.check_tensor(r_over_a, "r_over_a", (n, 3))
    cuda_build.check_tensor(Fk, "F", (k, n, 3))
    ahat_ptr = _check_poly(ahat, n, "ahat")
    lib = build()
    dev = r_over_a.device
    # a row and a column partial a tile of each unit's groups, O(n): 2.63 GB
    # at 409,600 blobs and 2 RHS
    row_part = torch.empty(tiles.partial_shape(n, k, TILE),
                           dtype=torch.float32, device=dev)
    col_part = torch.empty_like(row_part)
    out = torch.empty((k, n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), profiling.span("pair_sweep_sym"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rpy_pair_sweep_sym(
            r_over_a.data_ptr(), Fk.data_ptr(), ahat_ptr, n, k,
            int(bool(wall)), float(h_floor), *(box or box_args()),
            row_part.data_ptr(),
            col_part.data_ptr(), out.data_ptr(), stream)
    cuda_build.raise_on_error(code, "pair_sweep_sym")
    if ahat is None:
        sym_launches += 1
    elif _boxed(box):
        sym_poly_box_launches += 1
    else:
        sym_poly_launches += 1
    return out if F.dim() == 3 else out[0]


def pair_sweep_ordered(r_rows_over_a, row_offset: int, r_cols_over_a, F_cols,
                       col_offset: int, wall: bool, h_floor: float, box=None,
                       ahat_rows=None, ahat_cols=None, slab: bool = False):
    """K2: Σ_j M_ij F_j over all columns whose global id differs from the
    row's, on the card.  r_rows (R, 3), r_cols (N, 3), F_cols (k, N, 3)
    float32 CUDA tensors, k ∈ {1, 2} → (k, R, 3).  box: :func:`box_args`
    (None: no box); a blob's own images are included.  ahat_rows (R,) /
    ahat_cols (N,): the rows' and columns' radii in units of a (both or
    neither), the POLY form (with a box the POLY × box form).  slab: count
    the launch as a slab of a sharded sweep (:func:`pair_sum_slab`)."""
    global ordered_launches, ordered_poly_launches, ordered_poly_box_launches
    global slab_launches, slab_poly_launches, slab_poly_box_launches
    n_rows = r_rows_over_a.shape[0]
    k, n_cols = F_cols.shape[0], r_cols_over_a.shape[0]
    if k not in (1, 2):
        raise ValueError(f"pair_sweep_ordered takes 1 or 2 RHS, got {k}")
    if (ahat_rows is None) != (ahat_cols is None):
        raise ValueError("pair_sweep_ordered takes ahat_rows and ahat_cols "
                         "together")
    cuda_build.check_tensor(r_rows_over_a, "r_rows_over_a", (n_rows, 3))
    cuda_build.check_tensor(r_cols_over_a, "r_cols_over_a", (n_cols, 3))
    cuda_build.check_tensor(F_cols, "F_cols", (k, n_cols, 3))
    rows_ptr = _check_poly(ahat_rows, n_rows, "ahat_rows")
    cols_ptr = _check_poly(ahat_cols, n_cols, "ahat_cols")
    lib = build()
    dev = r_rows_over_a.device
    part = torch.empty((ordered_grid(n_rows, n_cols)[1], k, n_rows, 3),
                       dtype=torch.float32, device=dev)
    out = torch.empty((k, n_rows, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), profiling.span("pair_sweep_ordered"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rpy_pair_sweep_ordered(
            r_rows_over_a.data_ptr(), rows_ptr, n_rows, int(row_offset),
            r_cols_over_a.data_ptr(), cols_ptr, F_cols.data_ptr(), n_cols,
            int(col_offset), k, int(bool(wall)), float(h_floor),
            *(box or box_args()), part.data_ptr(), out.data_ptr(), stream)
    cuda_build.raise_on_error(code, "pair_sweep_ordered")
    if slab:
        if ahat_rows is None:
            slab_launches += 1
        elif _boxed(box):
            slab_poly_box_launches += 1
        else:
            slab_poly_launches += 1
    elif ahat_rows is None:
        ordered_launches += 1
    elif _boxed(box):
        ordered_poly_box_launches += 1
    else:
        ordered_poly_launches += 1
    return out


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not in the CUDA pair sweeps yet (ROADMAP.md queue 1, "
        f"{item})")


def pair_sum(r_over_a, F, wall: bool, h_floor: float = None, box_over_a=None,
             ahat=None, image_shells=0, image_tail=True):
    """Σ_{j≠i} M_ij F_j (unscaled, undamped pair terms).

    r_over_a: (N, 3) positions in units of the blob radius; F: (N, 3) single
    RHS or (k, N, 3), k ≤ 2.  box_over_a: None or the pseudo-2D (Lx, Ly)
    box in units of a; image_shells / image_tail: the exact image sum, self
    images included (as ``rpy_pallas.pair_sum``).  ahat: optional (N,)
    per-blob radii in units of a (the POLY forms, with or without the
    box).  CPU tensors take the plain sweep, CUDA tensors K1 or K2 by
    :func:`uses_sym`.
    """
    if h_floor is None:
        h_floor = rpy.WALL_H_FLOOR
    box = box_args(box_over_a, image_shells, image_tail)
    multi = F.dim() == 3
    Fk = F if multi else F[None]
    k = Fk.shape[0]
    if k > 2:
        raise _not_ported(f"a {k}-RHS sweep", "item 3 (K1/K2 take k ≤ 2, "
                          "as the Pallas kernels do)")
    r_over_a = r_over_a.to(torch.float32).contiguous()
    Fk = Fk.to(torch.float32).contiguous()
    if ahat is not None:
        ahat = ahat.to(torch.float32).contiguous()
    n = r_over_a.shape[0]
    S = box[2]
    dev = r_over_a.device.type
    if dev == "cpu":
        ids = torch.arange(n)
        U = rpy.pair_sum(r_over_a, ids, r_over_a, ids, Fk, a=1.0, wall=wall,
                         h_floor=h_floor, box=box_over_a, image_shells=S,
                         image_tail=image_tail, radii_rows=ahat,
                         radii_cols=ahat)
    elif dev == "cuda":
        cuda_build.refuse_grad(f"K{1 if uses_sym(k, n) else 2} at {k} RHS",
                               r_over_a, Fk, ahat)
        if uses_sym(k, n):
            U = pair_sweep_sym(r_over_a, Fk, wall, h_floor, box, ahat=ahat)
            if S:
                # K1 never visits i == i: a blob against its own images
                U = U + rpy.self_image_sum(r_over_a, Fk, wall, box[:2], S,
                                           h_floor=h_floor, tail=image_tail,
                                           ahat=ahat)
        else:
            U = pair_sweep_ordered(r_over_a, 0, r_over_a, Fk, 0, wall,
                                   h_floor, box, ahat_rows=ahat,
                                   ahat_cols=ahat)
    else:
        raise ValueError(f"no pair sweep for device {r_over_a.device}")
    return U if multi else U[0]


def pair_sum_slab(r_rows_over_a, row_offset: int, r_cols_over_a, F_cols,
                  wall: bool, col_offset: int = 0, h_floor: float = None,
                  box_over_a=None, ahat_rows=None, ahat_cols=None,
                  image_shells=0, image_tail=True):
    """Rectangular slab of the pair sum for the sharded paths: local rows
    × a block of columns, the contract of ``rpy_pallas.pair_sum_slab``.

    r_rows_over_a (R, 3) rows whose first has global id ``row_offset``;
    r_cols_over_a (N, 3) columns from global id ``col_offset``; F_cols
    (N, 3) or (k, N, 3), k ≤ 2.  A pair is skipped iff its two global ids
    are equal, so a slab off the diagonal block keeps every pair; with the
    box and ``image_shells`` a blob's own images at nonzero offsets are
    included (every global ordered pair a decomposition visits once adds
    its whole image sum).  Padded columns must carry F = 0; padded rows
    are the caller's to drop.  ahat_rows (R,) / ahat_cols (N,): radii in
    units of a, both or neither (the POLY forms).  Float32; CPU tensors
    take the plain sweep with those global ids, CUDA tensors K2
    (:func:`pair_sweep_ordered`, counted as a slab).  Returns F_cols'
    layout with R rows."""
    if h_floor is None:
        h_floor = rpy.WALL_H_FLOOR
    if (ahat_rows is None) != (ahat_cols is None):
        raise ValueError("pair_sum_slab takes ahat_rows and ahat_cols "
                         "together")
    box = box_args(box_over_a, image_shells, image_tail)
    multi = F_cols.dim() == 3
    Fk = F_cols if multi else F_cols[None]
    k = Fk.shape[0]
    if k > 2:
        raise _not_ported(f"a {k}-RHS slab", "item 3 (K2 takes k ≤ 2, as "
                          "the Pallas kernel does)")
    rr = r_rows_over_a.to(torch.float32).contiguous()
    rc = r_cols_over_a.to(torch.float32).contiguous()
    Fk = Fk.to(torch.float32).contiguous()
    ar, ac = ((None, None) if ahat_rows is None else
              (ahat_rows.to(torch.float32).contiguous(),
               ahat_cols.to(torch.float32).contiguous()))
    dev = rr.device.type
    if dev == "cpu":
        row_ids = int(row_offset) + torch.arange(rr.shape[0])
        col_ids = int(col_offset) + torch.arange(rc.shape[0])
        U = rpy.pair_sum(rr, row_ids, rc, col_ids, Fk, a=1.0, wall=wall,
                         h_floor=h_floor, box=box_over_a,
                         image_shells=box[2], image_tail=image_tail,
                         radii_rows=ar, radii_cols=ac)
    elif dev == "cuda":
        cuda_build.refuse_grad("K2's slab", rr, rc, Fk, ar, ac)
        U = pair_sweep_ordered(rr, row_offset, rc, Fk, col_offset, wall,
                               h_floor, box, ahat_rows=ar, ahat_cols=ac,
                               slab=True)
    else:
        raise ValueError(f"no pair sweep for device {rr.device}")
    return U if multi else U[0]


def mobility_apply_rows(F, r, row_start: int, row_len: int, a=1.0, eta=1.0,
                        wall=False, h_floor=None, box=None, radii=None):
    """Rows [row_start, row_start + row_len) of :func:`mobility_apply`
    (float32, one RHS), with the pair terms of those rows alone: the port
    of ``rpy_pallas.mobility_apply_rows``, the streamed exact comparator
    for sizes where the full exact sweep beside a far-field context does
    not fit.  Same damping, self term and 1/(8πηa); not
    differentiable."""
    if h_floor is None:
        h_floor = rpy.WALL_H_FLOOR
    r = r.to(torch.float32).reshape(-1, 3)
    F = F.to(torch.float32).reshape(-1, 3)
    rows = slice(int(row_start), int(row_start) + int(row_len))
    radii = (None if radii is None else
             torch.as_tensor(radii, dtype=torch.float32, device=r.device))
    ahat = None if radii is None else radii * (1.0 / a)
    Fd = F
    if wall:
        b = rpy.damping_factors(r, a, radii)
        Fd = F * b[:, None]
    boa = None if box is None else (box[0] / a, box[1] / a)
    U = pair_sum_slab(r[rows] * (1.0 / a), row_start, r * (1.0 / a), Fd, wall,
                      h_floor=h_floor, box_over_a=boa,
                      ahat_rows=None if ahat is None else ahat[rows],
                      ahat_cols=ahat)
    U = U + rpy._self_diag(r[rows], a, wall, h_floor,
                           None if radii is None else radii[rows]) * Fd[rows]
    U = U * (1.0 / (8.0 * math.pi * eta * a))
    if wall:
        U = U * b[rows, None]
    return U


def mobility_apply_multi(Fs, r, a=1.0, eta=1.0, wall=False, damp=None,
                         h_floor=None, box=None, radii=None, image_shells=0,
                         image_tail=True):
    """(k, N, 3) forces → (k, N, 3) velocities U_k = M·F_k (B·M·B·F_k when
    damped; damping iff ``wall`` unless ``damp`` says otherwise), float32,
    sharing the pair fields across the RHS (k ≤ 2).  box: None or the
    pseudo-2D (Lx, Ly) box; image_shells / image_tail: its exact image
    sum.  radii: optional (N,) per-blob physical radii — the kernels take
    them as ahat = radii/a, the damping is min(z/aᵢ, 1) and the self term
    (4/3)·a/aᵢ plus the wall self term at the blob's own radius, as
    ``rpy_pallas.mobility_apply_multi`` (``rpy_pallas.py:856-888``).  A
    gradient at one RHS goes through :class:`MobilityApply`; at two RHS on
    the card it raises."""
    r = r.to(torch.float32).reshape(-1, 3)
    Fs = Fs.to(torch.float32)
    Fs = Fs.reshape(Fs.shape[0], -1, 3)
    if radii is not None:
        radii = torch.as_tensor(radii, dtype=torch.float32, device=r.device)
    kw = dict(a=a, eta=eta, wall=wall, damp=damp, h_floor=h_floor, box=box,
              image_shells=image_shells, image_tail=image_tail)
    if Fs.shape[0] == 1 and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (Fs, r, radii)):
        return MobilityApply.apply(Fs[0], r, radii, kw)[None]
    return _apply_multi(Fs, r, radii, **kw)


def _apply_multi(Fs, r, radii, a, eta, wall, damp, h_floor, box,
                 image_shells, image_tail):
    """The product of :func:`mobility_apply_multi` on float32 (k, N, 3)
    forces, (N, 3) positions and (N,) radii or None."""
    if h_floor is None:
        h_floor = rpy.WALL_H_FLOOR
    ahat = None if radii is None else radii * (1.0 / a)
    use_damp = wall if damp is None else damp
    Fd = Fs
    if use_damp:
        b = rpy.damping_factors(r, a, radii)
        Fd = Fs * b[None, :, None]
    box_over_a = None if box is None else tuple(x / a for x in box)
    U = pair_sum(r / a, Fd, wall, h_floor=h_floor, box_over_a=box_over_a,
                 ahat=ahat, image_shells=image_shells, image_tail=image_tail)
    U = U + rpy._self_diag(r, a, wall, h_floor, radii)[None] * Fd
    U = U * (1.0 / (8.0 * math.pi * eta * a))
    if use_damp:
        U = U * b[None, :, None]
    return U


class MobilityApply(torch.autograd.Function):
    """U = (B·)M(·B)·F at one RHS through the kernels, differentiable — the
    port of ``rpy_pallas._mobility_apply_diff`` (``rpy_pallas.py:779-818``).

    forward(F (N, 3), r (N, 3), radii (N,) or None, kw): the product of
    :func:`mobility_apply_multi` (K1 on the card, its plain version on the
    CPU), float32 inputs.  backward: F̄ = (B·M·B)ᵀ·Ū = B·M·B·Ū, one more
    launch of the same kernel (the damped operator is symmetric, and so are
    the image sums: their offsets come in ± pairs); r̄ = autograd of the
    plain :func:`.rpy.mobility_apply` at the same arguments (∂M/∂r has no
    kernel; the plain sweep recomputes each row tile, so its memory stays
    O(row_tile·N)); the radii a zero cotangent, as the JAX package's."""

    @staticmethod
    def forward(ctx, F, r, radii, kw):
        ctx.save_for_backward(F, r, radii)
        ctx.kw = kw
        return _apply_multi(F[None], r, radii, **kw)[0]

    @staticmethod
    def backward(ctx, U_bar):
        F, r, radii = ctx.saved_tensors
        kw = ctx.kw
        F_bar = r_bar = radii_bar = None
        if ctx.needs_input_grad[0]:
            with torch.no_grad():
                F_bar = _apply_multi(U_bar[None].contiguous(), r, radii,
                                     **kw)[0]
        if ctx.needs_input_grad[1]:
            h_floor = (rpy.WALL_H_FLOOR if kw["h_floor"] is None
                       else kw["h_floor"])
            with torch.enable_grad():
                rr = r.detach().requires_grad_()
                U = rpy.mobility_apply(
                    F.detach(), rr, a=kw["a"], eta=kw["eta"],
                    wall=kw["wall"], damp=kw["damp"], h_floor=h_floor,
                    box=kw["box"], image_shells=kw["image_shells"],
                    image_tail=kw["image_tail"], radii=radii)
                (r_bar,) = torch.autograd.grad(U, rr, U_bar)
        if ctx.needs_input_grad[2]:
            radii_bar = torch.zeros_like(radii)
        return F_bar, r_bar, radii_bar, None


def mobility_apply(F, r, a=1.0, eta=1.0, wall=False, damp=None, h_floor=None,
                   box=None, radii=None, image_shells=0, image_tail=True):
    """Drop-in for :func:`rigid_body_light_tpu_torch.ops.rpy.mobility_apply`
    (float32): U = M·F, or B·M·B·F when ``wall``; (N, 3) → (N, 3).
    Differentiable in F and r (:class:`MobilityApply`)."""
    r = r.to(torch.float32).reshape(-1, 3)
    if radii is not None:
        radii = torch.as_tensor(radii, dtype=torch.float32, device=r.device)
    kw = dict(a=a, eta=eta, wall=wall, damp=damp, h_floor=h_floor, box=box,
              image_shells=image_shells, image_tail=image_tail)
    return MobilityApply.apply(F.to(torch.float32).reshape(-1, 3), r, radii,
                               kw)
