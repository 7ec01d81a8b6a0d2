"""Wrapper of the hand-written CUDA near sweep K3 — the port of
``rigid_body_light_tpu/ops/rpy_pallas.py::near_sweep`` (the neighbor-tile
Pallas kernel ``_kernel_nbr``).

Kernel (``csrc/near_sweep.cu``, built for sm_90a at first use by
:mod:`.cuda_build`):

  K3 ``near_sweep``  the proxy-grid far field's exact near part: pairs of
                     cell-snake-sorted 128-blob tiles that are neighbors,
                     pairs of blobs kept iff their cells are adjacent
                     (offset ≤ 1 on every axis), both are real blobs and it
                     is not the self pair.  1 or 2 RHS.  Its box form
                     (the pseudo-2D film) wraps dx, dy to the minimum
                     image and the x/y cell offsets cyclically; its POLY
                     form (per-blob radii, open or in the box) takes the
                     polydisperse pair fields of K1's and K2's POLY forms.

The kernel sweeps each unordered tile pair once (the list
``tiles.tile_pairs`` builds with the neighbor lists), evaluating each
kept pair's fields once and applying them to both blobs; it replaced an
ordered design that swept every row tile against all of its neighbors and
so evaluated every pair twice (8.2× / 6.7× its bound at 1 / 2 RHS on the
102,480-blob slice, PERF.md §6).  Per-slot partial sums, one writer each,
are added in list order by a second pass: no atomics, launches repeat
bitwise.

:func:`near_sweep` takes the plain PyTorch version
(:func:`rigid_body_light_tpu_torch.ops.farfield._near_sweep`) for a tensor
on the CPU, and launches the kernel or raises for a CUDA tensor — there is
no fallback.  Like the Pallas wrapper, it computes in float32 and raises
for more than 2 RHS.  It has no backward: a CUDA tensor that requires grad
raises (:func:`.cuda_build.refuse_grad`).

Its row-tile slice (:func:`near_sweep`'s ``t0`` / ``nt``, as
``rpy_pallas.near_sweep``'s) gives the rows of tiles
[t0, t0 + nt) alone, for the distributed far field
(``farfield.mobility_apply`` with a ``group``): the same kernel and C
entry over the slice's work list (:func:`.tiles.slice_pairs`, the
pairs with a tile in the slice), writing only the slice's side of each
pair; the whole sweep is the slice (0, t).

``near_launches`` and ``near_poly_launches`` count launches of the
monodisperse and the POLY form, ``slice_launches`` and
``slice_poly_launches`` those of the slice (incremented where the kernel
is launched, nowhere else) so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from rigid_body_light_tpu_torch.ops import cuda_build
from rigid_body_light_tpu_torch.utils import profiling

TILE = 128  # blobs per tile; build() checks it against the kernel's
near_launches = 0
near_poly_launches = 0
slice_launches = 0
slice_poly_launches = 0

_lib = None


def reset_launch_counts():
    global near_launches, near_poly_launches
    global slice_launches, slice_poly_launches
    near_launches = near_poly_launches = 0
    slice_launches = slice_poly_launches = 0


def launch_counts():
    return {"near_sweep": near_launches, "near_sweep_poly": near_poly_launches,
            "near_sweep_slice": slice_launches,
            "near_sweep_slice_poly": slice_poly_launches}


def build():
    """Compile ``csrc/near_sweep.cu`` (if its build is not current) and load
    it.  Returns the ``ctypes`` library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load("near_sweep")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.near_sweep_tile.restype = i
    lib.near_sweep_tile.argtypes = []
    lib.near_sweep.restype = i
    lib.near_sweep.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                               f, f, f, i, i, p, p, p]
    if lib.near_sweep_tile() != TILE:
        raise RuntimeError(f"near_sweep.cu tiles {lib.near_sweep_tile()} "
                           f"blobs, the wrapper {TILE}")
    _lib = lib
    return lib


def near_sweep_kernel(x_s, ci_s, live_s, F_s, nbr, pairs, n_pairs,
                      wall: bool, h_floor: float, box_over_a=None,
                      wrap_cells=None, ahat_s=None, t0: int = None,
                      nt: int = None):
    """K3 on the card.  x_s (n_pad, 3) float32, ci_s (n_pad, 3) int32,
    live_s (n_pad,) bool, F_s (k, n_pad, 3) float32 with k ∈ {1, 2}, nbr
    (t, max_nbr) int32 with n_pad = t·128, pairs (cap, 4) int32 and n_pairs
    (1,) int32 (:func:`.tiles.tile_pairs`), all contiguous CUDA tensors
    → (k, n_pad, 3) pair terms in sorted order.  box_over_a / wrap_cells:
    None, or the film's (Lx, Ly) in units of a and (gx, gy), both given
    (the box form).  ahat_s: None, or the (n_pad,) float32 sorted radii in
    units of a (the POLY form; the kernel stages dead blobs at radius 1).
    t0 / nt: the row-tile slice (both or neither): the rows of tiles
    [t0, t0 + nt), (k, nt·128, 3), from the slice's work list
    (:func:`.tiles.slice_pairs`) in ``pairs`` / ``n_pairs``."""
    global near_launches, near_poly_launches
    global slice_launches, slice_poly_launches
    n_pad, k = x_s.shape[0], F_s.shape[0]
    t, max_nbr = nbr.shape
    cap = pairs.shape[0]
    sliced = t0 is not None
    if sliced != (nt is not None):
        raise ValueError("K3's slice takes t0 and nt together")
    if sliced and not (0 <= t0 and 0 <= nt and t0 + nt <= t):
        raise ValueError(f"K3's slice [{t0}, {t0} + {nt}) is not inside "
                         f"its {t} tiles")
    if k not in (1, 2):
        raise ValueError(f"near_sweep takes 1 or 2 RHS, got {k}")
    if n_pad != t * TILE:
        raise ValueError(f"{n_pad} sorted blobs for {t} tiles of {TILE}")
    cuda_build.check_tensor(x_s, "x_s", (n_pad, 3))
    cuda_build.check_tensor(ci_s, "ci_s", (n_pad, 3), torch.int32)
    cuda_build.check_tensor(live_s, "live_s", (n_pad,), torch.bool)
    cuda_build.check_tensor(F_s, "F_s", (k, n_pad, 3))
    cuda_build.check_tensor(nbr, "nbr", (t, max_nbr), torch.int32)
    cuda_build.check_tensor(pairs, "pairs", (cap, 4), torch.int32)
    cuda_build.check_tensor(n_pairs, "n_pairs", (1,), torch.int32)
    if ahat_s is not None:
        cuda_build.check_tensor(ahat_s, "ahat_s", (n_pad,))
    if (box_over_a is None) != (wrap_cells is None):
        raise ValueError("K3's box form takes box_over_a and wrap_cells "
                         "together")
    bx, by = (0.0, 0.0) if box_over_a is None else map(float, box_over_a)
    gx, gy = (0, 0) if wrap_cells is None else map(int, wrap_cells)
    if box_over_a is not None and min(bx, by, gx, gy) <= 0:
        raise ValueError(f"K3's box form needs a positive box and cell "
                         f"counts, got {box_over_a}, {wrap_cells}")
    lib = build()
    dev = x_s.device
    if not sliced:
        t0, nt = 0, t
    n_out = nt * TILE
    # per-slot partials; only the slots a tile uses are written and read
    part = torch.empty((max_nbr, k, n_out, 3), dtype=torch.float32,
                       device=dev)
    out = torch.empty((k, n_out, 3), dtype=torch.float32, device=dev)
    ahat_ptr = None if ahat_s is None else ahat_s.data_ptr()
    name = "near_sweep_slice" if sliced else "near_sweep"
    with torch.cuda.device(dev), profiling.span(name):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.near_sweep(
            x_s.data_ptr(), ci_s.data_ptr(), live_s.data_ptr(),
            F_s.data_ptr(), ahat_ptr, nbr.data_ptr(), pairs.data_ptr(),
            n_pairs.data_ptr(), n_pad, int(t0), int(nt), max_nbr, cap, k,
            int(bool(wall)), float(h_floor), bx, by, gx, gy,
            part.data_ptr(), out.data_ptr(), stream)
    cuda_build.raise_on_error(code, name)
    if sliced and ahat_s is None:
        slice_launches += 1
    elif sliced:
        slice_poly_launches += 1
    elif ahat_s is None:
        near_launches += 1
    else:
        near_poly_launches += 1
    return out


def near_sweep(x_s, ci_s, live_s, F_s, nbr, wall: bool, h_floor: float,
               pairs=None, box_over_a=None, wrap_cells=None, ahat_s=None,
               t0: int = None, nt: int = None):
    """Adjacent-cell pair sweep over the sorted tiles, float32: the contract
    of ``rpy_pallas.near_sweep`` (pair terms only, sorted order, no self
    term, scale or damping).

    x_s (n_pad, 3) sorted padded positions in units of a; ci_s (n_pad, 3)
    cell indices; live_s (n_pad,) real-blob mask; F_s (k, n_pad, 3) sorted
    forces, k ≤ 2; nbr (t, max_nbr) neighbor-tile ids (−1 = empty); pairs
    the (list, count) of :func:`.tiles.tile_pairs` for ``nbr``
    (``FarCtx.pairs``, ``FarCtx.n_pairs``), which the kernel needs and the
    plain version does not.  box_over_a / wrap_cells: the pseudo-2D film's
    (Lx, Ly) in units of a and (gx, gy) cyclic cell counts, as in
    ``rpy_pallas.near_sweep``, displacements wrapped by
    :func:`.rpy.wrapped_difference`'s rule.  ahat_s: None, or the (n_pad,)
    sorted radii in units of a: the POLY form (``ahat_s`` of
    ``rpy_pallas.near_sweep``; dead blobs at radius 1).  Returns (k, n_pad,
    3); rows of pad blobs hold garbage.  t0 / nt: the row-tile slice (both
    or neither; the distributed far field's), the rows of tiles [t0, t0 +
    nt) alone, (k, nt·128, 3); ``pairs`` is then the slice's work list
    (:func:`.tiles.slice_pairs`, ``FarCtx.pairs`` of
    ``farfield.prepare`` with a ``group``).
    """
    n_pad, k = x_s.shape[0], F_s.shape[0]
    if k > 2:
        raise ValueError(f"near_sweep supports at most 2 RHS, got k={k}")
    x32 = x_s.to(torch.float32).contiguous()
    F32 = F_s.to(torch.float32).contiguous()
    a32 = None
    if ahat_s is not None:
        a32 = torch.where(live_s, ahat_s.to(torch.float32), 1.0).contiguous()
    if x_s.device.type == "cpu":
        # the plain version lives with the far field, which imports this
        # module
        from rigid_body_light_tpu_torch.ops import farfield
        ids = torch.where(live_s, torch.arange(n_pad, dtype=torch.int32), -1)
        return farfield._near_sweep(x32, ci_s, ids, F32, nbr, wall, h_floor,
                                    box_n=box_over_a, wrap_xy=wrap_cells,
                                    ah_s=a32, t0=t0 or 0, nt=nt)
    if x_s.device.type == "cuda":
        cuda_build.refuse_grad(
            "K3 near_sweep" if t0 is None else "K3 near_sweep_slice", x_s,
            F_s, ahat_s)
        if pairs is None:
            raise ValueError("K3 needs the tile-pair list of farfield.prepare "
                             "(pairs=(ctx.pairs, ctx.n_pairs))")
        return near_sweep_kernel(
            x32, ci_s.to(torch.int32).contiguous(),
            live_s.to(torch.bool).contiguous(), F32,
            nbr.to(torch.int32).contiguous(), pairs[0].contiguous(),
            pairs[1].contiguous(), wall, h_floor, box_over_a, wrap_cells,
            a32, t0=t0, nt=nt)
    raise ValueError(f"no near sweep for device {x_s.device}")

