"""Wrappers of the hand-written CUDA pair sweeps — the port of
``rigid_body_light_tpu/ops/rpy_pallas.py`` (its ``pair_sum``,
``mobility_apply`` and ``mobility_apply_multi`` contract).

Kernels (``csrc/rpy_pair_sweep.cu``, built for sm_90a at first use):

  K1 ``pair_sweep_sym``      replaces ``rpy_pallas._kernel_sym``: symmetric
                             unordered-pair sweep, single RHS.
  K2 ``pair_sweep_ordered``  replaces ``rpy_pallas._kernel``: ordered slab
                             with global row/column offsets, 1 or 2 RHS.

Dispatch in :func:`pair_sum`: k=1 → K1, k=2 → K2, always; anything else
(k > 2, a box, per-blob radii, image shells) raises NotImplementedError
naming the ROADMAP item.  A tensor on the CPU takes the plain PyTorch
version (:mod:`rigid_body_light_tpu_torch.ops.rpy`); a CUDA tensor launches
the kernel or raises — there is no fallback.  Like the Pallas wrapper,
inputs are cast to float32.

The kernels compute pair terms only; the wrappers here apply the self
term, the 1/(8πηa) scale and the B·M·B damping.  Not differentiable yet:
the ``custom_vjp`` of ``rpy_pallas.mobility_apply`` is ported with the
adjoint slice (ROADMAP.md queue 1, item 15).

``sym_launches`` / ``ordered_launches`` count kernel launches (incremented
where each kernel is launched, nowhere else) so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time

import torch

from rigid_body_light_tpu_torch.ops import rpy

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "rpy_pair_sweep.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

sym_launches = 0
ordered_launches = 0

_lib = None
build_info = {}


def reset_launch_counts():
    global sym_launches, ordered_launches
    sym_launches = 0
    ordered_launches = 0


def launch_counts():
    return {"pair_sweep_sym": sym_launches,
            "pair_sweep_ordered": ordered_launches}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA pair "
                           "sweeps are built from csrc/ at first use")
    return path


def build():
    """Compile ``csrc/rpy_pair_sweep.cu`` (if its build is not current) and
    load it.  The library is named by a hash of the source and flags, and
    written atomically, so concurrent first uses cannot load half a file.
    Returns the ``ctypes`` library."""
    global _lib
    if _lib is not None:
        return _lib
    with open(SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so_path = os.path.join(BUILD_DIR, f"librpy_pair_sweep_{digest[:16]}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so_path)
        build_info["seconds"] = time.perf_counter() - t0
        build_info["log"] = proc.stdout + proc.stderr
    lib = ctypes.CDLL(so_path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rpy_sym_rows_per_tile.restype = i
    lib.rpy_sym_rows_per_tile.argtypes = []
    lib.rpy_sym_cols_per_chunk.restype = i
    lib.rpy_sym_cols_per_chunk.argtypes = []
    lib.rpy_pair_sweep_sym.restype = i
    lib.rpy_pair_sweep_sym.argtypes = [p, p, i, i, f, p, p, p, p]
    lib.rpy_pair_sweep_ordered.restype = i
    lib.rpy_pair_sweep_ordered.argtypes = [p, i, i, p, p, i, i, i, i, f, p, p]
    build_info["path"] = so_path
    _lib = lib
    return lib


def _check(t, name, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _raise_on_error(code, kernel):
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code}")


def pair_sweep_sym(r_over_a, F, wall: bool, h_floor: float):
    """K1: Σ_{j≠i} M_ij F_j over unordered pairs, on the card.
    r_over_a, F: (n, 3) float32 CUDA tensors → (n, 3)."""
    global sym_launches
    n = r_over_a.shape[0]
    _check(r_over_a, "r_over_a", (n, 3))
    _check(F, "F", (n, 3))
    lib = build()
    rows = lib.rpy_sym_rows_per_tile()
    chunk = lib.rpy_sym_cols_per_chunk()
    dev = r_over_a.device
    row_part = torch.empty((-(-n // chunk), 3, n), dtype=torch.float32,
                           device=dev)
    col_part = torch.empty((-(-n // rows), 3, n), dtype=torch.float32,
                           device=dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rpy_pair_sweep_sym(
            r_over_a.data_ptr(), F.data_ptr(), n, int(bool(wall)),
            float(h_floor), row_part.data_ptr(), col_part.data_ptr(),
            out.data_ptr(), stream)
    _raise_on_error(code, "pair_sweep_sym")
    sym_launches += 1
    return out


def pair_sweep_ordered(r_rows_over_a, row_offset: int, r_cols_over_a, F_cols,
                       col_offset: int, wall: bool, h_floor: float):
    """K2: Σ_j M_ij F_j over all columns whose global id differs from the
    row's, on the card.  r_rows (R, 3), r_cols (N, 3), F_cols (k, N, 3)
    float32 CUDA tensors, k ∈ {1, 2} → (k, R, 3)."""
    global ordered_launches
    n_rows = r_rows_over_a.shape[0]
    k, n_cols = F_cols.shape[0], r_cols_over_a.shape[0]
    if k not in (1, 2):
        raise ValueError(f"pair_sweep_ordered takes 1 or 2 RHS, got {k}")
    _check(r_rows_over_a, "r_rows_over_a", (n_rows, 3))
    _check(r_cols_over_a, "r_cols_over_a", (n_cols, 3))
    _check(F_cols, "F_cols", (k, n_cols, 3))
    lib = build()
    dev = r_rows_over_a.device
    out = torch.empty((k, n_rows, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rpy_pair_sweep_ordered(
            r_rows_over_a.data_ptr(), n_rows, int(row_offset),
            r_cols_over_a.data_ptr(), F_cols.data_ptr(), n_cols,
            int(col_offset), k, int(bool(wall)), float(h_floor),
            out.data_ptr(), stream)
    _raise_on_error(code, "pair_sweep_ordered")
    ordered_launches += 1
    return out


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not in the CUDA pair sweeps yet (ROADMAP.md queue 1, "
        f"{item})")


def pair_sum(r_over_a, F, wall: bool, h_floor: float = None, box_over_a=None,
             ahat=None, image_shells=0):
    """Σ_{j≠i} M_ij F_j (unscaled, undamped pair terms).

    r_over_a: (N, 3) positions in units of the blob radius; F: (N, 3) single
    RHS or (k, N, 3), k ≤ 2.  CPU tensors take the plain sweep, CUDA
    tensors K1 (k=1) or K2 (k=2).
    """
    if box_over_a is not None or image_shells:
        raise _not_ported("a periodic box / image shells",
                          "item 12 (pseudo-2D)")
    if ahat is not None:
        raise _not_ported("per-blob radii", "item 12 (polydisperse)")
    if h_floor is None:
        h_floor = rpy.WALL_H_FLOOR
    multi = F.dim() == 3
    Fk = F if multi else F[None]
    k = Fk.shape[0]
    if k > 2:
        raise _not_ported(f"a {k}-RHS sweep", "item 3 (K1/K2 take k ≤ 2, "
                          "as the Pallas kernels do)")
    r_over_a = r_over_a.to(torch.float32).contiguous()
    Fk = Fk.to(torch.float32).contiguous()
    n = r_over_a.shape[0]
    if r_over_a.device.type == "cpu":
        ids = torch.arange(n)
        U = rpy.pair_sum(r_over_a, ids, r_over_a, ids, Fk, a=1.0, wall=wall,
                         h_floor=h_floor)
    elif r_over_a.device.type == "cuda":
        if k == 1:
            U = pair_sweep_sym(r_over_a, Fk[0], wall, h_floor)[None]
        else:
            U = pair_sweep_ordered(r_over_a, 0, r_over_a, Fk, 0, wall,
                                   h_floor)
    else:
        raise ValueError(f"no pair sweep for device {r_over_a.device}")
    return U if multi else U[0]


def mobility_apply_multi(Fs, r, a=1.0, eta=1.0, wall=False, damp=None,
                         h_floor=None, box=None, radii=None, image_shells=0):
    """(k, N, 3) forces → (k, N, 3) velocities U_k = M·F_k (B·M·B·F_k when
    damped; damping iff ``wall`` unless ``damp`` says otherwise), float32,
    sharing the pair fields across the RHS (k ≤ 2)."""
    if h_floor is None:
        h_floor = rpy.WALL_H_FLOOR
    r = r.to(torch.float32).reshape(-1, 3)
    Fs = Fs.to(torch.float32)
    Fs = Fs.reshape(Fs.shape[0], -1, 3)
    use_damp = wall if damp is None else damp
    Fd = Fs
    if use_damp:
        b = rpy.damping_factors(r, a)
        Fd = Fs * b[None, :, None]
    box_over_a = None if box is None else tuple(x / a for x in box)
    U = pair_sum(r / a, Fd, wall, h_floor=h_floor, box_over_a=box_over_a,
                 ahat=radii, image_shells=image_shells)
    U = U + rpy._self_diag(r, a, wall, h_floor)[None] * Fd
    U = U * (1.0 / (8.0 * math.pi * eta * a))
    if use_damp:
        U = U * b[None, :, None]
    return U


def mobility_apply(F, r, a=1.0, eta=1.0, wall=False, damp=None, h_floor=None,
                   box=None, radii=None, image_shells=0):
    """Drop-in for :func:`rigid_body_light_tpu_torch.ops.rpy.mobility_apply`
    (float32): U = M·F, or B·M·B·F when ``wall``; (N, 3) → (N, 3)."""
    return mobility_apply_multi(F.reshape(1, -1, 3), r, a, eta, wall, damp,
                                h_floor, box, radii, image_shells)[0]
