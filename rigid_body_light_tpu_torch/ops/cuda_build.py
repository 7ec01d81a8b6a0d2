"""Build the port's CUDA sources (``csrc/*.cu``) for sm_90a at first use.

Each source becomes its own shared library with a plain C interface,
loaded with ``ctypes``; :func:`build` starts one ``nvcc`` per library that
is not built yet, all at once, and waits for all of them.  A library is
named by a hash of its source, the shared headers and the flags, and is
written atomically, so concurrent first uses cannot load half a file.
The build directory (``rigid_body_light_tpu_torch/build/``) is gitignored.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library name → source under csrc/
SOURCES = {"rpy_pair_sweep": "rpy_pair_sweep.cu",
           "near_sweep": "near_sweep.cu",
           "ewald_real_sweep": "ewald_real_sweep.cu",
           "fma_peak": "fma_peak.cu"}
HEADERS = ("rpy_fields.cuh", "tile_items.cuh")


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from csrc/ at first use")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names=tuple(SOURCES)) -> dict:
    """Compile the named libraries that are not built yet, one ``nvcc`` each,
    all started together.  Returns {name: (path, nvcc log)}, the log empty
    for a library that was already built; raises if any build fails."""
    out = {name: (library_path(name), "") for name in names}
    todo = [name for name, (p, _) in out.items() if not os.path.exists(p)]
    if not todo:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = f"{out[name][0]}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}: nvcc failed ({proc.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, out[name][0])
        out[name] = (out[name][0], log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one library."""
    return ctypes.CDLL(build((name,))[name][0])


def check_tensor(t, name, shape, dtype=torch.float32):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` — what every kernel wrapper checks before a launch."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def refuse_grad(kernel, *tensors):
    """Raise where a kernel without a backward would be differentiated: its
    output comes from ``torch.empty`` through ``ctypes`` and carries no
    ``grad_fn``, so a gradient through it would silently miss its pair
    terms.  The plain PyTorch version (a tensor on the CPU, float64, or
    ``use_pallas=False``) differentiates."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: a gradient through it on the card "
            f"would miss its pair terms.  Only K1 at one RHS "
            f"(rpy_cuda.mobility_apply) is differentiable (ROADMAP.md queue "
            f"1, item 15); take the plain PyTorch version for this "
            f"gradient (float64 or use_pallas=False)")


def raise_on_error(code, kernel):
    """A launch's ``cudaGetLastError()`` code, 0 or an exception."""
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code}")
