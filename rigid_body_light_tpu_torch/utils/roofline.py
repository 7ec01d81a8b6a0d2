"""FP32 peak probe — the port of ``measure_vpu_peak`` in the JAX package's
``scripts/tpu_kernel_roofline.py``.

Kernel (``csrc/fma_peak.cu``, built for sm_90a at first use by
:mod:`rigid_body_light_tpu_torch.ops.cuda_build`):

  P ``fma_peak``  out_i = Σ_j chain(x_i·c_j), chain = 64 steps of
                  v = v·1.000001 + c_j: a pure FMA chain in the pair
                  sweeps' tile/loop skeleton, 2·chain + 2 flop per (i, j).

:func:`fma_chain` takes the plain PyTorch recurrence for a tensor on the
CPU, and launches the kernel or raises for a CUDA tensor.  The kernel
fuses each step (one rounding); the plain version multiplies, then adds
(two roundings), so the two agree to float32 roundoff, not bitwise.

:func:`measure_fp32_peak` times the kernel with CUDA events and returns
(ms, TFLOP/s): the card's measured FP32 rate, to set beside the nominal
one that the kernels' bounds divide by.

``peak_launches`` counts kernel launches (incremented where the kernel is
launched, nowhere else).
"""

from __future__ import annotations

import ctypes

import torch

from rigid_body_light_tpu_torch.ops import cuda_build

CHAIN = 64            # steps per (i, j); build() checks it against the kernel's
# 1.000001 rounded to float32: the kernel's multiplier, so that a float64
# evaluation of the plain version follows the same recurrence
MUL = 1.00000095367431640625
peak_launches = 0

_lib = None


def reset_launch_counts():
    global peak_launches
    peak_launches = 0


def launch_counts():
    return {"fma_peak": peak_launches}


def build():
    """Compile ``csrc/fma_peak.cu`` (if its build is not current) and load
    it.  Returns the ``ctypes`` library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load("fma_peak")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.fma_peak_chain, lib.fma_peak_cols_per_chunk):
        fn.restype = i
        fn.argtypes = []
    lib.fma_peak.restype = i
    lib.fma_peak.argtypes = [p, p, i, p, p, p]
    if lib.fma_peak_chain() != CHAIN:
        raise RuntimeError(f"fma_peak.cu chains {lib.fma_peak_chain()} "
                           f"steps, the wrapper {CHAIN}")
    _lib = lib
    return lib


def fma_chain_plain(x, c, chain=CHAIN, col_tile=512):
    """The probe's function in plain float32 PyTorch, one (n, col_tile)
    block of (i, j) at a time: out_i = Σ_j v_ij after ``chain`` steps of
    v = v·1.000001 + c_j from v = x_i·c_j."""
    out = torch.zeros_like(x)
    for j0 in range(0, c.shape[0], col_tile):
        cj = c[None, j0:j0 + col_tile]
        v = x[:, None] * cj
        for _ in range(chain):
            v = v * MUL + cj
        out = out + v.sum(dim=1)
    return out


def fma_chain_kernel(x, c):
    """P on the card.  x, c: (n,) float32 contiguous CUDA tensors → (n,)."""
    global peak_launches
    n = x.shape[0]
    cuda_build.check_tensor(x, "x", (n,))
    cuda_build.check_tensor(c, "c", (n,))
    lib = build()
    dev = x.device
    part = torch.empty((-(-n // lib.fma_peak_cols_per_chunk()), n),
                       dtype=torch.float32, device=dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fma_peak(x.data_ptr(), c.data_ptr(), n, part.data_ptr(),
                            out.data_ptr(), stream)
    cuda_build.raise_on_error(code, "fma_peak")
    peak_launches += 1
    return out


def fma_chain(x, c, chain=CHAIN):
    """out_i = Σ_j chain(x_i·c_j), float32; x, c (n,).  CPU tensors take the
    plain recurrence, CUDA tensors the kernel (its chain length is fixed at
    ``CHAIN``)."""
    if x.device.type == "cpu":
        return fma_chain_plain(x.to(torch.float32), c.to(torch.float32),
                               chain)
    if x.device.type == "cuda":
        if chain != CHAIN:
            raise ValueError(f"the kernel chains {CHAIN} steps, got {chain}")
        return fma_chain_kernel(x, c)
    raise ValueError(f"no FMA probe for device {x.device}")


def measure_fp32_peak(n=10240, chain=CHAIN, device="cuda", reps=20):
    """Time the probe on ones, as the JAX probe does: (ms per launch,
    TFLOP/s at n²·(2·chain + 2) flop).  Needs a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the FP32 peak is a property of the card: "
                         f"measure_fp32_peak needs a CUDA device, got {device}")
    x = torch.ones((n,), dtype=torch.float32, device=device)
    fma_chain(x, x, chain)          # build and warm up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fma_chain(x, x, chain)
    end.record()
    torch.cuda.synchronize(device)
    ms = start.elapsed_time(end) / reps
    return ms, n * n * (2 * chain + 2) / (ms * 1e-3) / 1e12
