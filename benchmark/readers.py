"""What the per-layer metrics' readers share: a span's milliseconds a step
from the port's StepTimer split, and a kernel's device time and roofline
share from the device trace.  A reader that finds nothing returns None,
and the harness leaves its metric out of the result line."""

from __future__ import annotations

import re

from benchmark import peaks

# the counted kernels' base names → the index of their NRHS template
# argument
NRHS_ARG = {"pair_sweep_sym_kernel": 1, "pair_sweep_sym_grouped_kernel": 1,
            "pair_sweep_ordered_kernel": 1, "ewald_tile_kernel": 0}


def ms_per_step(t, *parts, own=True):
    """Σ of the parts' milliseconds (their own, less nested spans, with
    ``own``) over the traced window's steps; None without any of them."""
    found = [t.split[p] for p in parts if p in t.split]
    if not found or not t.steps:
        return None
    key = "self_ms" if own else "ms"
    return sum(f[key] for f in found) / t.steps


def template_arg(name: str, index: int) -> int:
    """The ``index``-th template argument of a kernel's short name."""
    args = re.search(r"<(.*)>", name).group(1).split(",")
    return int(args[index].strip())


def base(name: str) -> str:
    """A kernel's short name without its template arguments or namespace."""
    return name.split("<")[0].split("::")[-1]


def nrhs(name: str) -> int:
    """The right-hand sides of a counted kernel's launch, by its name."""
    return template_arg(name, NRHS_ARG[base(name)])


def roofline_pct(t, kernels, helpers=(), work=None):
    """100 × the bound time over the device time of the kernels whose base
    names are in ``kernels`` (keys of :data:`NRHS_ARG`), their second
    passes ``helpers`` counted in the device time.  work(k) → the (flops,
    bytes) of one launch at k right-hand sides.
    None when no such kernel ran."""
    bound = dev = 0.0
    for name, sec in t.device.kernels.items():
        b = base(name)
        if b in kernels:
            k = nrhs(name)
            flops, n_bytes = work(k)
            bound += t.device.launches[name] * peaks.bound_s(flops, n_bytes)
            dev += sec
        elif b in helpers:
            dev += sec
    if bound == 0.0:
        return None
    return 100.0 * bound / dev
