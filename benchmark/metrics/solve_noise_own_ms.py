"""Own ms a step of the GMRES loop and the Lanczos noise (the port's spans
``gmres`` and ``noise``, less the spans nested in them)."""
from benchmark.readers import ms_per_step


def read(t):
    return ms_per_step(t, "gmres", "noise")
